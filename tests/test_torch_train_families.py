"""Training of the catalog's SSM, hybrid and encoder-only models at
`tiny_config` size (mamba2-130m, jamba, bert-base, bert-large): loss and
gradients against
the reference's `jax.value_and_grad(model.loss_fn)`, and one train step of
the port (`tests/_torch_train_cases.py` has the tolerances). Together with
`test_torch_train_models.py` every model of `PORTED`."""
import pytest

pytest.importorskip("torch")

from repro_torch.configs.catalog import PORTED  # noqa: E402

from _torch_train_cases import (check_loss_and_grads,  # noqa: E402
                                check_train_step)
from test_torch_train_models import ARCHS as DECODERS  # noqa: E402

ARCHS = ["mamba2-130m", "jamba-v0.1-52b", "bert-base", "bert-large"]


def test_the_two_files_cover_the_catalog():
    assert sorted(ARCHS + DECODERS) == sorted(PORTED)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_updates_and_finite(arch):
    check_train_step(arch)
