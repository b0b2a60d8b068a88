"""Training of the catalog's attention decoders (dense, local attention,
MoE, M-RoPE) and of whisper-tiny (encoder-decoder, with frame embeddings)
at `tiny_config` size: loss and gradients against the reference's
`jax.value_and_grad(model.loss_fn)`, and one train step of the port that
stays finite and moves a parameter (`tests/_torch_train_cases.py` has the
tolerances)."""
import pytest

pytest.importorskip("torch")

from _torch_train_cases import (check_loss_and_grads,  # noqa: E402
                                check_train_step)

ARCHS = ["gpt2-large", "command-r-35b", "olmo-1b", "starcoder2-15b",
         "gemma3-4b", "mixtral-8x22b", "llama4-scout-17b-a16e",
         "qwen2-vl-2b", "whisper-tiny"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_updates_and_finite(arch):
    check_train_step(arch)
