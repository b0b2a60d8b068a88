"""Weights across: a reference checkpoint read by the port without JAX.

`repro.ckpt.CheckpointManager.save` writes tiny model parameters;
`repro_torch.ckpt.load_reference_checkpoint` must give the same tensors as
`params_from_numpy` of the same tree in memory, and the same resident codes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.ckpt import CheckpointManager  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import Model  # noqa: E402
from repro_torch.ckpt import (load_reference_checkpoint,  # noqa: E402
                              params_from_numpy)
from repro_torch.models.layers import QuantizedWeight  # noqa: E402
from repro_torch.models.model import quantize_model_params  # noqa: E402

from _torch_helpers import port_model_config, to_numpy  # noqa: E402
from conftest import tiny_config  # noqa: E402


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif isinstance(tree, QuantizedWeight):
        yield f"{path}/codes", tree.codes
        yield f"{path}/scale", tree.scale
    else:
        yield path, tree


def _assert_same(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert torch.equal(la[k], lb[k]), k


@pytest.mark.parametrize("name, dtype, wrap", [
    ("gpt2-large", "float32", False),
    ("command-r-35b", "float32", True),   # saved as (params, opt_state)
    ("gpt2-large", "bfloat16", False),   # bf16 leaves stored as uint16 views
])
def test_checkpoint_round_trip(tmp_path, name, dtype, wrap):
    cfg = tiny_config(get_config(name)).replace(param_dtype=dtype)
    params = Model(cfg).init(jax.random.PRNGKey(3))
    CheckpointManager(str(tmp_path)).save(
        7, (params, None) if wrap else params)
    pcfg = port_model_config(cfg)
    loaded = load_reference_checkpoint(tmp_path, pcfg, device="cpu")
    in_memory = params_from_numpy(to_numpy(params), pcfg, device="cpu")
    _assert_same(loaded, in_memory)
    assert len(loaded["blocks"]) == cfg.n_layers
    first = np.asarray(params["blocks"]["scan"][0]["attn"]["wq"][0]
                       .astype(np.float32))
    np.testing.assert_array_equal(
        loaded["blocks"][0]["attn"]["wq"].float().numpy(), first)
    _assert_same(quantize_model_params(loaded),
                 quantize_model_params(in_memory))
