"""Shared cases of the port's training tests: one catalog model at
`tests/conftest.py` `tiny_config` size, its loss and gradients against
`jax.value_and_grad(model.loss_fn)` (jitted) on the same weights and batch.

Gradients come from two autodiff systems whose reductions and fusions
differ in the last bits, so each leaf is held to
``max|g_port - g_ref| <= GRAD_RTOL * max|g_ref| + GRAD_ATOL`` (the worst
leaf of the 13 models measured at 0.36 of it: jamba's A_log) and the loss
to ``LOSS_RTOL``. A leaf whose true gradient is zero (a key bias, whose
shift of a softmax row cancels; a top-1 router after the renormalization
of its one gate) holds last-bit noise on both sides, which the absolute
term covers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config
from repro.models import Model as RModel
from repro_torch import tree
from repro_torch.ckpt import params_from_numpy
from repro_torch.models import Model as TModel
from repro_torch.train import optim, trainer

from _torch_helpers import port_model_config, port_params, to_numpy
from conftest import tiny_config

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
LOSS_RTOL = 1e-6


def batch_of(cfg, seed=1, B=2, S=16, loss_mask=False):
    """A numpy batch: tokens, ``enc_feats`` for an encoder-decoder and, if
    asked, a loss mask that drops about a third of the positions."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                    ).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["enc_feats"] = rng.normal(
            size=(B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    if loss_mask:
        batch["loss_mask"] = (rng.random((B, S)) > 0.33).astype(np.int32)
    return batch


def assert_grads_close(port_grads, ref_grads, pcfg):
    """Leaf by leaf, the reference's (scan-stacked) gradient tree carried
    into the port's layout."""
    ref = params_from_numpy(to_numpy(ref_grads), pcfg, device="cpu")
    got = tree.leaves_with_paths(port_grads)
    want = tree.leaves_with_paths(ref)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        a, b = a.numpy(), b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, path
        err = float(np.abs(a - b).max()) if a.size else 0.0
        tol = GRAD_RTOL * float(np.abs(b).max(initial=0.0)) + GRAD_ATOL
        assert err <= tol, (path, err, tol)


def check_loss_and_grads(arch, loss_mask=False):
    cfg = tiny_config(get_config(arch))
    rm = RModel(cfg)
    params = rm.init(jax.random.PRNGKey(0))
    batch = batch_of(cfg, loss_mask=loss_mask)
    rl, rg = jax.jit(jax.value_and_grad(rm.loss_fn))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    pcfg = port_model_config(cfg)
    tl, tg = trainer.value_and_grad(TModel(pcfg, device="cpu"),
                                    port_params(params, cfg), batch)
    np.testing.assert_allclose(float(tl), float(rl), rtol=LOSS_RTOL)
    assert_grads_close(tg, rg, pcfg)


def check_train_step(arch):
    """One port train step: finite loss, at least one parameter moved."""
    pcfg = port_model_config(tiny_config(get_config(arch)))
    model = TModel(pcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    step = trainer.make_train_step(model, optim.AdamWConfig(lr=1e-3))
    new, opt_state, m = step(params, optim.adamw_init(params),
                             batch_of(pcfg))
    assert bool(torch.isfinite(m["loss"])) and int(opt_state["step"]) == 1
    assert all(bool(torch.isfinite(p).all()) for p in tree.leaves(new))
    assert any(not torch.equal(a, b) for a, b in
               zip(tree.leaves(params), tree.leaves(new)))
