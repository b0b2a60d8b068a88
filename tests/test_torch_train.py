"""The port's training step (`repro_torch.train.trainer`) and the training
half of `Model`:

* ``loss_fn`` with a ``loss_mask``, against the reference's gradients
  (`tests/_torch_train_cases.py` tolerances), and `make_eval_step`;
* activation checkpointing: remat ``none``, ``full`` and ``dots`` give
  bit-equal losses and gradients; ``dots`` saves the weight products and
  recomputes the rest; nothing is wrapped under ``torch.no_grad()``;
* ``microbatches=2`` against 1 (loss within 1e-5, parameters within 1e-4,
  as `tests/test_system.py` holds the reference);
* a 5-step loss trajectory against the reference's jitted step (1e-3: at
  step 1 Adam turns a near-zero gradient of either sign into +-lr, so
  parameters do not hold leaf by leaf, losses do);
* `tests/test_system.py`'s learn-then-serve check on the CPU: 120 steps
  of tiny gpt2-large learn, and the raceit forward agrees with digital on
  more than 0.7 of the argmaxes.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.data import SyntheticLM as RSyn  # noqa: E402
from repro.models import Model as RModel  # noqa: E402
from repro.train import optim as RO, trainer as RT  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs.base import ExecConfig  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import Model, blocks  # noqa: E402
from repro_torch.train import optim, trainer  # noqa: E402

from _torch_helpers import port_model_config, port_params  # noqa: E402
from _torch_train_cases import batch_of, check_loss_and_grads  # noqa: E402
from conftest import tiny_config  # noqa: E402


def _tiny(arch, **kw):
    return port_model_config(tiny_config(get_config(arch))).replace(**kw)


def _model(cfg, seed=0):
    m = Model(cfg, device="cpu")
    return m, m.init(torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("arch", ["gpt2-large", "bert-base"])
def test_loss_mask_against_reference(arch):
    check_loss_and_grads(arch, loss_mask=True)


def test_eval_step_is_the_loss_without_a_graph():
    m, p = _model(_tiny("olmo-1b"))
    batch = batch_of(m.cfg)
    loss = trainer.make_eval_step(m)(p, batch)
    assert not loss.requires_grad
    assert torch.equal(loss, trainer.value_and_grad(m, p, batch)[0])
    masked = dict(batch, loss_mask=np.zeros_like(batch["tokens"]))
    assert float(trainer.make_eval_step(m)(p, masked)) == 0.0


@pytest.mark.parametrize("arch", ["gpt2-large", "mixtral-8x22b",
                                  "mamba2-130m"])
def test_remat_changes_no_number(arch):
    got = {}
    for remat in ("none", "full", "dots"):
        m, p = _model(_tiny(arch, remat=remat))
        loss, grads = trainer.value_and_grad(m, p, batch_of(m.cfg))
        got[remat] = [loss] + tree.leaves(grads)
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b)
                   for a, b in zip(got[remat], got["none"])), remat


def test_dots_saves_the_weight_products(monkeypatch):
    seen = collections.Counter()
    policy = blocks._save_weight_products

    def spy(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        seen[(op, out)] += 1
        return out
    monkeypatch.setattr(blocks, "_save_weight_products", spy)
    m, p = _model(_tiny("gpt2-large", remat="dots"))
    trainer.value_and_grad(m, p, batch_of(m.cfg))
    save = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    aten = torch.ops.aten
    # per layer: q, k, v, fc1, fc2 (mm) and the output projection (an
    # einsum's bmm of batch 1)
    L = m.cfg.n_layers
    assert seen[(aten.mm.default, save)] == 5 * L
    assert seen[(aten.bmm.default, save)] == L
    assert sum(n for (op, pol), n in seen.items() if pol != save) > 0


def test_no_checkpoint_without_grad(monkeypatch):
    def refuse(fn, cfg):
        raise AssertionError("remat wrapper used without autograd")
    monkeypatch.setattr(blocks, "_remat_wrap", refuse)
    m, p = _model(_tiny("gpt2-large"))
    with torch.no_grad():
        m.forward(p, batch_of(m.cfg))
        m.loss_fn(p, batch_of(m.cfg))
    m.forward(p, batch_of(m.cfg), use_remat=False)


def test_microbatched_train_step_matches():
    m, p = _model(_tiny("olmo-1b"))
    batch = {"tokens": np.random.default_rng(0).integers(
        0, m.cfg.vocab_size, (4, 16)).astype(np.int32)}
    cfg = optim.AdamWConfig(lr=1e-3)
    p1, s1, m1 = trainer.make_train_step(m, cfg)(p, optim.adamw_init(p),
                                                 batch)
    p2, s2, m2 = trainer.make_train_step(m, cfg, microbatches=2)(
        p, optim.adamw_init(p), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree.leaves(p1), tree.leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_five_step_losses_match_reference_jitted_step():
    cfg = tiny_config(get_config("olmo-1b"))
    rm = RModel(cfg)
    rp = rm.init(jax.random.PRNGKey(0))
    rstep = jax.jit(RT.make_train_step(rm, RO.AdamWConfig(
        lr=1e-3, schedule=RO.warmup_cosine(2, 5))))
    tstep = trainer.make_train_step(
        Model(port_model_config(cfg), device="cpu"),
        optim.AdamWConfig(lr=1e-3, schedule=optim.warmup_cosine(2, 5)))
    tp = port_params(rp, cfg)
    rs, ts = RO.adamw_init(rp), optim.adamw_init(tp)
    rdata = RSyn(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                 seed=3)
    tdata = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16,
                        global_batch=4, seed=3)
    for _ in range(5):
        rb = {k: jnp.asarray(v) for k, v in rdata.next_batch().items()}
        rp, rs, rmet = rstep(rp, rs, rb)
        tp, ts, tmet = tstep(tp, ts, tdata.next_batch())
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(rmet[k]),
                                       rtol=1e-3)


def test_end_to_end_learns_and_serves_raceit():
    cfg = _tiny("gpt2-large", n_layers=2, d_model=128, n_heads=4,
                n_kv_heads=4, vocab_size=128)
    data = SyntheticLM(vocab_size=128, seq_len=32, global_batch=8, seed=5)
    model, params = _model(cfg)
    step = trainer.make_train_step(model, optim.AdamWConfig(
        lr=1e-3, schedule=optim.warmup_cosine(10, 120)))
    opt_state = optim.adamw_init(params)
    losses = []
    for _ in range(120):
        params, opt_state, m = step(params, opt_state, data.next_batch())
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])

    ev = SyntheticLM(vocab_size=128, seq_len=32, global_batch=8, seed=77)
    b = ev.next_batch()
    with torch.no_grad():
        ld = Model(cfg, ExecConfig(), device="cpu").forward(params, b)
        lr = Model(cfg, ExecConfig(mode="raceit"), device="cpu").forward(
            params, b)
    agree = float((ld.argmax(-1) == lr.argmax(-1)).float().mean())
    assert agree > 0.7, agree


def test_fully_masked_rows_have_finite_zero_gradients():
    """`_chunked_attention` masks with a finite NEG_INF, so a query row with
    no valid key (every key a left pad) outputs zeros and its gradients are
    zeros, not NaN, through the branch `torch.where` does not take."""
    from repro_torch.models import layers
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 5, 4, 8, generator=g, requires_grad=True)
               for _ in range(3))
    pad = torch.tensor([0, 5], dtype=torch.int32)  # row 1: every key a pad
    out = layers._chunked_attention(q, k, v, lambda qi, ki: ki <= qi, 2,
                                    0.35, torch.float32, pad_lens=pad)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    out.square().sum().backward()
    for t in (q, k, v):
        assert bool(torch.isfinite(t.grad).all())
        assert torch.equal(t.grad[1], torch.zeros_like(t.grad[1]))
