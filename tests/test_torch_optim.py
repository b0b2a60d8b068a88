"""The port's AdamW (`repro_torch.train.optim`) against the reference's
jitted functions on the same random trees.

Fed the same gradients, moments, parameters and step, an update holds to
`RTOL` = 1e-6 (a few ulp: XLA's pow and fused multiply-adds may differ
from torch's in the last bit) plus `ATOL` = 1e-7 of the leaf's largest
entry (where the decay term cancels the Adam step, a last-bit difference
is a large part of a small entry). The global norm and the clip hold to
1e-6 (a float32 sum in another order); `warmup_cosine` to 4 ulp (XLA's
cos; the divisions by constants are the jitted graph's reciprocal
multiplies, bit for bit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_helpers  # noqa: E402,F401  (one torch thread a worker)

from repro.train import optim as R  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.train import optim as T  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7


def _trees(seed, scale=1.0):
    """(reference tree of jnp arrays, port tree of tensors) with 1-d, 2-d
    and 3-d leaves in nested dicts and lists."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": {"tok": (12, 8)}, "norm": {"scale": (8,)},
              "blocks": [{"w": (8, 2, 4), "b": (4,)}, {"w": (8, 8)}]}

    def draw(shape):
        return (scale * rng.normal(size=shape)).astype(np.float32)
    arrs = jax.tree.map(draw, shapes, is_leaf=lambda s: isinstance(s, tuple))
    return (jax.tree.map(jnp.asarray, arrs),
            tree.map(lambda a: torch.from_numpy(a.copy()), arrs))


def _close(port, ref, rtol=RTOL, atol=ATOL):
    """Leaf by leaf: |port - ref| <= rtol |ref| + atol max|ref|."""
    ref_leaves = [np.asarray(x) for x in jax.tree.leaves(ref)]
    port_leaves = [x.numpy() for x in tree.leaves(port)]
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=atol * np.abs(b).max())


def test_tree_order_is_jax_order():
    r, t = _trees(0)
    assert ([tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
             for p, _ in jax.tree_util.tree_flatten_with_path(r)[0]]
            == [tuple(str(k) for k in p) for p, _ in
                tree.leaves_with_paths(t)])


@pytest.mark.parametrize("scale", [1e-3, 1.0, 50.0])
def test_global_norm_and_clip(scale):
    r, t = _trees(1, scale)
    np.testing.assert_allclose(float(T.global_norm(t)),
                               float(jax.jit(R.global_norm)(r)), rtol=1e-6)
    rc, rn = jax.jit(R.clip_by_global_norm, static_argnums=1)(r, 1.0)
    tc, tn = T.clip_by_global_norm(t, 1.0)
    np.testing.assert_allclose(float(tn), float(rn), rtol=1e-6)
    _close(tc, rc, rtol=1e-6)


@pytest.mark.parametrize("warmup,total", [(20, 100), (0, 10), (5, 5),
                                          (20, 6)])
def test_warmup_cosine(warmup, total):
    steps = np.arange(0, total + 30, dtype=np.int32)
    ref = np.asarray(jax.jit(jax.vmap(R.warmup_cosine(warmup, total)))(
        jnp.asarray(steps)))
    got = T.warmup_cosine(warmup, total)(torch.from_numpy(steps)).numpy()
    np.testing.assert_array_max_ulp(got, ref, maxulp=4)


def _cfgs():
    return [
        dict(lr=1e-3),
        dict(lr=3e-4, grad_clip=0.0),
        dict(lr=1e-2, weight_decay=0.0, b2=0.999),
        dict(lr=3e-4, schedule=(R.warmup_cosine(3, 10),
                                T.warmup_cosine(3, 10))),
    ]


@pytest.mark.parametrize("kw", _cfgs(), ids=["default", "no-clip",
                                             "no-decay", "schedule"])
def test_adamw_update_fed_the_same_state(kw):
    kw = dict(kw)
    sched = kw.pop("schedule", (None, None))
    rcfg = R.AdamWConfig(schedule=sched[0], **kw)
    tcfg = T.AdamWConfig(schedule=sched[1], **kw)
    rp, tp = _trees(2)
    rstate, tstate = R.adamw_init(rp), T.adamw_init(tp)
    assert int(tstate["step"]) == 0 and tstate["step"].dtype == torch.int32
    upd = jax.jit(lambda g, s, p: R.adamw_update(g, s, p, rcfg))
    for k in range(4):
        rg, tg = _trees(10 + k, scale=3.0)
        ru, rstate_new, rm = upd(rg, rstate, rp)
        tu, tstate_new, tm = T.adamw_update(tg, tstate, tp, tcfg)
        _close(tu, ru)
        _close(tstate_new["mu"], rstate_new["mu"])
        _close(tstate_new["nu"], rstate_new["nu"])
        assert int(tstate_new["step"]) == int(rstate_new["step"]) == k + 1
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]),
                                   rtol=1e-7)
        rp2 = R.apply_updates(rp, ru)
        tp2 = T.apply_updates(tp, tu)
        _close(tp2, rp2)
        # next step from the reference's own state, so errors do not grow
        rp, rstate = rp2, rstate_new
        tp = _port(rp)
        tstate = {"mu": _port(rstate["mu"]), "nu": _port(rstate["nu"]),
                  "step": torch.tensor(int(rstate["step"]),
                                       dtype=torch.int32)}


def _port(r):
    leaves = [torch.from_numpy(np.array(x)) for x in jax.tree.leaves(r)]
    # the reference's tree in the port's containers (dicts and lists)
    return tree.unflatten(_trees(0)[1], leaves)


def test_decay_only_on_matrices():
    """Zero gradients: only leaves with two or more dimensions move."""
    _, tp = _trees(3)
    zeros = tree.map(torch.zeros_like, tp)
    upd, _, _ = T.adamw_update(zeros, T.adamw_init(tp), tp,
                               T.AdamWConfig(lr=0.1, weight_decay=0.5))
    for p, u in zip(tree.leaves(tp), tree.leaves(upd)):
        if p.ndim >= 2:
            torch.testing.assert_close(u, -0.1 * 0.5 * p, rtol=1e-6,
                                       atol=0)
        else:
            assert torch.equal(u, torch.zeros_like(u))
