"""The port's error-feedback gradient compression against the reference's
`ef_compress_update`: int8 codes and scales, restored values and residuals
bit for bit over several steps; sign codes bit for bit, the sign scale
(a float32 mean: the sum's order differs) within 1e-6; and the reference's
convergence check (`tests/test_substrate.py`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_helpers  # noqa: E402,F401  (one torch thread a worker)

from repro.dist.compress import ef_compress_update as r_ef  # noqa: E402
from repro_torch.dist import ef_compress_update as t_ef  # noqa: E402
from repro_torch import tree  # noqa: E402


def _grads(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    arrs = {"a": rng.normal(0, scale, (64,)).astype(np.float32),
            "b": [rng.normal(0, scale, (8, 5)).astype(np.float32),
                  np.zeros((3,), np.float32)],
            # exact halves of the int8 grid: round half to even
            "c": (np.array([0.5, 1.5, -2.5, 127.0, 3.5, -0.5], np.float32))}
    return (jax.tree.map(jnp.asarray, arrs),
            tree.map(lambda a: torch.from_numpy(a.copy()), arrs))


def _np_leaves(t, port):
    if port:
        return [x.numpy() for x in tree.leaves(t)]
    return [np.asarray(x) for x in jax.tree.leaves(t)]


@pytest.mark.parametrize("method", ["int8", "sign", "none"])
@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_codes_restored_and_residual(method, scale):
    r_res = t_res = None
    exact = method != "sign"
    for k in range(3):
        rg, tg = _grads(k, scale)
        rc, rr, r_res = r_ef(rg, r_res, method)
        tc, tr, t_res = t_ef(tg, t_res, method)
        for a, b in zip(_np_leaves(tc, True), _np_leaves(rc, False)):
            assert a.dtype == b.dtype
            if exact or a.dtype == np.int8:  # codes
                np.testing.assert_array_equal(a, b)
            else:  # the sign scale
                np.testing.assert_allclose(a, b, rtol=1e-6)
        for a, b in zip(_np_leaves(tr, True) + _np_leaves(t_res, True),
                        _np_leaves(rr, False) + _np_leaves(r_res, False)):
            if exact:
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6,
                                           atol=1e-6 * scale)


def test_int8_codes_round_half_to_even():
    g = torch.tensor([0.5, 1.5, -2.5, 127.0], dtype=torch.float32)
    comp, _, _ = t_ef({"g": g}, None, "int8")
    codes, scale = comp["g"]
    assert float(scale) == 1.0
    assert codes.tolist() == [0, 2, -2, 127]


def test_error_feedback_compression_converges():
    g_np = np.random.default_rng(0).normal(0, 1, (64,)).astype(np.float32)
    g = torch.from_numpy(g_np)
    residual = None
    acc = torch.zeros_like(g)
    for _ in range(50):
        _, restored, residual = t_ef({"g": g}, residual, "int8")
        acc = acc + restored["g"]
    np.testing.assert_allclose((acc / 50).numpy(), g_np, atol=2e-2)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown compression"):
        t_ef({"g": torch.ones(3)}, None, "fp4")
