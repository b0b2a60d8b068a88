"""The four public functions of `repro.core` the port added last, against
the reference on numpy inputs from a seed:

* `fake_quant`: its forward bit-equal to the reference's jitted one (per
  tensor and per channel, 4, 8 and 12 bits, values over six decades), its
  gradient the identity, as ``jax.grad`` of the reference's gives;
* `dequantize_tensor` of `quantize_tensor`, bit-equal;
* `build_table_1var` on the formats of `repro.core.ops` (GELU, LOGIT,
  PROB, the log output, int8) with the functions the tables hold, equal;
* `gray_decode_bits` on numpy and torch inputs, equal along every axis.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import compiler as RC, gray as RG, quant as RQ  # noqa: E402
from repro_torch.core import compiler as TC, gray as TG  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402

import _torch_helpers  # noqa: E402,F401  (one torch thread a worker)


def _inputs(seed, n=8):
    """``n`` arrays of one shape (one jitted graph), each scaled by 10**u,
    u uniform in [-3, 3]."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield (rng.standard_normal((13, 24)) * 10 ** rng.uniform(-3, 3)
               ).astype(np.float32)


@pytest.mark.parametrize("bits", [4, 8, 12])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_fake_quant_forward_matches_the_jitted_reference(bits, axis):
    for x in _inputs(bits * 10 + (axis or 0)):
        want = np.asarray(RQ.fake_quant(jnp.asarray(x), bits=bits,
                                        axis=axis))
        got = TQ.fake_quant(torch.from_numpy(x), bits, axis).numpy()
        np.testing.assert_array_equal(got, want)
        q_ref = RQ.quantize_tensor(jnp.asarray(x), bits=bits, axis=axis)
        q = TQ.quantize_tensor(torch.from_numpy(x), bits, axis)
        np.testing.assert_array_equal(TQ.dequantize_tensor(q).numpy(),
                                      np.asarray(RQ.dequantize_tensor(q_ref)))


@pytest.mark.parametrize("axis", [None, 1])
def test_fake_quant_gradient_is_straight_through(axis):
    x = next(_inputs(7))
    w = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(RQ.fake_quant(v, axis=axis) * w))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (TQ.fake_quant(xt, axis=axis) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), w)


def _gelu(x):
    return 0.5 * x * (1 + np.tanh(np.sqrt(2 / np.pi)
                                  * (x + 0.044715 * x ** 3)))


TABLES = [
    ("gelu", _gelu, (2, 5, True), (2, 5, True)),
    ("exp2", lambda x: np.exp2(x), (4, 3, True), (0, 8, False)),
    ("log2", lambda x: np.log2(np.maximum(x, 2.0 ** -8)), (0, 8, False),
     (5, 2, True)),
    ("tanh", np.tanh, (3, 0, True), (7, 0, True)),
    ("square", lambda x: x * x, (7, 0, True), (8, 0, False)),
]


@pytest.mark.parametrize("name,fn,fin,fout", TABLES,
                         ids=[t[0] for t in TABLES])
def test_build_table_1var_matches_reference(name, fn, fin, fout):
    rin, rout = RQ.FixedPointFormat(*fin), RQ.FixedPointFormat(*fout)
    tin, tout = TQ.FixedPointFormat(*fin), TQ.FixedPointFormat(*fout)
    want = RC.build_table_1var(fn, rin, rout)
    got = TC.build_table_1var(fn, tin, tout)
    assert got.dtype == want.dtype and got.shape == (rin.num_codes,)
    np.testing.assert_array_equal(got, want)
    assert TC.compile_1var(got, tout.bits).num_cells == \
        RC.compile_1var(want, rout.bits).num_cells


@pytest.mark.parametrize("shape", [(8,), (5, 6), (3, 4, 8)])
def test_gray_decode_bits_matches_reference_on_every_axis(shape):
    bits = np.random.default_rng(len(shape)).integers(0, 2, shape)
    for dtype in (np.int32, np.uint8):
        arr = bits.astype(dtype)
        for axis in range(-len(shape), len(shape)):
            want = RG.gray_decode_bits(arr, axis=axis)
            got = TG.gray_decode_bits(arr, axis=axis)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            tgot = TG.gray_decode_bits(torch.from_numpy(arr), axis=axis)
            assert tgot.dtype == torch.from_numpy(arr).dtype
            np.testing.assert_array_equal(tgot.numpy(), want)
            jgot = RG.gray_decode_bits(jnp.asarray(arr), axis=axis)
            np.testing.assert_array_equal(np.asarray(jgot), want)
