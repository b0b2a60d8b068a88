"""Core numerics of the port against the reference, bit for bit.

Formats and `quantize_tensor` on the full code range, every compiled op
table, the attention kernel's softmax tables, and the PoT encoder of the
row sum swept across every half-step boundary (where a one-ulp difference
in log2 would flip a code).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_helpers  # noqa: E402,F401  (one torch thread a worker)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ops as R_ops  # noqa: E402
from repro.core.quant import quantize_tensor as r_quantize  # noqa: E402
from repro.kernels.acam_attention import (  # noqa: E402
    _pot_encode_sum as r_pot_encode, softmax_tables as r_tables)
from repro_torch.core import ops as T_ops  # noqa: E402
from repro_torch.core.quant import (  # noqa: E402
    pot_encode as t_pot_encode, quantize_tensor as t_quantize, ref_log2)
from repro_torch.kernels.acam_attention import (  # noqa: E402
    softmax_tables as t_tables)

FORMATS = ["GELU_FMT", "LOGIT_FMT", "PROB_FMT", "LOG_OUT_FMT", "int8s", "int4u"]


@pytest.mark.parametrize("name", FORMATS)
def test_fixed_point_formats_bitwise(name):
    """encode over every code's value and the half-way points between codes
    (round half to even), decode of every code: equal to the reference's
    jitted jnp path."""
    rf, tf = getattr(R_ops, name), getattr(T_ops, name)
    codes = np.arange(rf.code_min - 2, rf.code_max + 3)
    xs = np.concatenate([codes, codes + 0.5, codes - 0.25]) * rf.scale
    xs = xs.astype(np.float32)
    want = np.asarray(jax.jit(rf.encode)(jnp.asarray(xs)))
    got = tf.encode(torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(got, want)
    inr = np.arange(rf.code_min, rf.code_max + 1, dtype=np.int32)
    np.testing.assert_array_equal(
        tf.decode(torch.from_numpy(inr)).numpy(),
        np.asarray(jax.jit(rf.decode)(jnp.asarray(inr))))


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_quantize_tensor_bitwise(axis):
    """Codes and scales equal the jitted reference's, whose /127 is a
    reciprocal multiply, on tensors of many magnitudes."""
    rng = np.random.default_rng(3)
    for t in range(40):
        x = (rng.standard_normal((7, 33)) * 10.0 ** rng.uniform(-4, 4)
             ).astype(np.float32)
        x[rng.integers(0, 7), rng.integers(0, 33)] *= 8  # a clear max
        want = r_quantize(jnp.asarray(x), bits=8, axis=axis)
        got = t_quantize(torch.from_numpy(x), bits=8, axis=axis)
        np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


@pytest.mark.parametrize("name", R_ops.OPS)
def test_op_tables_equal_reference(name):
    ref, port = R_ops.get_op(name), T_ops.get_op(name)
    assert port._lut.dtype == ref._lut.dtype
    np.testing.assert_array_equal(port._lut, ref._lut)
    assert port.cost.num_cells == ref.cost.num_cells


@pytest.mark.parametrize("name", ["gelu", "silu"])
def test_lut_activation_bitwise(name):
    """The raceit_lut activation: encode, gather, decode."""
    x = np.linspace(-5, 5, 4001, dtype=np.float32)
    op = R_ops.get_op(name)
    want = np.asarray(jax.jit(lambda v: op(v))(jnp.asarray(x)))
    got = T_ops.get_op(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["pot", "pot_fine", "uniform"])
def test_softmax_tables_bitwise(mode):
    """exp_val as the kernel's jitted graph folds it (exp2 of non-integers for
    pot_fine), and the log/prob tables, entry for entry."""
    ref = jax.jit(lambda: r_tables(mode)[:3])()
    ref_meta = r_tables(mode)[3:]
    port = t_tables(mode)
    for r, t in zip(ref, port[:3]):
        assert t.dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(t, np.asarray(r))
    assert port[3:] == ref_meta


def _boundary_sweep(e_min, step, ulps=6):
    """Every half-step boundary of the PoT grid that a row sum can reach
    (below 2^41), and the zero threshold, each +- a few float32 ulps."""
    ks = np.arange(-1, 256)
    ks = ks[e_min + (ks + 0.5) * step < 41]
    b = np.exp2(e_min + (ks + 0.5) * step).astype(np.float32)
    b = np.concatenate([b, [np.float32(2.0 ** (e_min - step / 2))]])
    bits = b.view(np.int32)
    return np.concatenate([(bits + d).view(np.float32)
                           for d in range(-ulps, ulps + 1)])


@pytest.mark.parametrize("step", [1.0, 0.25])
def test_pot_encode_boundary_sweep(step):
    e_min = -24.0
    S = _boundary_sweep(e_min, step)
    want = np.asarray(jax.jit(lambda s: r_pot_encode(s, e_min, step))(
        jnp.asarray(S)))
    got = t_pot_encode(torch.from_numpy(S), e_min, step).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.max() >= 63 / step  # the sweep spans the grid


def test_log2_matches_reference_graph():
    """float32 log2 as the reference's jitted graph computes it."""
    rng = np.random.default_rng(5)
    x = (2.0 ** rng.uniform(-26, 40, 200_000)).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log2)(jnp.asarray(x)))
    np.testing.assert_array_equal(ref_log2(torch.from_numpy(x)).numpy(), want)
