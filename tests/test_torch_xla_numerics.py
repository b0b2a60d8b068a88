"""The XLA float32 rules the port reproduces, against jitted JAX on the CPU.

* the ADC transfer: every partial sum p in [0, 384] for adc_bits 1..8
  (jitted ``p / step`` is a reciprocal multiply);
* the runtime PoT decode (`pot_decode_runtime`): ``jnp.exp2`` of codes known
  only at run time is XLA's Cephes exp with fused multiply-adds (`ref_exp`),
  one ulp off the correctly rounded values that folded constant tables get
  at some pot_fine codes;
* the reduction order of ``jnp.sum`` over the last axis (`ref_sum`).

Run as a script for the wide sweeps (minutes: one compile per row length):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_xla_numerics.py \
        [--max-len 4096]

which prints what it counts: `ref_exp` against ``jnp.exp`` on 4 M random
arguments and on every float32 of five binade ranges, the pot_fine codes
whose runtime and folded decodes differ, for each adc_bits the partial sums
whose jitted quotient is not the float32 division (and whose ADC output
differs), and `ref_sum` against ``jnp.sum`` for every row length up to
``--max-len``.
"""
import argparse
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_helpers  # noqa: E402,F401  (one torch thread a worker)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import crossbar as RC  # noqa: E402
from repro.core import ops as Rops  # noqa: E402
from repro_torch.core import crossbar as TC  # noqa: E402
from repro_torch.core import ops as Tops  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.kernels import acam_attention as TA  # noqa: E402
from repro_torch.kernels import acam_softmax as TS  # noqa: E402

F32 = np.float32


def _tcfg(cfg):
    return TC.CrossbarConfig(**{f: getattr(cfg, f)
                                for f in cfg.__dataclass_fields__})


@pytest.mark.parametrize("adc_bits", range(1, 9))
def test_adc_every_partial_sum(adc_bits):
    """Every p in [0, p_max] through the ADC transfer: the port's against
    the reference's jitted float32 graph (a reciprocal multiply)."""
    cfg = RC.CrossbarConfig(adc_mode="quantize", adc_bits=adc_bits)
    p = np.arange(0, 128 * 3 + 1, dtype=np.int32)
    want = np.asarray(jax.jit(functools.partial(RC._adc, cfg=cfg, rows=128))(
        jnp.asarray(p)))
    step = TC.adc_step(_tcfg(cfg), 128)
    assert step is not None
    got = TC._adc(torch.from_numpy(p), step)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["pot", "pot_fine"])
def test_runtime_pot_values(mode):
    """The host PoT-value tables equal the reference's jitted
    `PoTFormat.decode` on all 256 codes. For pot_fine they differ from the
    constant-folded (correctly rounded) decode of the attention tables:
    XLA's runtime exp is one ulp off at some codes."""
    exp_name = "exp_pot" if mode == "pot" else "exp_pot_fine"
    fmt_r = Rops.get_op(exp_name).out_fmt
    codes = np.arange(256, dtype=np.int32)
    want = np.asarray(jax.jit(fmt_r.decode)(jnp.asarray(codes)))
    pot_vals = TS.softmax_kernel_tables(mode)[1]
    np.testing.assert_array_equal(pot_vals, want)
    fmt_t = Tops.get_op(exp_name).out_fmt
    np.testing.assert_array_equal(
        fmt_t.decode(torch.from_numpy(codes)).numpy(), want)
    folded = TQ.pot_decode_f32(codes, fmt_r.e_min, fmt_r.octave_step)
    n_diff = int((folded != want).sum())
    assert n_diff > 0 if mode == "pot_fine" else n_diff == 0


def test_runtime_exp():
    """`ref_exp` is XLA's runtime float32 exp, bit for bit, on arguments
    spread over its whole finite range and dense where the PoT tables
    evaluate it (ln 2 times -24..39.5)."""
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.uniform(-87, 88, 500_000),
                        rng.uniform(-17, 28, 500_000)]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(jnp.asarray(x)))
    np.testing.assert_array_equal(TQ.ref_exp(torch.from_numpy(x)).numpy(),
                                  want)


@pytest.mark.parametrize("L", [1, 31, 33, 100, 1024, 1025, 1056, 1057, 2049,
                               3000, 4096])
def test_row_sum_order(L):
    """`ref_sum` is a jitted ``jnp.sum`` over the last axis, bit for bit, on
    values that spread over thirty octaves (where order shows)."""
    rng = np.random.default_rng(L)
    a = (2.0 ** rng.uniform(-30, 0, (4, L))).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.sum(v, axis=-1))(jnp.asarray(a)))
    np.testing.assert_array_equal(TQ.ref_sum(torch.from_numpy(a)).numpy(),
                                  want)
    assert TA.sum_chunks(L) == TQ.sum_chunks(L)


# ------------------------------------------------------- the wide sweeps

def probe_exp():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-87, 88, 2_000_000),
                        rng.uniform(-20, 5, 2_000_000)]).astype(F32)
    exp = jax.jit(jnp.exp)
    want = np.asarray(exp(jnp.asarray(x)))
    bad = int((TQ.ref_exp(torch.from_numpy(x)).numpy() != want).sum())
    off = int((want != np.exp(x.astype(np.float64)).astype(F32)).sum())
    print(f"exp: {len(x)} random arguments, ref_exp differs at {bad}; XLA "
          f"is off the correctly rounded exp at {off}")
    n = bad_all = 0
    for lo, hi in ((-17.0, -16.0), (-1.0, -0.5), (0.25, 0.5), (16.0, 32.0),
                   (64.0, 88.0)):
        a, b = sorted((F32(lo).view(np.int32), F32(hi).view(np.int32)))
        v = np.arange(a, b, dtype=np.int32).view(F32)
        got = TQ.ref_exp(torch.from_numpy(v)).numpy()
        bad_all += int((got != np.asarray(exp(jnp.asarray(v)))).sum())
        n += len(v)
    print(f"exp: every float32 of five binade ranges, {n} values, ref_exp "
          f"differs at {bad_all}")


def probe_pot_fine():
    fmt = Rops.get_op("exp_pot_fine").out_fmt
    codes = np.arange(1, 256)
    runtime = np.asarray(jax.jit(fmt.decode)(jnp.asarray(codes)))
    folded = TQ.pot_decode_f32(codes, fmt.e_min, fmt.octave_step)
    diff = codes[runtime != folded]
    print(f"pot_fine: runtime and folded decode differ at {len(diff)} of "
          f"255 codes: {diff.tolist()}")


def probe_sum(max_len):
    rng = np.random.default_rng(1)
    total = jax.jit(lambda a: jnp.sum(a, axis=-1))
    bad = []
    for n in range(1, max_len + 1):
        a = (2.0 ** rng.uniform(-30, 0, (8, n))).astype(F32)
        got = TQ.ref_sum(torch.from_numpy(a)).numpy()
        if not np.array_equal(got, np.asarray(total(jnp.asarray(a)))):
            bad.append(n)
    print(f"sum: row lengths 1..{max_len}, ref_sum differs at {len(bad)}: "
          f"{bad[:20]}")


def probe_adc():
    p = np.arange(0, 385, dtype=np.int32)
    for bits in range(1, 9):
        cfg = RC.CrossbarConfig(adc_mode="quantize", adc_bits=bits)
        step = 384 / ((1 << bits) - 1)
        q = np.asarray(jax.jit(lambda v: v / step)(jnp.asarray(p)))
        raw = int((q != p.astype(F32) / F32(step)).sum())
        adc = np.asarray(jax.jit(lambda v: RC._adc(v, cfg, 128))(
            jnp.asarray(p)))
        div = np.round(np.round(p.astype(F32) / F32(step)) * F32(step))
        print(f"adc_bits {bits}: jitted p/step is not the division at {raw} "
              f"of 385; the ADC output differs at "
              f"{int((adc != div.astype(np.int32)).sum())}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-len", type=int, default=4096)
    args = ap.parse_args()
    probe_exp()
    probe_pot_fine()
    probe_adc()
    probe_sum(args.max_len)


if __name__ == "__main__":
    main()
