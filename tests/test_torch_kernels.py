"""The port's LUT, crossbar MVM and Fig.-8 softmax kernels against the JAX
kernels.

On the CPU the port's wrappers (`acam_lut`, `acam_mvm`,
`acam_softmax_codes`) run their kernels' plain PyTorch versions; the
reference's Pallas kernels run in interpret mode, as tests/test_kernels.py
runs them. Every result is int32 codes and must be equal bit for bit:
tests/test_kernels.py's own shapes, all 256 codes through the gelu and silu
tables, quantize mode with bk != cfg.rows, K not a multiple of bk, and
softmax rows whose sums sit within an ulp of every PoT boundary the rows
can reach. The float32 rules under them (the ADC transfer, the runtime PoT
decode, the row-sum order) are held in tests/test_torch_xla_numerics.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import crossbar as RC  # noqa: E402
from repro.core import ops as Rops  # noqa: E402
from repro.core.ops import LOGIT_FMT  # noqa: E402
from repro.kernels import ops as R  # noqa: E402
from repro.kernels import ref as Rref  # noqa: E402
from repro_torch.core import crossbar as TC  # noqa: E402
from repro_torch.core import ops as Tops  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.kernels import acam_softmax as TS  # noqa: E402
from repro_torch.kernels import ops as T  # noqa: E402
from repro_torch.kernels import ref as Tref  # noqa: E402

MODES = ("pot", "pot_fine", "uniform")


def _tcfg(cfg):
    """The port's CrossbarConfig with the reference's fields."""
    return TC.CrossbarConfig(**{f: getattr(cfg, f)
                                for f in cfg.__dataclass_fields__})


def _ints(rng, shape, dtype=np.int8):
    return rng.integers(-128, 128, shape).astype(dtype)


# ----------------------------------------------------------------- LUT

@pytest.mark.parametrize("shape", [(1, 1), (7, 130), (256, 128), (3, 5, 64),
                                   (33, 257)])
@pytest.mark.parametrize("dtype", [np.int8, np.int32])
def test_lut_shapes_dtypes(shape, dtype):
    rng = np.random.default_rng(0)
    x = _ints(rng, shape, dtype)
    lut = _ints(rng, 256, np.int32)
    want = np.asarray(R.acam_lut(jnp.asarray(x), jnp.asarray(lut),
                                 interpret=True))
    got = T.acam_lut(torch.from_numpy(x), torch.from_numpy(lut))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        Tref.lut_ref(torch.from_numpy(x), torch.from_numpy(lut)).numpy(),
        np.asarray(Rref.lut_ref(jnp.asarray(x), jnp.asarray(lut))))


@pytest.mark.parametrize("name", ["gelu", "silu"])
def test_activation_every_code(name):
    """All 256 codes of the op's input format through its table, as codes
    (`acam_lut`) and as floats (`acam_activation`), and the tables equal."""
    op_r, op_t = Rops.get_op(name), Tops.get_op(name)
    np.testing.assert_array_equal(op_t._lut, op_r._lut)
    codes = np.arange(-128, 128, dtype=np.int32).reshape(2, 128)
    want = np.asarray(R.acam_lut(jnp.asarray(codes), jnp.asarray(op_r._lut),
                                 bias=128, interpret=True))
    got = T.acam_lut(torch.from_numpy(codes), op_t.lut("cpu"), bias=128)
    np.testing.assert_array_equal(got.numpy(), want)
    x = (codes * op_r.in_fmt.scale).astype(np.float32)
    want = np.asarray(R.acam_activation(jnp.asarray(x), name, interpret=True))
    got = T.acam_activation(torch.from_numpy(x), name)
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------- MVM

def _mvm_pair(x, w, cfg=RC.CrossbarConfig(), **kw):
    want = np.asarray(R.acam_mvm(jnp.asarray(x), jnp.asarray(w), cfg,
                                 interpret=True, **kw))
    bk = kw.get("bk")
    got = T.acam_mvm(torch.from_numpy(x), torch.from_numpy(w), _tcfg(cfg),
                     bk=bk)
    assert got.dtype == torch.int32
    return want, got.numpy()


@pytest.mark.parametrize("seed", range(4))
def test_mvm_small_tiles(seed):
    """tests/test_kernels.py's property test (bm 32, bn 128, bk 64) on
    seeded shapes: equal to the Pallas kernel and to x @ w."""
    rng = np.random.default_rng(seed)
    m, k, n = (int(rng.integers(1, 71)), int(rng.integers(1, 301)),
               int(rng.integers(1, 141)))
    x, w = _ints(rng, (m, k)), _ints(rng, (k, n))
    want, got = _mvm_pair(x, w, bm=32, bn=128, bk=64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x.astype(np.int32) @ w.astype(np.int32))


@pytest.mark.parametrize("mkn", [(4, 100, 8), (16, 128, 128), (33, 300, 65),
                                 (128, 512, 256)])
def test_mvm_exact_shapes(mkn):
    m, k, n = mkn
    rng = np.random.default_rng(1)
    x, w = _ints(rng, (m, k)), _ints(rng, (k, n))
    want, got = _mvm_pair(x, w)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        Tref.mvm_exact_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(Rref.mvm_exact_ref(jnp.asarray(x), jnp.asarray(w))))


@pytest.mark.parametrize("adc_bits", [6, 8])
def test_mvm_quantized_adc(adc_bits):
    """tests/test_kernels.py's quantize case: the kernel, the oracle and the
    port's `mvm_ref` agree bit for bit."""
    cfg = RC.CrossbarConfig(adc_mode="quantize", adc_bits=adc_bits)
    rng = np.random.default_rng(2)
    x, w = _ints(rng, (8, 256)), _ints(rng, (256, 32))
    want, got = _mvm_pair(x, w, cfg)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        Tref.mvm_ref(torch.from_numpy(x), torch.from_numpy(w),
                     _tcfg(cfg)).numpy(),
        np.asarray(Rref.mvm_ref(jnp.asarray(x), jnp.asarray(w), cfg)))


@pytest.mark.parametrize("adc_bits", [4, 8])
@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("k", [300, 256])
def test_mvm_quantize_tiles(adc_bits, bk, k):
    """Quantize mode with bk != cfg.rows (the step of 128 rows applied per
    64-row tile, the Pallas kernel's function, not the oracle's) and K not
    a multiple of bk (padded rows carry zero, rowsum and colsum too)."""
    cfg = RC.CrossbarConfig(adc_mode="quantize", adc_bits=adc_bits)
    rng = np.random.default_rng(3)
    x, w = _ints(rng, (9, k)), _ints(rng, (k, 40))
    want, got = _mvm_pair(x, w, cfg, bk=bk)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bk", [64, 128])
def test_mvm_exact_k_not_multiple(bk):
    rng = np.random.default_rng(4)
    x, w = _ints(rng, (5, 199)), _ints(rng, (199, 130))
    want, got = _mvm_pair(x, w, bk=bk)
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- softmax

@pytest.mark.parametrize("shape", [(4, 64), (3, 130), (8, 1024), (1, 16)])
@pytest.mark.parametrize("mode", MODES)
def test_softmax_codes_shapes(shape, mode):
    """tests/test_kernels.py's shapes, every mode ("uniform" runs the
    pot_fine tables in both kernels); also the port's staged oracle where
    the mode has the same meaning."""
    rng = np.random.default_rng(5)
    codes = np.array(LOGIT_FMT.encode(
        jnp.asarray(rng.normal(0, 3, shape), jnp.float32)))
    want = np.asarray(R.acam_softmax_codes(jnp.asarray(codes), mode=mode,
                                           interpret=True))
    got = T.acam_softmax_codes(torch.from_numpy(codes), mode=mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        T.acam_softmax_codes(torch.from_numpy(codes.astype(np.int8)),
                             mode=mode).numpy(), want)
    if mode != "uniform":
        np.testing.assert_array_equal(
            Tref.softmax_codes_ref(torch.from_numpy(codes), mode).numpy(),
            np.asarray(Rref.softmax_codes_ref(jnp.asarray(codes), mode)))


@pytest.mark.parametrize("mode", MODES)
def test_softmax_float_wrapper(mode):
    rng = np.random.default_rng(6)
    x = rng.normal(0, 4, (2, 3, 200)).astype(np.float32)
    want = np.asarray(R.acam_softmax_kernel(jnp.asarray(x), mode=mode,
                                            interpret=True))
    got = T.acam_softmax_kernel(torch.from_numpy(x), mode=mode)
    np.testing.assert_array_equal(got.numpy(), want)


def _straddling_rows(mode, L=256, n_fine=96):
    """Rows of LOGIT codes whose padded row sums land on both sides of each
    PoT boundary 2^(e_min + (j - 1/2) step) they can reach, as close as the
    available values allow (within one ulp for boundaries >= 1).

    Each row: a greedy coarse part, the filler code -128 (the smallest
    value, vmin), and n fine codes of value vf replacing filler at the end,
    so each step of n moves the sum by vf - vmin, at most one ulp; the row
    with the largest sum below and the smallest at or above are kept.
    Returns (rows, boundaries, sums)."""
    exp_lut, pot_vals, *_, e_min, step, _fs = TS.softmax_kernel_tables(mode)
    vals = pot_vals[exp_lut].astype(np.float64)  # value of code x at x + 128
    uniq, first = np.unique(vals, return_index=True)
    xs = first - 128
    vmin = uniq[0]
    rows, bounds, sums = [], [], []
    for j in range(1024):
        B = np.float32(2.0 ** (e_min + (j - 0.5) * step))
        if B < 2 * L * vmin:
            continue
        if B > uniq[-1] * (L - n_fine) / 2:
            break
        inc = uniq - vmin
        ok = np.nonzero((inc > 0) & (inc <= np.spacing(B)))[0]
        fi = ok[-1] if len(ok) else 1
        target = float(B) - L * vmin - n_fine // 2 * inc[fi]
        coarse = []
        for x, v in zip(xs[::-1], uniq[::-1]):
            while v - vmin <= target and len(coarse) < L - n_fine - 4:
                coarse.append(x)
                target -= v - vmin
        cand = np.full((n_fine + 1, L), -128, np.int32)
        cand[:, :len(coarse)] = coarse
        for n in range(n_fine + 1):
            cand[n, L - n_fine:L - n_fine + n] = xs[fi]
        S = TQ.ref_sum(torch.from_numpy(pot_vals[exp_lut[cand + 128]])).numpy()
        below, above = np.nonzero(S < B)[0], np.nonzero(S >= B)[0]
        for pick in ([below[-1]] if len(below) else []) + (
                [above[0]] if len(above) else []):
            rows.append(cand[pick])
            bounds.append(B)
            sums.append(S[pick])
    return np.array(rows), np.array(bounds), np.array(sums)


@pytest.mark.parametrize("mode", MODES)
def test_softmax_rows_straddle_pot_boundaries(mode):
    rows, bounds, sums = _straddling_rows(mode)
    big = bounds >= 1
    ulps = np.abs(sums.view(np.int32).astype(np.int64)
                  - bounds.view(np.int32))
    assert big.sum() > 50 and ulps[big].max() <= 1
    assert (sums < bounds).any() and (sums >= bounds).any()
    want = np.asarray(R.acam_softmax_codes(jnp.asarray(rows), mode=mode,
                                           interpret=True))
    got = T.acam_softmax_codes(torch.from_numpy(rows), mode=mode)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_take_the_plain_path_on_the_cpu(monkeypatch):
    """A CPU tensor runs the plain version; the kernel's launch function is
    never reached and no launch is counted."""
    from repro_torch.kernels import acam_lut as TL
    from repro_torch.kernels import acam_mvm as TM
    for mod in (TL, TM, TS):
        monkeypatch.setattr(mod, "_launch", lambda *a, **k: pytest.fail(
            "a CPU tensor reached the kernel's launch"))
    before = (dict(TL.launches), dict(TM.launches), dict(TS.launches))
    x = torch.zeros((2, 8), dtype=torch.int8)
    T.acam_lut(x, torch.arange(256, dtype=torch.int32))
    T.acam_mvm(x, torch.zeros((8, 3), dtype=torch.int8))
    T.acam_softmax_codes(x)
    assert (TL.launches, TM.launches, TS.launches) == before
