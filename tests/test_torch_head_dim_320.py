"""The Fig.-12 attention at head dim 320, gemma3-4b's (d_model 2560 / 8
heads: the reference's config sets no head_dim).

The port's CUDA kernels take head dims up to 320 (`CUDA_MAX_HEAD_DIM`, the
sources' ``kMaxD``); their plain versions are generic in D. Here the plain
`acam_attention_codes` at D 320 must equal the Pallas kernel in interpret
mode bit for bit (out32 and cmax) in every softmax mode, folded and with
the division by sqrt(320) inside the kernel (sqrt(320) is not a power of
two), in the layouts gemma3-4b's serving path and the kernel API reach:

* a banded local (sliding-window) mask with left-pad columns, as the slot
  pool's admission prefill gives it, over one and over two key blocks;
* contiguous decode with per-group lengths (zeros included), two query
  rows a group as the GQA decode of 8 heads over 4 KV heads gives it;
* causal prefill at a ``q_offset`` over two key blocks;
* the block-paged layout;
* one tile.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_helpers  # noqa: E402,F401  (one torch thread a worker)

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.kernels import acam_attention as RA  # noqa: E402
from repro_torch.kernels import acam_attention as TA  # noqa: E402

D = 320
MODES = ("pot", "pot_fine", "uniform")
LAYOUTS = ("local_band", "local_band_two_blocks", "contiguous_lens",
           "causal", "paged", "one_tile")
F32 = np.float32
CSRC = Path(TA.__file__).resolve().parent.parent / "csrc"


def _band(sq, sk, window, q_offset, pad):
    """(len(pad), sq, sk) bool: causal, inside the window, past the pad."""
    qi = np.arange(sq)[:, None] + q_offset
    ki = np.arange(sk)[None, :]
    m = (ki <= qi) & (ki > qi - window)
    return m[None] & (ki[None] >= np.asarray(pad)[:, None, None])


def _case(layout, rng):
    """(q, k, v) and the call's keywords for one layout at D 320."""
    qk = lambda s: rng.integers(-128, 128, s, dtype=np.int8)
    if layout == "local_band":  # 10 groups: past the one-tile rule
        pad = rng.integers(0, 20, 10)
        pad[0] = 0
        return (qk((10, 24, D)), qk((10, 24, D)), qk((10, 24, D))), \
            dict(mask=_band(24, 24, 8, 0, pad))
    if layout == "local_band_two_blocks":  # 600 keys: two key blocks
        return (qk((2, 40, D)), qk((2, 600, D)), qk((2, 600, D))), \
            dict(mask=_band(40, 600, 64, 560, [0, 3]))
    if layout == "contiguous_lens":
        kv = rng.integers(0, 300, 10).astype(np.int32)
        kv[4] = 0
        return (qk((10, 2, D)), qk((10, 300, D)), qk((10, 300, D))), \
            dict(kv_len=kv)
    if layout == "causal":
        return (qk((2, 24, D)), qk((2, 600, D)), qk((2, 600, D))), \
            dict(causal=True, q_offset=576)
    if layout == "paged":  # 2 slots x 3 groups, 3 pages of 32 keys, 4 pages
        bt = np.array([[2, 4, 1], [3, 0, 0]], np.int32)
        return (qk((6, 2, D)), qk((5 * 3, 32, D)), qk((5 * 3, 32, D))), \
            dict(kv_len=np.array([70, 70, 70, 20, 20, 20], np.int32),
                 paged=(bt, 32, 3))
    assert layout == "one_tile" and TA.one_tile(4, 3, 100)
    return (qk((4, 3, D)), qk((4, 100, D)), qk((4, 100, D))), \
        dict(kv_len=np.array([100, 37, 1, 64], np.int32))


def _call(q, k, v, s1, *, sqrt_d, mode, mask=None, kv_len=None, q_offset=0,
          causal=False, paged=None):
    """(reference (out, cmax), port (out, cmax)) of one codes call."""
    rkw = dict(mode=mode, scale_by_sqrt_d=sqrt_d)
    tkw = dict(rkw)
    if paged is not None:
        bt, ps, gps = paged
        rkw.update(block_table=jnp.asarray(bt), page_size=ps,
                   groups_per_slot=gps)
        tkw.update(block_table=torch.from_numpy(bt), page_size=ps,
                   groups_per_slot=gps)
    want = RA.acam_attention_codes(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.float32(s1),
        None if mask is None else jnp.asarray(mask), q_offset=q_offset,
        kv_len=None if kv_len is None else jnp.asarray(kv_len),
        causal=causal, interpret=True, **rkw)
    t = torch.from_numpy
    got = TA.acam_attention_codes(
        t(q), t(k), t(v), torch.tensor(s1),
        None if mask is None else t(np.ascontiguousarray(mask)),
        kv_len=None if kv_len is None else torch.as_tensor(kv_len),
        q_offset=q_offset, causal=causal, **tkw)
    return ((np.asarray(want[0]), int(want[1])),
            (got[0].numpy(), int(got[1])))


@pytest.mark.parametrize("sqrt_d", [None, D], ids=["folded", "sqrt-d"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", MODES)
def test_head_dim_320_codes_bitexact(mode, layout, sqrt_d):
    rng = np.random.default_rng(len(layout) + len(mode))
    (q, k, v), kw = _case(layout, rng)
    # a few LOGIT units per key: s1 ~ 4 / std(q . k), times sqrt(d) when
    # the kernel divides by it
    s1 = F32(rng.uniform(0.5, 2.0) * 4.0 / (np.sqrt(D) * 128 * 128 / 3)
             * (np.sqrt(D) if sqrt_d else 1.0))
    (w_out, w_cmax), (g_out, g_cmax) = _call(q, k, v, s1, sqrt_d=sqrt_d,
                                             mode=mode, **kw)
    assert g_cmax == w_cmax
    np.testing.assert_array_equal(g_out, w_out)
    assert w_cmax > 0  # the call carried probability mass


def test_sqrt_320_is_divided_in_the_kernel():
    """sqrt(320) is not a power of two: the kernels take rsd =
    f32(1 / sqrt(320)) rather than a folded scale."""
    s1, rsd = TA.sqrt_d_rule(torch.tensor(F32(1e-3)), D)
    assert float(s1) == float(F32(1e-3))
    assert rsd == float(F32(1) / np.sqrt(F32(D), dtype=F32))


def test_gemma3_head_dim_is_320():
    """The reference's gemma3-4b sets no head_dim, so its heads are 320
    wide, and the CUDA kernels' limit takes them."""
    assert get_config("gemma3-4b").resolved_head_dim == D
    assert TA.CUDA_MAX_HEAD_DIM == D


def test_kernel_sources_take_head_dim_320():
    """The launch checks of all three CUDA kernels read ``kMaxD``, which
    equals the wrappers' limit."""
    common = (CSRC / "acam_common.cuh").read_text()
    assert re.search(r"constexpr int kMaxD = (\d+);", common).group(1) \
        == str(TA.CUDA_MAX_HEAD_DIM)
    assert "D > kMaxD" in (CSRC / "acam_contiguous.cuh").read_text()
    assert "D > kMaxD" in (CSRC / "acam_attention.cu").read_text()
    single = (CSRC / "acam_attention_single.cu").read_text()
    assert "contiguous_params(" in single and "kMaxD" not in single


@pytest.mark.parametrize("d", [318, 320])
def test_padded_launch_takes_head_dims_to_320(d):
    """The CUDA launchers take D up to 320, padded to a multiple of 4 with
    zero codes (plain versions standing in for the kernels), and refuse
    wider heads."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.integers(-128, 128, s, dtype=np.int8))
               for s in ((9, 2, d), (9, 40, d), (9, 40, d)))
    args = (torch.tensor(F32(1e-4)), None,
            torch.full((9,), 40, dtype=torch.int32), False, "pot", None, 0,
            False)
    want = TA.acam_attention_contiguous_plain(q, k, v, *args)
    seen = []

    def plain(*a, **kw):
        seen.append(a[0].shape[-1])
        return TA.acam_attention_contiguous_plain(*a, **kw)
    got = TA._padded_to_4(plain, 3)(q, k, v, *args)
    assert seen == [320]
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    assert int(got[1]) == int(want[1])
    with pytest.raises(ValueError, match="up to 320"):
        TA._padded_to_4(plain, 3)(
            *(torch.zeros((1, 1, 324), dtype=torch.int8),) * 3)
