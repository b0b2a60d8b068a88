"""The port's contiguous and one-tile attention against the JAX kernel.

On the CPU `acam_attention_codes` runs the plain PyTorch versions of the
CUDA kernels (`acam_attention_contiguous_plain`, the two-pass kernel, and
`acam_attention_single_plain`, the one-tile kernel). Their ``out32`` and
``cmax`` must equal the Pallas kernels' (interpret mode) bit for bit:
scalar and per-group ``kv_len`` with zero-length groups, the pad-mask
decode, causal prefill at ``q_offset`` 0 and above, masked prefill with
fully masked rows, GQA decode, a sweep of key and fill lengths around the
32-key runs and the 128/512-key blocks, and all three softmax modes. The
decode-path quantizer `masked_prefix_quantize` must give the reference's
codes and scale bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import acam_attention as RA  # noqa: E402
from repro.kernels import ops as R  # noqa: E402
from repro_torch.kernels import acam_attention as TA  # noqa: E402
from repro_torch.kernels import ops as T  # noqa: E402

MODES = ("pot", "pot_fine", "uniform")
SWEEP = (1, 31, 32, 33, 127, 128, 129, 255, 257, 511, 512, 513, 1024)


def _operands(rng, G, Sq, Sk, D=16):
    q = rng.integers(-128, 128, (G, Sq, D), dtype=np.int8)
    k = rng.integers(-128, 128, (G, Sk, D), dtype=np.int8)
    v = rng.integers(-128, 128, (G, Sk, D), dtype=np.int8)
    # a few LOGIT units per key, so the row sums cross many PoT codes
    s1 = np.float32(rng.uniform(1e-3, 6e-3))
    return q, k, v, s1


def _both(entry, q, k, v, s1, *, mask=None, kv_len=None, mode="pot",
          q_offset=0, causal=False):
    """(reference (out, cmax), port (out, cmax)) for one call of ``entry``
    ("codes", "decode" or "gqa")."""
    if entry == "codes":
        want = RA.acam_attention_codes(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.float32(s1),
            None if mask is None else jnp.asarray(mask), q_offset=q_offset,
            kv_len=None if kv_len is None else jnp.asarray(kv_len),
            mode=mode, causal=causal, interpret=True)
    else:
        fn = (RA.acam_attention_decode_codes if entry == "decode"
              else RA.acam_attention_decode_gqa_codes)
        want = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jnp.float32(s1), jnp.asarray(kv_len),
                  mask=None if mask is None else jnp.asarray(mask), mode=mode,
                  interpret=True)
    t = torch.from_numpy
    args = (t(q), t(k), t(v), torch.tensor(s1))
    kvl = None if kv_len is None else torch.as_tensor(kv_len)
    m = None if mask is None else t(np.ascontiguousarray(mask))
    if entry == "codes":
        got = TA.acam_attention_codes(*args, m, kv_len=kvl, mode=mode,
                                      q_offset=q_offset, causal=causal)
    else:
        fn = (TA.acam_attention_decode_codes if entry == "decode"
              else TA.acam_attention_decode_gqa_codes)
        got = fn(*args, kvl, mask=m, mode=mode)
    return (np.asarray(want[0]), int(want[1])), (got[0].numpy(), int(got[1]))


def _assert_equal(pair):
    (w_out, w_cmax), (g_out, g_cmax) = pair
    assert g_cmax == w_cmax
    np.testing.assert_array_equal(g_out, w_out)
    return g_out


@pytest.fixture
def taken(monkeypatch):
    """Counts of calls into the two plain versions (which path was taken)."""
    seen = {"single": 0, "two_pass": 0}
    for key, name in (("single", "acam_attention_single_plain"),
                      ("two_pass", "acam_attention_contiguous_plain")):
        inner = getattr(TA, name)

        def spy(*a, _inner=inner, _key=key, **kw):
            seen[_key] += 1
            return _inner(*a, **kw)
        monkeypatch.setattr(TA, name, spy)
    return seen


@pytest.mark.parametrize("n", SWEEP)
def test_key_length_sweep(n, taken):
    """Sk = n keys, all valid, flat prefill rows: one block up to 512 keys
    (one tile for G <= 8), then 512-key blocks with a padded last block."""
    rng = np.random.default_rng(n)
    q, k, v, s1 = _operands(rng, G=3, Sq=5, Sk=n)
    _assert_equal(_both("codes", q, k, v, s1, mode=MODES[n % 3]))
    assert taken["single" if n <= 512 else "two_pass"] == 1


@pytest.mark.parametrize("n", SWEEP)
def test_fill_length_sweep(n, taken):
    """Decode against a 1024-key cache valid to kv_len = n (scalar), over
    11 groups: the two-pass kernel stopping at the fill level."""
    rng = np.random.default_rng(100 + n)
    q, k, v, s1 = _operands(rng, G=11, Sq=1, Sk=1024)
    _assert_equal(_both("decode", q, k, v, s1, kv_len=np.int32(n),
                        mode=MODES[n % 3]))
    assert taken["two_pass"] == 1


@pytest.mark.parametrize("mode", MODES)
def test_per_group_lengths_with_empty_groups(mode):
    rng = np.random.default_rng(7)
    q, k, v, s1 = _operands(rng, G=13, Sq=1, Sk=700)
    kv = rng.integers(1, 701, 13).astype(np.int32)
    kv[[0, 5]] = 0
    out = _assert_equal(_both("decode", q, k, v, s1, kv_len=kv, mode=mode))
    assert not out[[0, 5]].any()


@pytest.mark.parametrize("mode", MODES)
def test_pad_mask_decode(mode):
    """A left-padded bucket's decode: scalar fill, pad slots masked."""
    rng = np.random.default_rng(8)
    B, H, Smax = 3, 4, 600
    q, k, v, s1 = _operands(rng, G=B * H, Sq=1, Sk=Smax)
    pad = np.array([0, 17, 140])
    valid = np.arange(Smax)[None, :] >= pad[:, None]
    mask = np.repeat(valid[:, None, :], H, axis=0)  # (B*H, 1, Smax)
    _assert_equal(_both("decode", q, k, v, s1, kv_len=np.int32(301),
                        mask=mask, mode=mode))


@pytest.mark.parametrize("q_offset", [0, 9])
@pytest.mark.parametrize("mode", MODES)
def test_causal_prefill(mode, q_offset):
    """In-kernel causal mask: row i attends keys <= i + q_offset (two-pass
    with 8 < G and 300 rows, so two row tiles)."""
    rng = np.random.default_rng(9 + q_offset)
    q, k, v, s1 = _operands(rng, G=10, Sq=300, Sk=300 + q_offset)
    _assert_equal(_both("codes", q, k, v, s1, mode=mode, causal=True,
                        q_offset=q_offset))


@pytest.mark.parametrize("mode", MODES)
def test_masked_prefill_with_fully_masked_rows(mode):
    """A left-padded bucket's prefill: causal plus per-row pad masks, whose
    early rows see no key at all and still count in cmax."""
    rng = np.random.default_rng(10)
    B, H, S = 2, 5, 140
    q, k, v, s1 = _operands(rng, G=B * H, Sq=S, Sk=S)
    pad = np.array([0, 60])
    causal = np.arange(S)[None, :] <= np.arange(S)[:, None]
    m = causal[None] & (np.arange(S)[None, None, :] >= pad[:, None, None])
    mask = np.repeat(m, H, axis=0)
    _assert_equal(_both("codes", q, k, v, s1, mask=mask, mode=mode))


@pytest.mark.parametrize("mode", MODES)
def test_gqa_decode(mode):
    """GQA-native decode: B*KV = 6 groups (one tile) and 12 (two-pass),
    rep = 4 rows each, scalar and per-group fills with a pad mask."""
    rng = np.random.default_rng(11)
    for G, kv in ((6, np.int32(200)), (12, rng.integers(0, 513, 12)
                                           .astype(np.int32))):
        q, k, v, s1 = _operands(rng, G=G, Sq=4, Sk=512)
        mask = np.broadcast_to(rng.random((G, 1, 512)) < 0.8, (G, 4, 512))
        _assert_equal(_both("gqa", q, k, v, s1, kv_len=kv, mask=mask,
                            mode=mode))


@pytest.mark.parametrize("mode", MODES)
def test_one_tile_shapes(mode, taken):
    """Shapes the one-tile rule accepts (G <= 8, Sq <= 256, Sk <= 512): the
    single plain version is taken and equals `_attn_kernel_single`."""
    rng = np.random.default_rng(12)
    cases = [
        dict(G=8, Sq=8, Sk=512, kv_len=np.int32(333)),           # solo GQA
        dict(G=5, Sq=3, Sk=77, kv_len=rng.integers(0, 78, 5)
             .astype(np.int32)),                                   # per-group
        dict(G=2, Sq=40, Sk=40, causal=True, q_offset=0),          # prefill
        dict(G=7, Sq=2, Sk=129, causal=True, q_offset=127),        # offset
    ]
    for c in cases:
        assert TA.one_tile(c["G"], c["Sq"], c["Sk"])
        q, k, v, s1 = _operands(rng, c["G"], c["Sq"], c["Sk"])
        kw = {x: c[x] for x in ("kv_len", "causal", "q_offset") if x in c}
        _assert_equal(_both("codes", q, k, v, s1, mode=mode, **kw))
    assert taken == {"single": len(cases), "two_pass": 0}


def test_cmax_floor_on_both_paths():
    rng = np.random.default_rng(13)
    for G, Sk in ((4, 100), (9, 600)):
        q, k, v, s1 = _operands(rng, G=G, Sq=2, Sk=Sk)
        s1 = np.float32(s1 * 0.01)
        want = RA.acam_attention_codes(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.float32(s1),
            cmax_floor=jnp.int32(200), interpret=True)
        got = TA.acam_attention_codes(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.tensor(s1), cmax_floor=torch.tensor(200, dtype=torch.int32))
        assert int(got[1]) == int(want[1]) == 200
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("kv", ["scalar", "rows"])
def test_masked_prefix_quantize_bitwise(kv):
    """Codes and scale of the decode prolog, as the reference's jitted
    decode step computes them (cache layout (B, Smax, KV, hd), axis 1)."""
    rng = np.random.default_rng(14)
    x = rng.normal(0, 1.5, (3, 40, 2, 8)).astype(np.float32)
    x[:, 30:] = 1e4  # stale tail entries must not reach the scale
    kv_len = np.int32(30) if kv == "scalar" else np.array([30, 0, 12],
                                                           np.int32)
    wc, ws = jax.jit(R.masked_prefix_quantize, static_argnames="axis")(
        jnp.asarray(x), jnp.asarray(kv_len), axis=1)
    gc, gs = T.masked_prefix_quantize(torch.from_numpy(x),
                                      torch.as_tensor(kv_len), axis=1)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert gs.item() == float(ws)


def test_contiguous_wrapper_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(15)
    q, k, v, s1 = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                   else torch.tensor(a) for a in _operands(rng, 4, 2, 50))
    with pytest.raises(ValueError):  # group dims differ
        TA.acam_attention_codes(q, k[:3], v[:3], s1)
    with pytest.raises(ValueError):  # one length per group
        TA.acam_attention_codes(q, k, v, s1,
                                kv_len=torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError):  # mask rows must divide the groups
        TA.acam_attention_codes(q, k, v, s1,
                                torch.ones((3, 2, 50), dtype=torch.bool))
    with pytest.raises(TypeError):
        TA.acam_attention_codes(q.to(torch.int16), k, v, s1)


def test_sum_chunks_rule():
    """The run structure the plain versions and the kernels share."""
    assert TA.sum_chunks(31) == [31]
    assert TA.sum_chunks(128) == [32] * 4
    assert TA.sum_chunks(33) == [17, 16]
    assert TA.sum_chunks(300) == [22] + [32] * 8 + [22]
    for n in range(1, 513):
        assert sum(TA.sum_chunks(n)) == n
