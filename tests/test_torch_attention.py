"""The port's paged attention against the JAX kernel (interpret mode).

``acam_attention_codes`` on the CPU runs the plain PyTorch version of the
CUDA kernel; its ``out32`` and ``cmax`` must equal the Pallas kernel's bit
for bit on every paged case: flat decode, GQA decode, a masked chunk step,
shuffled block tables, zero-length slots, a cmax floor, and the three
softmax modes. The float wrappers must agree within the reference's own
bound, ``atol = PROB_FMT.scale * max|v|`` (tests/test_attention_fused.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as R  # noqa: E402
from repro.kernels.acam_attention import acam_attention_codes as r_codes  # noqa: E402
from repro_torch.kernels import ops as T  # noqa: E402
from repro_torch.kernels.acam_attention import acam_attention_codes as t_codes  # noqa: E402

PS, MP, N_SLOTS = 8, 4, 3
MODES = ("pot", "pot_fine", "uniform")


def _codes_case(kind, mode, seed, floor=None, s1_scale=1.0):
    """Int8 operands of one paged call; slot 0 is zero-length, the pool's
    pages are shuffled and page 0 is the trash page."""
    rng = np.random.default_rng(seed)
    gps, sq, d = {"flat": (4, 1, 16), "gqa": (2, 2, 16),
                  "chunk": (4, 5, 16)}[kind]
    G = N_SLOTS * gps
    n_pages = 1 + N_SLOTS * MP
    bt = rng.permutation(np.arange(1, n_pages))[: N_SLOTS * MP].reshape(
        N_SLOTS, MP).astype(np.int32)
    lens = np.array([0, rng.integers(1, MP * PS + 1), MP * PS - 3], np.int32)
    q = rng.integers(-128, 128, (G, sq, d), dtype=np.int8)
    k = rng.integers(-128, 128, (n_pages * gps, PS, d), dtype=np.int8)
    v = rng.integers(-128, 128, (n_pages * gps, PS, d), dtype=np.int8)
    s1 = np.float32(s1_scale * rng.uniform(2e-4, 3e-3))
    mask = None
    if kind == "chunk":  # query j of slot b attends columns <= offs[b] + j
        offs = np.maximum(lens - sq, 0)
        cols = np.arange(MP * PS)[None, None, :]
        m = cols <= (offs[:, None, None] + np.arange(sq)[None, :, None])
        mask = np.repeat(m, gps, axis=0)
    return dict(q=q, k=k, v=v, s1=s1, mask=mask, kv=np.repeat(lens, gps),
                bt=bt, gps=gps, mode=mode,
                floor=None if floor is None else np.int32(floor))


def _run_both(c):
    want = r_codes(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.float32(c["s1"]),
        None if c["mask"] is None else jnp.asarray(c["mask"]),
        kv_len=jnp.asarray(c["kv"]), mode=c["mode"],
        block_table=jnp.asarray(c["bt"]), page_size=PS,
        groups_per_slot=c["gps"],
        cmax_floor=None if c["floor"] is None else jnp.asarray(c["floor"]),
        interpret=True)
    t = torch.from_numpy
    got = t_codes(
        t(c["q"]), t(c["k"]), t(c["v"]), torch.tensor(c["s1"]),
        None if c["mask"] is None else t(c["mask"]), kv_len=t(c["kv"]),
        mode=c["mode"], block_table=t(c["bt"]), page_size=PS,
        groups_per_slot=c["gps"],
        cmax_floor=None if c["floor"] is None else torch.tensor(c["floor"]))
    return (np.asarray(want[0]), int(want[1])), (got[0].numpy(), int(got[1]))


@pytest.mark.parametrize("kind", ["flat", "gqa", "chunk"])
@pytest.mark.parametrize("mode", MODES)
def test_paged_codes_bitexact(kind, mode):
    (w_out, w_cmax), (g_out, g_cmax) = _run_both(
        _codes_case(kind, mode, seed=MODES.index(mode)))
    assert g_cmax == w_cmax
    np.testing.assert_array_equal(g_out, w_out)
    assert not g_out[: _codes_case(kind, mode, 0)["gps"]].any()  # empty slot


def test_paged_codes_cmax_floor():
    """A floor above every row's PROB max requantizes with the floor."""
    c = _codes_case("flat", "pot", seed=7, floor=200, s1_scale=0.01)
    (w_out, w_cmax), (g_out, g_cmax) = _run_both(c)
    assert g_cmax == w_cmax == 200
    np.testing.assert_array_equal(g_out, w_out)


def _pool_case(rng, rep, B=3, KV=2, D=16, sq=1):
    """Float q and a shuffled float pool whose non-live rows hold junk."""
    H = KV * rep
    n_pages = 1 + B * MP
    lens = np.array([MP * PS - 2, 0, 11], np.int32)[:B]
    q = rng.normal(0, 1.5, (B, H, sq, D)).astype(np.float32)
    pk = rng.choice((-1e4, 1e4), (n_pages, PS, KV, D)).astype(np.float32)
    pv = -pk
    order = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((B, MP), np.int32)
    nxt = 0
    for b, ln in enumerate(lens):
        for j in range(-(-ln // PS)):
            pg = int(order[nxt]); nxt += 1
            bt[b, j] = pg
            lv = min(PS, ln - j * PS)
            pk[pg, :lv] = rng.normal(0, 1.5, (lv, KV, D))
            pv[pg, :lv] = rng.normal(0, 1.5, (lv, KV, D))
    mask = None
    if sq > 1:
        offs = np.maximum(lens - sq, 0)
        mask = (np.arange(MP * PS)[None, None, :]
                <= offs[:, None, None] + np.arange(sq)[None, :, None])
    return q, pk, pv, lens, bt, mask


@pytest.mark.parametrize("entry", ["flat", "gqa", "gqa_masked", "chunk"])
@pytest.mark.parametrize("mode", MODES)
def test_float_wrappers_within_reference_bound(entry, mode):
    rng = np.random.default_rng(11 + MODES.index(mode))
    q, pk, pv, lens, bt, mask = _pool_case(rng, rep=2,
                                           sq=3 if entry == "chunk" else 1)
    if entry == "gqa_masked":  # one (1, Sk) mask row per slot
        mask = rng.random((len(lens), 1, MP * PS)) < 0.7
    gqa = entry.startswith("gqa")
    rf = (R.raceit_attention_decode_gqa_paged if gqa
          else R.raceit_attention_decode_paged)
    tf = (T.raceit_attention_decode_gqa_paged if gqa
          else T.raceit_attention_decode_paged)
    want = np.asarray(rf(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                         jnp.asarray(lens), jnp.asarray(bt),
                         mask=None if mask is None else jnp.asarray(mask),
                         softmax_mode=mode, fold_scale=True))
    t = torch.from_numpy
    got = tf(t(q), t(pk), t(pv), t(lens), t(bt),
             mask=None if mask is None else t(mask),
             softmax_mode=mode, fold_scale=True).numpy()
    live_v = max(np.abs(pv[bt[b, j], : min(PS, ln - j * PS)]).max()
                 for b, ln in enumerate(lens) for j in range(-(-ln // PS)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -8 * live_v)


@pytest.mark.parametrize("entry", ["flat", "gqa", "chunk"])
@pytest.mark.parametrize("mode", MODES)
def test_float_wrappers_bit_equal(entry, mode):
    """The float wrappers equal the reference's bit for bit: the logit
    scale and the descale multiply two quantizer scales as XLA does
    (`repro_torch.core.quant.scale_product`)."""
    rng = np.random.default_rng(21 + MODES.index(mode))
    q, pk, pv, lens, bt, mask = _pool_case(rng, rep=2,
                                           sq=3 if entry == "chunk" else 1)
    gqa = entry == "gqa"
    rf = (R.raceit_attention_decode_gqa_paged if gqa
          else R.raceit_attention_decode_paged)
    tf = (T.raceit_attention_decode_gqa_paged if gqa
          else T.raceit_attention_decode_paged)
    want = np.asarray(rf(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                         jnp.asarray(lens), jnp.asarray(bt),
                         mask=None if mask is None else jnp.asarray(mask),
                         softmax_mode=mode, fold_scale=True))
    t = torch.from_numpy
    got = tf(t(q), t(pk), t(pv), t(lens), t(bt),
             mask=None if mask is None else t(mask), softmax_mode=mode,
             fold_scale=True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_page_quantizers_bitwise():
    rng = np.random.default_rng(5)
    _, pk, _, lens, bt, _ = _pool_case(rng, rep=1)
    want_pv = np.asarray(R.page_valid_lengths(jnp.asarray(bt),
                                              jnp.asarray(lens), pk.shape[0],
                                              PS))
    got_pv = T.page_valid_lengths(torch.from_numpy(bt), torch.from_numpy(lens),
                                  pk.shape[0], PS)
    np.testing.assert_array_equal(got_pv.numpy(), want_pv)
    wc, ws = R.masked_page_quantize(jnp.asarray(pk), jnp.asarray(want_pv))
    gc, gs = T.masked_page_quantize(torch.from_numpy(pk), got_pv)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert gs.item() == float(ws)


def test_codes_wrapper_rejects_what_the_kernel_does_not_take():
    c = _codes_case("flat", "pot", seed=0)
    t = torch.from_numpy
    base = dict(kv_len=t(c["kv"]), block_table=t(c["bt"]), page_size=PS,
                groups_per_slot=c["gps"])
    args = (t(c["q"]), t(c["k"]), t(c["v"]), torch.tensor(c["s1"]))
    with pytest.raises(TypeError):
        t_codes(args[0].to(torch.int16), *args[1:], **base)
    with pytest.raises(ValueError):
        t_codes(*args, **dict(base, page_size=PS * 2))
    with pytest.raises(ValueError):  # the row-sum order is known for these
        t_codes(*args, **dict(base, page_size=48))
    with pytest.raises(ValueError):  # a pool without its table is no (G, Sk, D)
        t_codes(*args, kv_len=t(c["kv"]))
