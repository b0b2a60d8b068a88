"""The in-kernel division by sqrt(d) of the port's Fig.-12 kernels.

Where sqrt(d) is not a power of two (D 32, 128) the reference divides the
logits by sqrt(d) inside both kernel bodies; inside its jitted graph that
division is a multiply by f32(1/sqrt(d)) after the one by ``s1``. The
port's plain versions must equal the Pallas kernels (interpret mode) bit
for bit in codes, out32 and cmax:

* random operands in every layout (paged, contiguous two-pass with
  per-group lengths, causal prefill at a ``q_offset``, masked prefill,
  one tile) and every softmax mode;
* a boundary sweep: ``s1`` chosen so that ``r * s1 / sqrt(d)`` lands within
  an ulp of a LOGIT half step, where the division and the reciprocal
  orders round to different codes. The port must follow the reference on
  every case, and the other order must fail on some, so that the sweep
  tells the two apart;
* the float wrappers (`raceit_attention_fused`,
  `raceit_attention_decode_fused`, `raceit_attention_decode_gqa`, the paged
  wrappers) at D 64 and 128, and `raceit_attention(fused=True)`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import attention as RCA  # noqa: E402
from repro.kernels import acam_attention as RA  # noqa: E402
from repro.kernels import ops as R  # noqa: E402
from repro_torch.core import attention as TCA  # noqa: E402
from repro_torch.kernels import acam_attention as TA  # noqa: E402
from repro_torch.kernels import ops as T  # noqa: E402

MODES = ("pot", "pot_fine", "uniform")
F32 = np.float32
LAYOUTS = ("paged", "contiguous", "causal", "masked", "one_tile")


def _call(q, k, v, s1, d, *, mask=None, kv_len=None, q_offset=0,
          causal=False, mode="pot", paged=None):
    """(reference (out, cmax), port (out, cmax)) of one codes call with
    ``scale_by_sqrt_d=d``; ``paged`` = (block_table, page_size, gps)."""
    kw = dict(mode=mode, scale_by_sqrt_d=d)
    rkw, tkw = dict(kw), dict(kw)
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


def _layout_case(layout, rng, D, qk):
    """Operands of one layout; ``qk(shape)`` draws the int8 codes."""
    if layout == "paged":  # 2 slots x 3 groups, 3 pages of 32 keys, 4 pages
        q, pool_k, pool_v = qk((6, 1, D)), qk((5 * 3, 32, D)), qk((5 * 3, 32, D))
        bt = np.array([[2, 4, 1], [3, 0, 0]], np.int32)
        kv = np.array([70, 70, 70, 20, 20, 20], np.int32)
        return (q, pool_k, pool_v), dict(kv_len=kv, paged=(bt, 32, 3))
    if layout == "contiguous":  # 10 groups: past the one-tile rule
        G = 10
        kv = rng.integers(0, 300, G).astype(np.int32)
        kv[3] = 0
        return (qk((G, 1, D)), qk((G, 300, D)), qk((G, 300, D))), \
            dict(kv_len=kv)
    if layout == "causal":  # 600 keys: two key blocks
        return (qk((2, 24, D)), qk((2, 600, D)), qk((2, 600, D))), \
            dict(causal=True, q_offset=576)
    if layout == "masked":
        G = 9
        mask = rng.random((G, 12, 70)) > 0.3
        mask[0, 3] = False  # a fully masked row
        return (qk((G, 12, D)), qk((G, 70, D)), qk((G, 70, D))), \
            dict(mask=mask)
    assert layout == "one_tile"
    assert TA.one_tile(4, 3, 100)
    return (qk((4, 3, D)), qk((4, 100, D)), qk((4, 100, D))), \
        dict(kv_len=np.array([100, 37, 1, 64], np.int32))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", [32, 128])
def test_sqrt_d_codes_bitexact(d, mode, layout):
    rng = np.random.default_rng(d + len(layout))
    qk = lambda s: rng.integers(-128, 128, s, dtype=np.int8)
    (q, k, v), kw = _layout_case(layout, rng, d, qk)
    # a few LOGIT units per key after the division by sqrt(d)
    s1 = F32(rng.uniform(1e-3, 6e-3) * np.sqrt(d / 16))
    (w_out, w_cmax), (g_out, g_cmax) = _call(q, k, v, s1, d, mode=mode, **kw)
    assert g_cmax == w_cmax
    np.testing.assert_array_equal(g_out, w_out)


def _boundary_s1(d, r0, n):
    """An s1 at which ``r0 * s1`` then ``/ sqrt(d)`` and ``* f32(1/sqrt(d))``
    round to different LOGIT codes near half step ``n + 0.5``, or None."""
    sd = np.sqrt(F32(d), dtype=F32)
    s = F32((n + 0.5) / 8 * float(sd) / r0)
    for k in range(-8, 9):
        t = s
        for _ in range(abs(k)):
            t = np.nextafter(t, F32(np.inf) if k > 0 else F32(-np.inf))
        x = F32(F32(r0) * t)
        if np.round(F32(x / sd) * F32(8)) != np.round(F32(x * (F32(1) / sd))
                                                      * F32(8)):
            return t
    return None


def _dividing_logit_codes(d):
    """`_logit_codes` as it would be with the division order."""
    sd = float(np.sqrt(F32(d), dtype=F32))
    inner = TA._logit_codes

    def codes(q, k, s1, mask, causal, q_offset, rsd=None):
        if rsd is None:
            return inner(q, k, s1, mask, causal, q_offset)
        # s1 / sqrt(d) then * r is another order again; divide the product
        r = torch.bmm(q.double(), k.double().transpose(1, 2))
        logits = (r.float() * s1.float()) / sd
        xc = torch.clamp(torch.round(logits / 0.125), -128, 127).to(
            torch.int32)
        assert mask is None and not causal
        return xc
    return codes


@pytest.mark.parametrize("layout", ["one_tile", "contiguous", "paged"])
@pytest.mark.parametrize("d", [32, 128])
def test_sqrt_d_boundary_sweep_takes_the_reciprocal_order(d, layout,
                                                          monkeypatch):
    """Every key of a group at one dot product r0 = a * b, s1 an ulp from
    a LOGIT half step: the port equals the reference on every case, and
    the division order misses on some."""
    rng = np.random.default_rng(100 + d + len(layout))
    G, Sk = (4, 40) if layout == "one_tile" else (10, 64)
    cases = 0
    misses = 0
    while cases < 6:
        a, b = (int(x) for x in rng.integers(20, 128, 2))
        s1 = _boundary_s1(d, a * b, int(rng.integers(-120, 120)))
        if s1 is None:
            continue
        q = np.zeros((G, 2, d), np.int8)
        k = np.zeros((G, Sk, d), np.int8)
        v = rng.integers(-128, 128, (G, Sk, d), dtype=np.int8)
        q[:, :, 0] = a
        k[:, :, 0] = b
        k[:, Sk // 2:, 0] = rng.integers(-128, 128, (G, Sk - Sk // 2))
        kw = {}
        if layout == "paged":  # each group a slot of two 32-key pages
            bt = (1 + np.arange(2 * G, dtype=np.int32)).reshape(G, 2)
            pool = lambda x: np.concatenate(
                [np.zeros((1, 32, d), np.int8), x.reshape(2 * G, 32, d)])
            k, v = pool(k), pool(v)
            kw = dict(kv_len=np.full(G, Sk, np.int32), paged=(bt, 32, 1))
        cases += 1
        for mode in MODES:
            want, got = _call(q, k, v, s1, d, mode=mode, **kw)
            assert got[1] == want[1]
            np.testing.assert_array_equal(got[0], want[0])
            with monkeypatch.context() as m:
                m.setattr(TA, "_logit_codes", _dividing_logit_codes(d))
                _, other = _call(q, k, v, s1, d, mode=mode, **kw)
            misses += not (other[1] == want[1]
                           and np.array_equal(other[0], want[0]))
    assert misses > 0, "the sweep does not tell the two orders apart"


def _floats(rng, *shapes, std=1.5):
    return [rng.normal(0, std, s).astype(np.float32) for s in shapes]


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", [64, 128])
def test_raceit_attention_fused_any_head_dim(d, mode, causal):
    """The reference's default ``fold_scale=False`` at every head dim, and
    ``fused=True`` of the staged entry on top of it."""
    rng = np.random.default_rng(d + causal)
    q, k, v = _floats(rng, (2, 3, 9, d), (2, 3, 11, d), (2, 3, 11, d))
    kw = dict(softmax_mode=mode, causal=causal, q_offset=2 if causal else 0)
    want = np.asarray(R.raceit_attention_fused(
        *map(jnp.asarray, (q, k, v)), interpret=True, **kw))
    got = T.raceit_attention_fused(*_t(q, k, v), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    if not causal:
        want = np.asarray(RCA.raceit_attention(*map(jnp.asarray, (q, k, v)),
                                               softmax_mode=mode, fused=True))
        got = TCA.raceit_attention(*_t(q, k, v), softmax_mode=mode,
                                   fused=True)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", [64, 128])
def test_raceit_attention_decode_fused(d, mode, fold):
    """Scalar and per-row fills; G = 12 groups takes the two-pass kernel,
    one batch row of 4 heads the one-tile kernel."""
    rng = np.random.default_rng(d + 7 * fold)
    for B, H, smax, kv_len in ((3, 4, 96, np.array([96, 17, 0], np.int32)),
                               (1, 4, 80, np.int32(33))):
        q, k, v = _floats(rng, (B, H, 1, d), (B, H, smax, d),
                          (B, H, smax, d))
        kw = dict(softmax_mode=mode, fold_scale=fold)
        want = np.asarray(R.raceit_attention_decode_fused(
            *map(jnp.asarray, (q, k, v)), jnp.asarray(kv_len),
            interpret=True, **kw))
        got = T.raceit_attention_decode_fused(*_t(q, k, v),
                                              torch.as_tensor(kv_len), **kw)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", [64, 128])
def test_raceit_attention_decode_gqa(d, mode, rep):
    """The GQA-native decode against the reference's, and against the port's
    flat decode on the repeated cache (the same numbers)."""
    rng = np.random.default_rng(d + rep)
    B, KV, smax = 3, 2, 72
    kv_len = np.array([72, 5, 40], np.int32)
    q, k, v = _floats(rng, (B, KV * rep, 1, d), (B, KV, smax, d),
                      (B, KV, smax, d))
    want = np.asarray(R.raceit_attention_decode_gqa(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(kv_len),
        softmax_mode=mode, interpret=True))
    got = T.raceit_attention_decode_gqa(*_t(q, k, v), torch.from_numpy(kv_len),
                                        softmax_mode=mode)
    np.testing.assert_array_equal(got.numpy(), want)
    flat = T.raceit_attention_decode_fused(
        *_t(q, np.repeat(k, rep, 1), np.repeat(v, rep, 1)),
        torch.from_numpy(kv_len), softmax_mode=mode)
    np.testing.assert_array_equal(flat.numpy(), got.numpy())


@pytest.mark.parametrize("gqa", [False, True])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_wrappers_fold_scale(d, fold, gqa):
    """The paged wrappers take ``fold_scale`` with the reference's default
    (False: the division in the kernel)."""
    rng = np.random.default_rng(d + 2 * fold + gqa)
    B, KV, rep, ps, n_pages = 2, 2, 2, 16, 6
    q, kp, vp = _floats(rng, (B, KV * rep, 1, d), (n_pages, ps, KV, d),
                        (n_pages, ps, KV, d))
    bt = np.array([[1, 3, 0], [2, 4, 5]], np.int32)
    kv_len = np.array([20, 41], np.int32)
    name = ("raceit_attention_decode_gqa_paged" if gqa
            else "raceit_attention_decode_paged")
    kw = {} if not fold else dict(fold_scale=True)
    want = np.asarray(getattr(R, name)(
        *map(jnp.asarray, (q, kp, vp, kv_len, bt)), softmax_mode="pot",
        interpret=True, **kw))
    got = getattr(T, name)(*_t(q, kp, vp, kv_len, bt), softmax_mode="pot",
                           **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kernel_package_exports_the_reference_names():
    """Every public name of `repro.kernels` but its interpret-mode switches."""
    import repro.kernels as RK
    import repro_torch.kernels as TK
    want = {n for n in dir(RK) if not n.startswith("_")} - {
        "default_interpret", "resolve_interpret", "runtime", "ops", "ref",
        "acam_attention", "acam_lut", "acam_mvm", "acam_softmax"}
    want |= {"acam_lut", "acam_mvm"}  # functions, beside their modules
    assert want <= set(TK.__all__)
    assert all(callable(getattr(TK, n)) for n in want - {"FUSED_SOFTMAX_MODES"})
    assert TK.FUSED_SOFTMAX_MODES == RK.FUSED_SOFTMAX_MODES
    # the two names that are modules too run their function when called
    x = torch.arange(-4, 4, dtype=torch.int32).reshape(2, 4)
    lut = torch.arange(256, dtype=torch.int32)
    np.testing.assert_array_equal(TK.acam_lut(x, lut, bias=128).numpy(),
                                  (x + 128).numpy())
    assert TK.acam_mvm.acam_mvm_plain is not None


@pytest.mark.parametrize("d", [6, 36, 100])
def test_cuda_head_dim_padding_is_exact(d):
    """The CUDA launchers pad the head dim to a multiple of 4 with zero
    codes and slice the output: the same codes as the unpadded call (here
    with the plain versions standing in for the kernels)."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.integers(-128, 128, s, dtype=np.int8))
               for s in ((9, 3, d), (9, 70, d), (9, 70, d)))
    s1 = torch.tensor(F32(2e-3))
    want = TA.acam_attention_contiguous_plain(
        q, k, v, s1, None, torch.full((9,), 70, dtype=torch.int32), False,
        "pot", None, 0, False, rsd=0.1)
    seen = []

    def plain(*args, **kw):
        seen.append(args[0].shape[-1])
        return TA.acam_attention_contiguous_plain(*args, **kw)
    got = TA._padded_to_4(plain, 3)(
        q, k, v, s1, None, torch.full((9,), 70, dtype=torch.int32), False,
        "pot", None, 0, False, rsd=0.1)
    assert seen == [-(-d // 4) * 4]
    assert got[0].shape == (9, 3, d)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    assert int(got[1]) == int(want[1])
    with pytest.raises(ValueError, match="up to 320"):
        TA._padded_to_4(plain, 3)(
            *(torch.zeros((1, 1, 324), dtype=torch.int8),) * 3)
