"""The decompositions of the port's tensor-core MVM and paged attention
kernels, on the CPU, against the plain versions and the Pallas kernels.

``csrc/acam_mvm.cu`` and the paged kernels of ``csrc/acam_attention.cu``
cannot run here; what they compute in another order can. `mvm_decomposed`
and `paged_decomposed` below repeat each kernel's arithmetic in its own
decomposition (the host plan's padded layouts and split of K; the per-page
row sums added in page order from 0.0 and the int32 PROB . V partials of
each split of the pages), and must equal the plain versions and the Pallas
kernels (interpret mode) bit for bit, for every split the host plan can
pick. The plans themselves are held at the main path's shapes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import crossbar as RC  # noqa: E402
from repro.kernels import ops as R  # noqa: E402
from repro.kernels.acam_attention import acam_attention_codes as r_codes  # noqa: E402
from repro_torch.core import crossbar as TC  # noqa: E402
from repro_torch.core.quant import pot_encode, ref_sum  # noqa: E402
from repro_torch.kernels import acam_attention as TA  # noqa: E402
from repro_torch.kernels import acam_mvm as TM  # noqa: E402

MODES = ("pot", "pot_fine", "uniform")


def _tcfg(cfg):
    return TC.CrossbarConfig(**{f: getattr(cfg, f)
                                for f in cfg.__dataclass_fields__})


def _pallas_mvm(x, w, cfg, bk=None):
    return np.asarray(R.acam_mvm(jnp.asarray(x), jnp.asarray(w), cfg,
                                 bk=bk, interpret=True))


def mvm_decomposed(x, w, cfg, bk=None, plan=None):
    """The MVM kernel's decomposition: the padded operands of
    `mvm_operands` cut into the plan's K splits, each split's product with
    one ADC tile per stage and its row and column sums over the split's
    whole K (`sliced_matmul`), the partials added modulo 2^32 with K*ox*ow
    once."""
    bk = bk or cfg.rows
    M, K = x.shape
    N = w.shape[1]
    quantize = TC.adc_step(cfg, cfg.rows) is not None
    plan = plan or TM.mvm_plan(M, N, K, bk, quantize)
    xp, wp = TM.mvm_operands(x, w, cfg, plan)
    # exact: each split's product is its raw-code product (the offsets
    # cancel); quantize: each adds (its K rows) * ox * ow, K's is added once
    oxow = (1 << (cfg.input_bits - 1)) * (1 << (cfg.weight_bits - 1))
    out = torch.full((M, N), K * oxow if quantize else 0, dtype=torch.int64)
    rows = plan.stages_per_split * plan.kstage
    for a in range(0, plan.kp, rows):
        part = TC.sliced_matmul(xp[:, a:a + rows], wp[a:a + rows, :N], cfg,
                                plan.kstage).long()
        kc = min(rows, plan.kp - a)
        out += part - kc * oxow if quantize else part
    return ((out + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def _page_sums(e, page_size):
    """(..., n_pages) row sums of (..., n_pages * page_size) exp values as
    the paged kernel forms them: runs of min(32, page_size) keys added key
    by key, the run totals of a page added in order (in `sum_chunks` groups
    past 32 runs, the group totals then in order)."""
    lead = e.shape[:-1]
    n_pages = e.shape[-1] // page_size
    rl = min(32, page_size)
    runs = e.reshape(*lead, n_pages, page_size // rl, rl)
    tot = runs[..., 0]
    for c in range(1, rl):
        tot = tot + runs[..., c]
    page = None
    start = 0
    for n in TA.sum_chunks(tot.shape[-1]):
        grp = tot[..., start]
        for c in range(start + 1, start + n):
            grp = grp + tot[..., c]
        page = grp if page is None else page + grp
        start += n
    return page


def paged_decomposed(q, k, v, s1, mask, kv_len, mode, block_table, page_size,
                     gps, cmax_floor=None, plan=None):
    """The paged kernels' decomposition: each page's row sums in the
    kernel's run order (`_page_sums`) added in page order from 0.0, and the
    int32 PROB . V partials of each split of ``plan`` (the call's own by
    default) added. Arguments as `acam_attention_codes_plain`'s."""
    G, Sq, _ = q.shape
    mp = block_table.shape[1]
    sk = mp * page_size
    plan = plan or TA.paged_plan(G, Sq, mp, page_size)
    g = torch.arange(G)
    rows = block_table.long()[g // gps] * gps + (g % gps)[:, None]
    kg, vg = (t[rows].reshape(G, sk, -1) for t in (k, v))
    exp_val, log_lut, prob_lut, e_min, step, fs = TA._device_tables(
        mode, q.device)
    lens = kv_len.to(torch.int32)
    xc = TA._logit_codes(q, kg, s1, mask, False, 0)
    valid = torch.arange(sk)[None, None, :] < lens[:, None, None]
    e = torch.where(valid, exp_val[(xc + 128).long()], torch.zeros(()))
    pages = _page_sums(e, page_size)
    S = torch.zeros((G, Sq), dtype=torch.float32)
    for j in range(mp):
        S = S + pages[..., j]
    code_min, code_max = TA.LOGIT_FMT.code_min, TA.LOGIT_FMT.code_max
    xmax = torch.where(valid, xc, torch.full_like(xc, code_min)).amax(-1)
    L, cmax = TA._row_finish(S, xmax, lens, True, log_lut, prob_lut, e_min,
                             step, fs, cmax_floor)
    d = torch.clamp(xc - (L * (1 << fs))[..., None], code_min, code_max)
    pc = TA.requant_code_table(cmax, prob_lut)[(d + 128).long()]
    pc = torch.where(valid, pc, torch.zeros_like(pc)).double()
    span = plan.pages_per_split * page_size
    out = 0
    for a in range(0, sk, span):
        out = out + torch.bmm(pc[..., a:a + span],
                              vg[:, a:a + span].double()).long()
    return out.to(torch.int32), cmax.to(torch.int32)


def _splits(plan, n_stages):
    """Every plan with the same stages and another split of them."""
    for per in range(1, n_stages + 1):
        yield dataclasses.replace(plan, splits=-(-n_stages // per),
                                  stages_per_split=per)


# ----------------------------------------------------------------- MVM

@pytest.mark.parametrize("fill", ["min", "max", "random"])
@pytest.mark.parametrize("bk", [64, 128])
def test_mvm_exact_is_the_raw_code_product(fill, bk):
    """The offsets cancel modulo 2^32: the exact ADC's result is int32
    x @ w of the raw codes, with extreme codes and K not a multiple of bk."""
    rng = np.random.default_rng(11)
    m, k, n = 9, 300, 40
    if fill == "random":
        x = rng.integers(-128, 128, (m, k)).astype(np.int8)
        w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    else:
        c = -128 if fill == "min" else 127
        x, w = np.full((m, k), c, np.int8), np.full((k, n), c, np.int8)
    want = (x.astype(np.int64) @ w.astype(np.int64) + 2 ** 31) % 2 ** 32 \
        - 2 ** 31
    cfg = RC.CrossbarConfig()
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    plain = TM.acam_mvm_plain(tx, tw, _tcfg(cfg), bk).numpy()
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(_pallas_mvm(x, w, cfg, bk), want)
    np.testing.assert_array_equal(
        mvm_decomposed(tx, tw, _tcfg(cfg), bk).numpy(), want)


@pytest.mark.parametrize("cfg", [
    RC.CrossbarConfig(),
    RC.CrossbarConfig(adc_mode="quantize"),
    RC.CrossbarConfig(adc_mode="quantize", adc_bits=6),
    RC.CrossbarConfig(adc_mode="quantize", adc_bits=4, cell_bits=1,
                      dac_bits=3),
], ids=["exact", "adc8", "adc6", "adc4-cell1-dac3"])
@pytest.mark.parametrize("mkn_bk", [(8, 256, 32, 128), (17, 300, 40, 64),
                                    (33, 200, 70, 100), (5, 130, 130, 36)])
def test_mvm_decomposition_every_split(cfg, mkn_bk):
    """Padded stages, corrections over the whole K of a split, split-K
    partials added modulo 2^32: equal to the plain version and the Pallas
    kernel for every split of the stages."""
    m, k, n, bk = mkn_bk
    rng = np.random.default_rng(m * 1000 + k)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    want = _pallas_mvm(x, w, cfg, bk)
    tx, tw, tc = torch.from_numpy(x), torch.from_numpy(w), _tcfg(cfg)
    np.testing.assert_array_equal(TM.acam_mvm_plain(tx, tw, tc, bk).numpy(),
                                  want)
    plan = TM.mvm_plan(m, n, k, bk, TC.adc_step(tc, tc.rows) is not None)
    for p in _splits(plan, plan.n_stages):
        np.testing.assert_array_equal(
            mvm_decomposed(tx, tw, tc, bk, p).numpy(), want)


def test_mvm_plan_main_path():
    """gpt2-large's fc1, fc2 and decode fc1: no copy of the operands, K
    split until the blocks fill the card, stages of 64 (exact) or bk."""
    for (m, k, n), quantize in (((512, 1280, 5120), False),
                                ((512, 5120, 1280), False),
                                ((8, 1280, 5120), False),
                                ((512, 1280, 5120), True),
                                ((512, 5120, 1280), True),
                                ((8, 1280, 5120), True)):
        plan = TM.mvm_plan(m, n, k, 128, quantize)
        bm, bn = TM.MVM_TILES[(quantize, m <= 16)]
        blocks = -(-m // bm) * -(-n // bn) * plan.splits
        # quantize: 32 blocks per SM; exact: one wave, split only below it
        assert blocks >= (32 * 132 if quantize else 132) \
            or plan.splits == plan.n_stages
        assert plan.kstage == (128 if quantize else 64)
        assert (plan.splits - 1) * plan.stages_per_split < plan.n_stages \
            <= plan.splits * plan.stages_per_split
        x = torch.zeros((m, k), dtype=torch.int8)
        w = torch.zeros((k, n), dtype=torch.int8)
        xp, wp = TM.mvm_operands(x, w, TC.CrossbarConfig(), plan)
        assert xp.data_ptr() == x.data_ptr() and wp.data_ptr() == w.data_ptr()


def test_mvm_operands_pad_to_zero_offset_codes():
    """A quantizing stage of bk = 36 rows is padded to 64 with the code
    whose offset-encoded value is 0; exact padding is 0; w's columns are
    padded to a multiple of 16."""
    cfg = TC.CrossbarConfig(adc_mode="quantize", input_bits=6)
    x = torch.ones((3, 100), dtype=torch.int8)
    w = torch.ones((100, 20), dtype=torch.int8)
    plan = TM.mvm_plan(3, 20, 100, 36, True)
    assert (plan.kstage, plan.n_stages, plan.kp, plan.ldw) == (64, 3, 192, 32)
    xp, wp = TM.mvm_operands(x, w, cfg, plan)
    assert xp.shape == (3, 192) and wp.shape == (192, 32)
    # stage 2 holds rows 72..99 at columns 128..155
    assert (xp[:, 36:64] == -32).all() and (xp[:, 156:] == -32).all()
    assert (wp[36:64, :20] == -128).all() and (wp[:, 20:] == 0).all()
    assert int(xp.to(torch.int64).sum()) == 3 * (100 + (192 - 100) * -32)
    plan = TM.mvm_plan(3, 20, 100, 36, False)
    xp, wp = TM.mvm_operands(x, w, cfg, plan)
    assert xp.shape == (3, 128) and int(xp.sum()) == 300


# ------------------------------------------------------- paged attention

PS, MP, N_SLOTS = 8, 4, 3


def _paged_case(kind, mode, seed, floor=None, ps=PS, mp=MP):
    """Slot 0 is zero-length; shuffled pages, page 0 the trash page; slot 2
    ends mid-page."""
    rng = np.random.default_rng(seed)
    gps, sq, d = {"flat": (4, 1, 16), "gqa": (2, 8, 32),
                  "chunk": (4, 5, 16)}[kind]
    G = N_SLOTS * gps
    n_pages = 1 + N_SLOTS * mp
    bt = rng.permutation(np.arange(1, n_pages))[: N_SLOTS * mp].reshape(
        N_SLOTS, mp).astype(np.int32)
    lens = np.array([0, rng.integers(1, mp * ps + 1), mp * ps - 3], np.int32)
    q = rng.integers(-128, 128, (G, sq, d), dtype=np.int8)
    k = rng.integers(-128, 128, (n_pages * gps, ps, d), dtype=np.int8)
    v = rng.integers(-128, 128, (n_pages * gps, ps, d), dtype=np.int8)
    s1 = np.float32(rng.uniform(2e-4, 3e-3))
    mask = None
    if kind == "chunk":  # query j of slot b attends columns <= offs[b] + j
        offs = np.maximum(lens - sq, 0)
        cols = np.arange(mp * ps)[None, None, :]
        m = cols <= (offs[:, None, None] + np.arange(sq)[None, :, None])
        mask = np.repeat(m, gps, axis=0)
    return dict(q=q, k=k, v=v, s1=s1, mask=mask, kv=np.repeat(lens, gps),
                bt=bt, gps=gps, mode=mode, ps=ps,
                floor=None if floor is None else np.int32(floor))


def _torch_args(c):
    t = torch.from_numpy
    return ((t(c["q"]), t(c["k"]), t(c["v"]), torch.tensor(c["s1"]),
             None if c["mask"] is None else t(c["mask"]).to(torch.int8),
             t(c["kv"]), c["mode"], t(c["bt"]), c["ps"], c["gps"]),
            None if c["floor"] is None else torch.tensor(c["floor"]))


def _pallas_paged(c):
    out, cmax = r_codes(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.float32(c["s1"]),
        None if c["mask"] is None else jnp.asarray(c["mask"]),
        kv_len=jnp.asarray(c["kv"]), mode=c["mode"],
        block_table=jnp.asarray(c["bt"]), page_size=c["ps"],
        groups_per_slot=c["gps"],
        cmax_floor=None if c["floor"] is None else jnp.asarray(c["floor"]),
        interpret=True)
    return np.asarray(out), int(cmax)


@pytest.mark.parametrize("kind", ["flat", "gqa", "chunk"])
@pytest.mark.parametrize("mode", MODES)
def test_paged_decomposition_every_split(kind, mode):
    """Page sums in page order from 0.0 and P.V partials summed per split,
    for every split of the pages the plan can pick: equal to the plain
    version and the Pallas kernel, the zero-length slot's rows zero."""
    c = _paged_case(kind, mode, seed=7 + MODES.index(mode))
    w_out, w_cmax = _pallas_paged(c)
    args, floor = _torch_args(c)
    p_out, p_cmax = TA.acam_attention_codes_plain(*args, floor)
    assert int(p_cmax) == w_cmax
    np.testing.assert_array_equal(p_out.numpy(), w_out)
    G, Sq = c["q"].shape[:2]
    base = TA.paged_plan(G, Sq, MP, PS)
    for per in range(1, MP + 1):
        plan = dataclasses.replace(base, splits=-(-MP // per),
                                   pages_per_split=per)
        out, cmax = paged_decomposed(*args, floor, plan=plan)
        assert int(cmax) == w_cmax
        np.testing.assert_array_equal(out.numpy(), w_out)
    assert not w_out[: c["gps"]].any()


@pytest.mark.parametrize("floor", [0, 90, 250])
def test_paged_decomposition_cmax_floor(floor):
    c = _paged_case("gqa", "pot", seed=3, floor=floor)
    w_out, w_cmax = _pallas_paged(c)
    args, fl = _torch_args(c)
    out, cmax = paged_decomposed(*args, fl)
    assert int(cmax) == w_cmax == max(w_cmax, floor)
    np.testing.assert_array_equal(out.numpy(), w_out)


@pytest.mark.parametrize("ps", [32, 64, 96, 1056, 2048])
def test_paged_decomposition_run_pages(ps):
    """Pages of one, two, three, 33 and 64 runs of 32 keys (key tiles of 32
    or 64; past 32 runs the run totals add in `sum_chunks` groups) against
    the Pallas kernel, the last slot ending mid-page."""
    c = _paged_case("flat", "pot_fine", seed=ps, ps=ps, mp=3 if ps < 1024
                    else 2)
    w_out, w_cmax = _pallas_paged(c)
    args, floor = _torch_args(c)
    p_out, p_cmax = TA.acam_attention_codes_plain(*args, floor)
    assert int(p_cmax) == w_cmax
    np.testing.assert_array_equal(p_out.numpy(), w_out)
    out, cmax = paged_decomposed(*args, floor)
    assert int(cmax) == w_cmax
    np.testing.assert_array_equal(out.numpy(), w_out)


# LOGIT codes of a page of 2048 keys (64 runs, two `sum_chunks` groups of
# 32 run totals): (i * 37) % 80 - 60 with these (key, code) overrides. Its
# pot_fine exp values added in the reference's order and run total by run
# total give row sums on two sides of a LOG(S) step (found by a search
# over single-key changes); chip_smoke.py holds the same page
ORDER_PAGES = {
    2048: ((0, -45), (26, -54), (46, -21), (67, -128), (147, -128),
           (227, -128), (307, -128), (387, -128), (467, -128), (547, -128),
           (627, -128), (707, -128), (787, -128), (867, 3)),
}


def _order_codes(ps):
    x = np.arange(ps) * 37 % 80 - 60
    for i, c in ORDER_PAGES[ps]:
        x[i] = c
    return x.astype(np.int8)


def _serial_page_sum(e):
    """Runs of 32 keys added key by key, then the run totals one by one."""
    runs = e.reshape(*e.shape[:-1], -1, 32)
    tot = runs[..., 0]
    for c in range(1, 32):
        tot = tot + runs[..., c]
    s = tot[..., 0]
    for c in range(1, tot.shape[-1]):
        s = s + tot[..., c]
    return s


@pytest.mark.parametrize("ps", sorted(ORDER_PAGES))
def test_paged_run_total_order_reaches_the_output(ps):
    """One page of 64 runs whose row sum lands on a LOG(S) step: only the
    reference's order of the run totals (`sum_chunks` groups) gives the
    Pallas kernel's result, and the plain version and the decomposition
    give it; the run totals added one by one would not."""
    codes = _order_codes(ps)
    exp_val, log_lut, _, e_min, step, _ = TA.softmax_tables("pot_fine")
    e = torch.from_numpy(exp_val)[torch.from_numpy(codes).long() + 128][None]
    log_of = lambda S: int(log_lut[int(pot_encode(S, e_min, step)[0])])
    assert log_of(ref_sum(e)) != log_of(_serial_page_sum(e))
    rng = np.random.default_rng(ps)
    d = 16
    q = np.zeros((1, 1, d), np.int8)
    q[0, 0, 0] = 1  # q . k = the key's first code: LOGIT code at s1 = 1/8
    k = rng.integers(-128, 128, (3, ps, d), dtype=np.int8)
    k[1, :, 0] = codes
    v = rng.integers(-128, 128, (3, ps, d), dtype=np.int8)
    c = dict(q=q, k=k, v=v, s1=np.float32(0.125), mask=None,
             kv=np.array([ps], np.int32), bt=np.array([[1, 2]], np.int32),
             gps=1, mode="pot_fine", ps=ps, floor=None)
    w_out, w_cmax = _pallas_paged(c)
    args, floor = _torch_args(c)
    p_out, p_cmax = TA.acam_attention_codes_plain(*args, floor)
    assert int(p_cmax) == w_cmax
    np.testing.assert_array_equal(p_out.numpy(), w_out)
    out, cmax = paged_decomposed(*args, floor)
    assert int(cmax) == w_cmax
    np.testing.assert_array_equal(out.numpy(), w_out)


def test_pot_encode_one_float_below_a_step_follows_the_jitted_graph():
    """S = 1327.9620361328125 (the sum of a 1056-key page found by the
    same search) is the last float below the pot_fine step at y = 137.5
    (y = 137.4999928 exactly): the port encodes 138, as the reference's
    jitted graph and exact arithmetic do. The reference evaluated op by op
    gives 139, and so did the Pallas kernel in interpret mode on that page
    (ROADMAP section 3), which is why no 1056-key page is held above."""
    import jax
    from repro.kernels.acam_attention import _pot_encode_sum
    S = np.float32(1327.9620361328125)
    y = (np.log2(np.float64(S)) + 24.0) / 0.25
    assert 137.49999 < y < 137.5
    jitted = jax.jit(lambda s: _pot_encode_sum(s, -24.0, 0.25))
    assert int(pot_encode(torch.tensor([S]), -24.0, 0.25)[0]) == \
        int(jitted(jnp.asarray([S]))[0]) == 138


@pytest.mark.parametrize("ps", [5, 8, 32, 64, 96, 1024, 1056, 2048])
def test_page_sums_follow_the_reference_order(ps):
    """The kernel's page sum (runs key by key, run totals in order, in
    `sum_chunks` groups past 32 runs) is the reference's sum of a page."""
    rng = np.random.default_rng(ps)
    e = torch.from_numpy(rng.exponential(1.0, (3, 2 * ps)).astype(
        np.float32) * np.float32(2.0) ** rng.integers(-20, 4, (3, 2 * ps)))
    got = _page_sums(e, ps)
    want = torch.stack([ref_sum(e[:, j * ps:(j + 1) * ps]) for j in (0, 1)],
                       -1)
    assert torch.equal(got, want)


def test_paged_plan_main_path():
    """gpt2-large decode and chunk (G 160, 16 pages of 64) and command-r
    GQA decode (G 64, Sq 8): enough blocks for the card, key tiles of 64,
    code pages of 64 bytes."""
    for G, Sq in ((160, 1), (160, 64), (64, 8)):
        plan = TA.paged_plan(G, Sq, 16, 64)
        assert plan.row_tiles == 1 and plan.units == G
        assert plan.units * plan.splits >= 3 * 132  # the card 3 times over
        assert (plan.splits - 1) * plan.pages_per_split < 16 \
            <= plan.splits * plan.pages_per_split
        assert (plan.key_tile, plan.psp) == (64, 64)
    plan = TA.paged_plan(2, 200, 3, 96)
    assert (plan.row_tiles, plan.units, plan.key_tile, plan.psp) == \
        (4, 8, 32, 96)
    assert TA.paged_plan(4, 1, 5, 7).psp == 16
