"""The paged attention entries' operand prolog (`repro_torch.kernels.ops`
`paged_operands_plain`, ``csrc/acam_prolog.cu``).

On the CPU: the plain version equals the composition the entries ran
before it, transcribed below (`page_valid_lengths`, `quantize_tensor` of
q, `page_quantize_tensor` of the pool read as float32, then the stripe row
layout), bit for bit in codes, scales and amaxes, over rep 1, 4 and 6 in
the flat and GQA-native layouts, float32 and bfloat16 pools, stale data in
freed pages and in the trash page, a slot with no keys, a page two slots
share, and NaN and Inf in live and dead rows. `page_valid_lengths` returns
what it did; the host plan's blocks cover each slab once; `operands`
brings q and the pools to what the kernels take or refuses them; the
tracer counts which prolog each call took; an op counter on ``meta`` takes
the kernels' two launches.

On the card (marker ``cuda``): the kernels' codes and scales equal the
plain version's on the same card on gpt2-large's pool (513 pages, 32 slots,
a decode call and a 256-row chunk) and on GQA pools, every case above
included, and on float16, mixed and strided operands; a paged decode call
and a chunk call give the torch prolog's outputs bit for bit; and the
prolog syncs nothing. The file imports
neither JAX nor the reference, so the card's machine runs it as
``PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_paged_prolog.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)  # one thread a worker, as tests/_torch_helpers.py

from repro_torch import trace  # noqa: E402
from repro_torch.core.quant import quantize_tensor  # noqa: E402
from repro_torch.kernels import acam_prolog as P  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402



@pytest.fixture
def on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc to build the kernels; "
                    "the card's machine runs it")


def card(test):
    """Marker ``cuda``: the kernels run only on the card (no interpret
    mode); skipped, inside the test, where there is none."""
    return pytest.mark.cuda(pytest.mark.usefixtures("on_card")(test))


# ---------------------------------------------------------------- the cases
def _page_valid_lengths_before(block_table, kv_len, n_pages, page_size):
    """`page_valid_lengths` as it was, the trash page zeroed from a host
    scalar."""
    bt = block_table.long()
    kvl = kv_len.to(torch.int32)
    j = torch.arange(bt.shape[1], dtype=torch.int32, device=bt.device)
    live = torch.clamp(kvl[:, None] - j * page_size, 0, page_size)
    pv = torch.zeros((n_pages,), dtype=torch.int32, device=bt.device)
    pv = pv.scatter_reduce(0, bt.reshape(-1), live.reshape(-1), reduce="amax")
    pv[0] = 0
    return pv


def _composition_before(q, k_pool, v_pool, block_table, kv_len, rep):
    """The paged entries' prolog as they ran it: the layer widened the pool
    to float32, `_paged_quantize_operands` quantized, `to_rows` laid the
    codes out (``rep`` copies of a KV head: H / KV flat, 1 GQA-native)."""
    k_pool, v_pool = k_pool.float(), v_pool.float()
    n_pages, ps, KV, hd = k_pool.shape
    pv = _page_valid_lengths_before(block_table, kv_len, n_pages, ps)
    qq = quantize_tensor(q, bits=8)
    kq = ops.page_quantize_tensor(k_pool, pv)
    vq = ops.page_quantize_tensor(v_pool, pv)

    def to_rows(c):
        if rep > 1:
            c = torch.repeat_interleave(c, rep, dim=2)
        return c.transpose(1, 2).reshape(n_pages * KV * rep, ps, hd
                                         ).contiguous()
    B, H, Sq, D = q.shape
    return ((qq.codes.reshape(B * H, Sq, D).contiguous(), qq.scale, qq.amax),
            (to_rows(kq.codes), kq.scale, kq.amax),
            (to_rows(vq.codes), vq.scale, vq.amax))


KINDS = ("stale", "empty_shared", "nonfinite_live", "nonfinite_dead")


def pool_case(seed, kind, *, n_slots=3, max_pages=4, ps=8, KV=2, hd=16,
              rep=4, sq=1, dtype=torch.float32, lens=None, device="cpu"):
    """q (B, H, Sq, hd) as the serving layer passes it (a (B, Sq, H, hd)
    tensor transposed), a pool whose freed pages, dead rows and trash page
    hold stale values (+-1e4), a shuffled block table and the lengths.

    ``empty_shared``: slot 0 holds no keys but names pages, slots 1 and 2
    share their first page (the prefix cache; slot 2 reads part of it).
    ``nonfinite_live``/``_dead``: NaN and Inf in K and V rows that are
    live, or in dead rows of named pages and in a freed page."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + n_slots * max_pages + 3  # three pages no slot names
    cap = max_pages * ps
    if lens is None:
        lens = rng.integers(1, cap + 1, n_slots)
        if kind == "empty_shared":
            lens[0] = 0
            lens[1] = max(lens[1], ps + 1)
    lens = np.asarray(lens, np.int64)
    lens[-1] = cap - 3  # the last slot's last page has dead rows
    pk = rng.choice((-1e4, 1e4), (n_pages, ps, KV, hd))
    pv = rng.choice((-1e4, 1e4), (n_pages, ps, KV, hd))
    order = list(rng.permutation(np.arange(1, n_pages)))
    bt = np.zeros((n_slots, max_pages), np.int64)
    for b, ln in enumerate(lens):
        named = -(-int(ln) // ps) if ln else 2  # an empty slot names pages
        for j in range(named):
            bt[b, j] = order.pop()
    if kind == "empty_shared" and n_slots >= 3:
        bt[2, 0] = bt[1, 0]
        lens[2] = max(int(lens[2]), 3)
    for b, ln in enumerate(lens):
        for j in range(-(-int(ln) // ps)):
            lv = min(ps, int(ln) - j * ps)
            pk[bt[b, j], :lv] = rng.normal(0, 1.5, (lv, KV, hd))
            pv[bt[b, j], :lv] = rng.normal(0, 1.5, (lv, KV, hd))
    H = KV * rep
    q = rng.normal(0, 1.5, (n_slots, sq, H, hd))
    live_page = int(bt[n_slots - 1, 0])
    dead_page = int(bt[n_slots - 1, -(-int(lens[-1]) // ps) - 1])
    if kind == "nonfinite_live":
        pk[live_page, 0, 0, 1] = np.nan
        pv[live_page, 1, KV - 1, 0] = np.inf
        pk[live_page, 1, 0, 2] = -np.inf
    if kind == "nonfinite_dead":
        pk[dead_page, ps - 1, 0, 0] = np.nan      # past the slot's length
        pv[dead_page, ps - 2, KV - 1, 3] = np.inf
        pk[order[0], 0, 0, 0] = np.nan            # a page no slot names
        pv[0, 0, 0, 0] = -np.inf                  # the trash page
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    qh = t(q, torch.float32).transpose(1, 2)
    return (qh, t(pk, dtype).contiguous(), t(pv, dtype).contiguous(),
            t(bt, torch.int32), t(lens, torch.int32))


def _bits_equal(a, b):
    """Equal bit for bit; a NaN equals any NaN (its payload may differ)."""
    a, b = a.cpu(), b.cpu()
    if a.dtype.is_floating_point:
        both_nan = torch.isnan(a) & torch.isnan(b)
        return bool(torch.all(both_nan | (a.view(torch.int32)
                                          == b.view(torch.int32))))
    return torch.equal(a, b)


def _named_rows(codes, bt, n_pages, groups):
    """The code rows of the pages the block table names (the kernels leave
    the other pages' rows unwritten)."""
    named = torch.unique(bt.long().reshape(-1)).to(codes.device)
    return codes.reshape(n_pages, groups, *codes.shape[1:])[named]


# ------------------------------------------------------------ CPU: the plain
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["flat", "gqa"])
@pytest.mark.parametrize("rep", [1, 4, 6])
def test_plain_equals_the_composition_before(rep, layout, dtype, kind):
    q, pk, pv, bt, lens = pool_case(100 * rep + KINDS.index(kind), kind,
                                    rep=rep, dtype=dtype)
    rows = rep if layout == "flat" else 1
    want = _composition_before(q, pk, pv, bt, lens, rows)
    got = ops.paged_operands_plain(q, pk, pv, bt, lens, rows)
    B, H, Sq, D = q.shape
    assert got[0].codes.shape == (B, H, Sq, D) and got[0].codes.is_contiguous()
    for g, (codes, scale, amax) in zip(got, want):
        assert torch.equal(g.codes.reshape(codes.shape), codes)
        assert g.codes.dtype == torch.int8
        assert _bits_equal(g.scale, scale) and _bits_equal(g.amax, amax)
    if kind == "nonfinite_live":
        assert torch.isnan(got[1].scale) and torch.isinf(got[2].scale)
    if kind == "nonfinite_dead":
        assert torch.isfinite(got[1].scale) and torch.isfinite(got[2].scale)


@pytest.mark.parametrize("kind", KINDS)
def test_page_valid_lengths_as_before(kind):
    q, pk, _, bt, lens = pool_case(7 + KINDS.index(kind), kind)
    bt = bt.clone()
    bt[0, -1] = 0  # the trash page named where a slot has live rows
    lens = lens.clone()
    lens[0] = bt.shape[1] * pk.shape[1]
    for n_pages in (pk.shape[0], pk.shape[0] + 5):
        got = ops.page_valid_lengths(bt, lens, n_pages, pk.shape[1])
        want = _page_valid_lengths_before(bt, lens, n_pages, pk.shape[1])
        assert got.dtype == torch.int32 and torch.equal(got, want)
        assert int(got[0]) == 0


@pytest.mark.parametrize("sq,layout", [(1, "flat"), (1, "gqa"), (5, "flat")])
def test_entries_count_the_plain_prolog_by_layer(sq, layout):
    q, pk, pv, bt, lens = pool_case(3, "stale", sq=sq, rep=2)
    fn = (ops.raceit_attention_decode_gqa_paged if layout == "gqa"
          else ops.raceit_attention_decode_paged)
    with trace.tracing():
        with trace.span("model.layer", layer=5):
            fn(q, pk, pv, lens, bt, fold_scale=True)
        fn(q, pk, pv, lens, bt, fold_scale=True)
        counters = trace.snapshot()["counters"]
    assert counters == {"attn.prolog_plain": {5: 1, None: 1}}
    fn(q, pk, pv, lens, bt, fold_scale=True)  # off: nothing counted
    assert trace.snapshot()["counters"] == counters


def test_meta_counts_the_two_launches():
    from repro_torch.launch.op_analysis import analyze_ops
    n_slots, mp, ps, KV, hd, rep, sq = 32, 16, 64, 20, 64, 1, 256
    n_pages = 1 + n_slots * mp
    m = lambda shape, dt=torch.float32: torch.empty(shape, dtype=dt,
                                                    device="meta")
    q = m((n_slots, sq, KV * rep, hd)).transpose(1, 2)
    pk, pv = m((n_pages, ps, KV, hd)), m((n_pages, ps, KV, hd))
    bt, lens = m((n_slots, mp), torch.int32), m((n_slots,), torch.int32)
    c, (qq, kq, vq) = analyze_ops(ops._paged_operands, q, pk, pv, bt, lens,
                                  rep)
    want = cost.paged_prolog(q.numel(), n_slots, mp, n_pages, ps, KV * hd,
                             rep, 4)
    assert [x.name for x in c.launches] == ["acam_prolog.A", "acam_prolog.B"]
    assert c.memory_bytes == sum(x.nbytes for x in want)
    named = n_pages - 1
    assert want[0].nbytes == (4 * q.numel() + 2 * named * ps * KV * hd * 4
                              + 4 * n_slots * mp + 4 * n_slots)
    assert want[1].nbytes == q.numel() + 2 * n_pages * ps * KV * hd
    assert kq.codes.shape == (n_pages * KV, ps, hd)
    assert qq.codes.shape == (n_slots, KV, sq, hd)


@pytest.mark.parametrize("ps,KV,hd", [(64, 20, 64), (16, 8, 128), (8, 2, 36),
                                      (1, 1, 4), (32, 40, 320)])
def test_plan_blocks_cover_each_slab_once(ps, KV, hd):
    import dataclasses

    from repro_torch.analysis import kernelcheck as KC
    for rep in (1, 6):
        assert KC.check_prolog_plan(3, 5, 20, ps, KV, hd, 1000, rep) == []
    plan = P.prolog_plan(3, 5, 20, ps, KV, hd, 1000)
    short = dataclasses.replace(plan, q_blocks=plan.q_blocks - 1,
                                grid_max=plan.grid_max - 1,
                                grid_quant=plan.grid_quant - 1)
    for bad in (short, dataclasses.replace(plan, chunk=plan.chunk + 4)):
        assert [x.rule for x in KC.check_prolog_plan(
            3, 5, 20, ps, KV, hd, 1000, plan=bad)] == ["KC110"]


@pytest.mark.parametrize("case", ["f32", "bf16", "f16", "mixed", "strided"])
def test_operands_as_the_kernels_take_them(case):
    """Pools of another dtype (or of two) widen to float32, strided
    operands become contiguous, and what the kernels take passes as is."""
    q, pk, pv, _, _ = pool_case(13, "stale", dtype=torch.float32)
    if case in ("bf16", "f16"):
        dt = torch.bfloat16 if case == "bf16" else torch.float16
        pk, pv = pk.to(dt), pv.to(dt)
    if case == "mixed":
        pk = pk.to(torch.bfloat16)
    if case == "strided":
        pk = pk.transpose(1, 2).contiguous().transpose(1, 2)
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    q2, k2, v2 = P.operands(q, pk, pv)
    want = torch.bfloat16 if case == "bf16" else torch.float32
    assert k2.dtype == v2.dtype == want
    assert k2.is_contiguous() and v2.is_contiguous() and q2.stride(3) == 1
    assert torch.equal(k2.float(), pk.float())
    assert torch.equal(v2.float(), pv.float()) and torch.equal(q2, q)
    if case in ("f32", "bf16"):
        assert k2 is pk and v2 is pv and q2 is q


@pytest.mark.parametrize("bad", ["q_bf16", "q_f16", "head_dim", "pools"])
def test_operands_refuses_what_the_plain_version_reads_otherwise(bad):
    q, pk, pv, _, _ = pool_case(14, "stale")
    err = TypeError if bad.startswith("q_") else ValueError
    if bad.startswith("q_"):
        q = q.to(torch.bfloat16 if bad == "q_bf16" else torch.float16)
    if bad == "head_dim":
        q = q[..., :-1]
    if bad == "pools":
        pv = pv[:-1]
    with pytest.raises(err):
        P.operands(q, pk, pv)


# ------------------------------------------------------------ the card
def _run_both(case, rep_rows):
    q, pk, pv, bt, lens = case
    n_pages = pk.shape[0]
    fused = ops._paged_operands(q, pk, pv, bt, lens, rep_rows)
    plain = ops.paged_operands_plain(q, pk, pv, bt, lens, rep_rows)
    groups = pk.shape[2] * rep_rows
    assert torch.equal(fused[0].codes, plain[0].codes)
    for i, (f, p) in enumerate(zip(fused, plain)):
        assert _bits_equal(f.scale, p.scale) and _bits_equal(f.amax, p.amax)
        if i:
            assert torch.equal(_named_rows(f.codes, bt, n_pages, groups),
                               _named_rows(p.codes, bt, n_pages, groups))
    return fused, plain


GPT2L = dict(n_slots=32, max_pages=16, ps=64, KV=20, hd=64, rep=1)


@card
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sq", [1, 256])
def test_card_gpt2_large_pool(sq, kind):
    rng = np.random.default_rng(1)
    lens = rng.integers(32, 1024, GPT2L["n_slots"])
    if kind == "empty_shared":
        lens[0] = 0
    case = pool_case(41, kind, sq=sq, lens=lens, device="cuda", **GPT2L)
    assert case[1].shape[0] == 1 + 32 * 16 + 3
    P.launches["acam_prolog"] = 0
    _run_both(case, 1)
    assert P.launches["acam_prolog"] == 2


@card
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout,rep,KV,hd", [
    ("flat", 6, 8, 128), ("gqa", 6, 8, 128), ("flat", 4, 2, 16),
    ("gqa", 4, 2, 16), ("flat", 1, 4, 36), ("flat", 2, 2, 18)])
def test_card_gqa_pools(layout, rep, KV, hd, dtype, kind):
    case = pool_case(5 + rep, kind, n_slots=8, max_pages=16, ps=64, KV=KV,
                     hd=hd, rep=rep, dtype=dtype, device="cuda")
    _run_both(case, rep if layout == "flat" else 1)


@card
@pytest.mark.parametrize("sq,layout", [(1, "flat"), (1, "gqa"),
                                       (256, "flat")])
def test_card_entries_bit_equal_to_the_torch_prolog(monkeypatch, sq, layout):
    kw = dict(GPT2L) if layout == "flat" else dict(
        n_slots=8, max_pages=16, ps=64, KV=8, hd=128, rep=6)
    lens = np.random.default_rng(2).integers(32, 1024, kw["n_slots"])
    q, pk, pv, bt, lens = pool_case(17, "stale", sq=sq, lens=lens,
                                    device="cuda", **kw)
    mask = None
    if sq > 1:  # the chunk call's intra-chunk causal rule
        offs = torch.clamp(lens - sq, min=0).long()
        cols = torch.arange(bt.shape[1] * kw["ps"], device="cuda")
        mask = cols[None, None, :] <= (offs[:, None, None] + torch.arange(
            sq, device="cuda")[None, :, None])
    fn = (ops.raceit_attention_decode_gqa_paged if layout == "gqa"
          else ops.raceit_attention_decode_paged)
    with trace.tracing():
        got = fn(q, pk, pv, lens, bt, mask=mask, fold_scale=True)
        counters = trace.snapshot()["counters"]
    assert counters == {"attn.prolog_fused": {None: 1}}
    # the same entry on the same card with the torch prolog in its place
    monkeypatch.setattr(ops, "_paged_operands", ops.paged_operands_plain)
    want = fn(q, pk, pv, lens, bt, mask=mask, fold_scale=True)
    assert _bits_equal(got, want)


@card
@pytest.mark.parametrize("case", ["f16", "mixed", "strided"])
def test_card_other_operands_take_the_kernels(case):
    """A float16 pool, pools of two dtypes and strided operands still run
    the kernels (widened, made contiguous) and equal the plain version."""
    q, pk, pv, bt, lens = pool_case(19, "nonfinite_live", device="cuda",
                                    n_slots=8, max_pages=16, ps=64, KV=8,
                                    hd=128, rep=6)
    if case == "f16":
        pk, pv = pk.half(), pv.half()
    if case == "mixed":
        pk = pk.to(torch.bfloat16)
    if case == "strided":
        pk = pk.transpose(1, 2).contiguous().transpose(1, 2)
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    P.launches["acam_prolog"] = 0
    _run_both((q, pk, pv, bt, lens), 6)
    assert P.launches["acam_prolog"] == 2


@card
def test_card_refuses_half_q():
    q, pk, pv, bt, lens = pool_case(21, "stale", device="cuda")
    with pytest.raises(TypeError):
        ops._paged_operands(q.half(), pk, pv, bt, lens, 4)


@card
def test_card_prolog_syncs_nothing():
    q, pk, pv, bt, lens = pool_case(9, "stale", sq=1, device="cuda",
                                    **GPT2L)
    for _ in range(2):  # the first call builds the library and its workspace
        ops._paged_operands(q, pk, pv, bt, lens, 1)
        ops.raceit_attention_decode_paged(q, pk, pv, lens, bt,
                                          fold_scale=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops._paged_operands(q, pk, pv, bt, lens, 1)
        ops.page_valid_lengths(bt, lens, pk.shape[0], pk.shape[1])
        ops.raceit_attention_decode_paged(q, pk, pv, lens, bt,
                                          fold_scale=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@card
def test_card_workspace_is_left_zeroed():
    q, pk, pv, bt, lens = pool_case(11, "empty_shared", device="cuda")
    ops._paged_operands(q, pk, pv, bt, lens, 4)
    ws = P._WORKSPACE[q.device]
    assert int(ws.count_nonzero()) == 0
