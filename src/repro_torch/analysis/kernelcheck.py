"""Kernel contract checker for the port's CUDA launches.

The port of `repro.analysis.kernelcheck`. The reference captures each
Pallas call's BlockSpec index maps and proves them over the grid; the
CUDA kernels have no index maps to capture, so this pass holds the host
plans (`paged_plan`, `contiguous_plan`, `single_plan` in
`repro_torch.kernels.acam_attention`) and a Python mirror of the index
math each block runs (``paged_slice`` in ``csrc/acam_attention.cu``,
``contiguous_slice`` and ``c_layout`` in ``csrc/acam_contiguous.cuh``)
over the serving domain, exhaustively:

KC101 — every split covers each page (paged) or each key run or key block
    (contiguous) exactly once, a key tile never crosses its page, the grid
    stays within CUDA's limits (x < 2^31, y < 2^16), and the cooperative
    one-tile launch stays co-resident (one CTA an SM, 132 SMs).
KC105 — every block-table column a block loads
    (``load_pages``, ``acam_attention.cu:175``) lies below ``max_pages``
    and at or below the row's live page frontier, and every key a
    contiguous block stages lies below the group's length.
KC106 — the dynamic shared memory of each layout (a mirror of
    ``smem_paged_sums``/``smem_paged_probv`` and ``c_layout``) stays
    within the per-block opt-in limit, 227 KiB (232,448 B). `chip_smoke.py`
    holds the mirror equal to the sources' own exports
    (``acam_attention_{paged,contiguous,single}_smem``) on the card.

The serving domain: the catalog's head counts (query heads for the flat
entry, KV heads for the GQA one, 1 to 8 slots), query rows 1 to 64, every
page size `_check_page_size` admits up to ``MAX_LEN`` (1 to 32, then
multiples of 32), every table width up to ``MAX_LEN / page_size``, and
every key count up to ``MAX_LEN`` for the contiguous layouts; the lengths
a block sees are taken at each split's edges, where the clamps turn.

The reference's BlockSpec rules have no CUDA counterpart of their own:
KC102 and KC103 (a dead key block re-fetched, or fetched at all) are
covered by KC105, since a CUDA block's loop stops at the live frontier and
loads no dead page; KC104 (an output map reading prefetched scalars)
becomes part of KC101, as each output row belongs to the one unit that
``blockIdx.x`` names; KC109 (a prefetched vector indexed out of bounds)
is KC101's grid check, since ``kv_len[g]`` and ``block_table[slot]`` are
indexed by the unit's group and slot.

KC110 — the paged operand prolog (``csrc/acam_prolog.cu``, its plan
    `repro_torch.kernels.acam_prolog.prolog_plan`): the max launch's blocks
    of a block-table entry read each live element of its page once and
    nothing past the live rows, its q blocks each element of q once; the
    quantise launch's blocks cover each page slab once and write each code
    of the page's ``KV x rep`` stripe rows once, inside the page's rows;
    vector steps stay inside a row; both grids within CUDA's limits.
    Over the catalog's (KV heads, head dim, rep) and every page size.

Concrete companions, ported directly: KC107 checks the paged write routing
(`models.layers.paged_write_targets_{chunk,decode}`) and KC108 drives
`serve.paged.PageAllocator` through alloc/free/promote/evict cycles, on
the reference's domains.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import pathlib
from typing import Callable, Optional

import numpy as np
import torch

from .findings import REPO_ROOT, Finding

SMEM_OPTIN = 232_448          # H100: 227 KiB of shared memory a block
SMS = 132                     # H100 SXM5 streaming multiprocessors
GRID_X, GRID_Y = 2 ** 31 - 1, 65_535
MAX_LEN = 512                 # longest sequence of the serving domain
K_RUN, K_RING, K_PROWS = 32, 4, 64           # csrc/acam_common.cuh, .cu
K_CROWS, K_CRING, K_CTILE, K_CMAXWARPS = 64, 4, 64, 8  # acam_contiguous.cuh


@functools.lru_cache(maxsize=None)
def _anchor(obj) -> tuple[str, int]:
    try:
        path = inspect.getsourcefile(obj)
        return (str(pathlib.Path(path).resolve().relative_to(REPO_ROOT)),
                inspect.getsourcelines(obj)[1])
    except (TypeError, OSError, ValueError):
        return "src/repro_torch/kernels/acam_attention.py", 0


def _catalog_heads() -> tuple[list, list, list]:
    """(query-head counts, KV-head counts, head dims) of the catalog's
    attention models."""
    from ..configs import get_config
    from ..configs.catalog import PORTED
    heads, kv, dims = set(), set(), set()
    for name in PORTED:
        cfg = get_config(name)
        if cfg.n_heads:
            heads.add(cfg.n_heads)
            kv.add(cfg.n_kv_heads)
            dims.add(cfg.resolved_head_dim)
    return sorted(heads), sorted(kv), sorted(dims)


def page_sizes(max_len: int = MAX_LEN) -> list:
    """Every page size `_check_page_size` admits up to ``max_len``."""
    return list(range(1, 33)) + list(range(64, max_len + 1, 32))


# ---------------------------------------------------------------------------
# mirrors of the CUDA index math
# ---------------------------------------------------------------------------

def paged_slice(plan, split: int, length: int, page_size: int):
    """(j0, j1): the logical pages split ``split`` of a row loads at
    ``length`` keys (``paged_slice``/``load_pages``)."""
    npages = -(-length // page_size)
    j0 = split * plan.pages_per_split
    return j0, min(j0 + plan.pages_per_split, npages)


def chunk_bounds(n: int, c: int) -> tuple[int, int]:
    """Run ``c`` of a key block of ``n`` keys (``chunk_bounds``)."""
    m, r = divmod(n, K_RUN)
    if m == 0:
        return 0, n
    if r == 0:
        return K_RUN * c, K_RUN * c + K_RUN
    head = (K_RUN + r + 1) // 2
    if c == 0:
        return 0, head
    a = head + K_RUN * (c - 1)
    return a, (n if c == m else a + K_RUN)


def contiguous_slice(plan, Sk: int, bk: int, split: int, length: int):
    """(ka, ke): the keys span ``split`` of a group stages at ``length``
    valid keys (``contiguous_slice``)."""
    n = plan.blocks if plan.blocks > 1 else plan.runs

    def start(s):
        return s * plan.per * bk if plan.blocks > 1 else chunk_bounds(
            bk, s * plan.per)[0]
    u1 = min(split * plan.per + plan.per, n)
    ka = start(split)
    ke = min(Sk if u1 == n else start(split + 1), length)
    return ka, ke


def smem_paged(pass_id: int, Sq: int, D: int, page_size: int, max_pages: int,
               masked: bool, pages_per_split: int, kt: int) -> int:
    """``smem_paged_sums`` (pass 0) / ``smem_paged_probv`` (pass 1)."""
    dp = (D + 31) & ~31
    rows = min(K_PROWS, (Sq + 15) // 16 * 16)
    if pass_id == 0:
        qs_b, ktp, ktm = dp + 16, (kt + 7) & ~7, (kt + 15) & ~15
        nrs = kt // min(kt, K_RUN)
        mvec = masked and ((page_size | kt | max_pages * page_size) & 3) == 0
        es = kt + kt // K_RUN + 1
        return (rows * qs_b + K_RING * ktp * qs_b
                + (K_RING * rows * ktm if mvec else 0) + rows * (ktm + 4)
                + 4 * (256 + rows * es + 2 * rows * nrs)
                + 4 * pages_per_split)
    ktq = (kt + 31) & ~31
    return (K_RING * rows * ktq + K_RING * ktq * dp + rows * (ktq + 16)
            + dp * (ktq + 16) + 4 * (256 + rows + pages_per_split))


def smem_contiguous(kind: int, Sq: int, Sk: int, D: int, bk: int,
                    masked: bool, per: int) -> int:
    """``c_layout(p, kind).total``: 0 pass A, 1 pass B, 2 the one-tile
    kernel."""
    dp = (D + 31) & ~31
    rows = ((Sq + 15) // 16 * 16) if Sq < K_CROWS else K_CROWS
    nb = -(-Sk // bk)
    xcap = bk if nb > 1 else min(per * K_RUN, bk)
    xs_b = (xcap + 15) // 16 * 16 + 4
    qs_b, pc_b = dp + 16, K_CTILE + 16
    at = 0
    if kind != 1:
        at += rows * qs_b + K_CRING * K_CTILE * qs_b
        at += K_CRING * rows * K_CTILE if masked else 0
        at += rows * xs_b + 4 * 256 + 4 * 512 + 4 * K_CMAXWARPS * rows
    else:
        at += K_CRING * rows * K_CTILE + K_CRING * K_CTILE * dp
    if kind != 0:
        at += rows * pc_b + dp * pc_b + 4 * 256 + 4 * rows
    return at


# ---------------------------------------------------------------------------
# plan checks
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Tally:
    plans: int = 0
    block_checks: int = 0
    # layout -> (bytes, the arguments of the source's *_smem export)
    smem: dict = dataclasses.field(default_factory=dict)


def _cover(findings, n: int, splits: int, per: int, site, where):
    """KC101: spans of ``per`` units cover ``n`` units exactly once."""
    if splits < 1 or per < 1 or (splits - 1) * per >= n or splits * per < n:
        findings.append(Finding(
            "kernelcheck", "KC101", *where, site,
            f"{splits} splits of {per} do not cover {n} units exactly once"))
        return False
    return True


def _lengths(lo: int, hi: int, Sk: int) -> list:
    """Lengths where a block's clamps turn for a block over keys [lo, hi):
    no keys, each edge and its neighbours, all keys."""
    out = {0, Sk}
    for e in (lo, hi):
        out.update(x for x in (e - 1, e, e + 1) if 0 <= x <= Sk)
    return sorted(out)


def check_paged_plan(G: int, Sq: int, D: int, max_pages: int, page_size: int,
                     masked: bool = False, plan=None,
                     slice_fn: Callable = paged_slice,
                     tally: Optional[_Tally] = None,
                     smem_cases=None) -> list[Finding]:
    """KC101/KC105/KC106 of one paged call (``plan``: the call's own);
    ``smem_cases``: the (Sq, masked) layouts to size, else the call's."""
    from ..kernels import acam_attention as A
    plan = plan or A.paged_plan(G, Sq, max_pages, page_size)
    tally = tally if tally is not None else _Tally()
    tally.plans += 1
    where = _anchor(A.paged_plan)
    site = f"paged G={G} Sq={Sq} D={D} ps={page_size} mp={max_pages}"
    f: list[Finding] = []
    if plan.units > GRID_X or plan.splits > GRID_Y:
        f.append(Finding("kernelcheck", "KC101", *where, site,
                         f"grid ({plan.units}, {plan.splits}) exceeds CUDA's "
                         f"limits"))
    kt = plan.key_tile
    if page_size % kt or kt > 64 or (kt > K_RUN and kt % K_RUN):
        f.append(Finding("kernelcheck", "KC101", *where, site,
                         f"key tile {kt} crosses a page of {page_size} keys"))
    if plan.psp < page_size or plan.psp % 16:
        f.append(Finding("kernelcheck", "KC101", *where, site,
                         f"code pitch {plan.psp} < page size {page_size}"))
    _cover(f, max_pages, plan.splits, plan.pages_per_split, site, where)
    Sk = max_pages * page_size
    per = plan.pages_per_split
    for s in range(plan.splits):
        for length in _lengths(s * per * page_size, (s + 1) * per * page_size,
                               Sk):
            tally.block_checks += 1
            frontier = -(-length // page_size) - 1   # last live page
            j0, j1 = slice_fn(plan, s, length, page_size)
            if j1 > j0 and (j1 - 1 > frontier or j1 > max_pages):
                f.append(Finding(
                    "kernelcheck", "KC105", *_anchor(slice_fn), site,
                    f"split {s} at length {length} loads table columns "
                    f"[{j0}, {j1}) past the live frontier {frontier} "
                    f"(table of {max_pages})"))
                return f
    for sq, m in smem_cases or ((Sq, masked),):
        for pass_id in (0, 1):
            mvec = m and ((page_size | kt | max_pages * page_size) & 3) == 0
            key = ("paged", pass_id, min(K_PROWS, (sq + 15) // 16 * 16), D,
                   mvec, plan.pages_per_split, kt)
            if key not in tally.smem:
                tally.smem[key] = (
                    smem_paged(pass_id, sq, D, page_size, max_pages, m,
                               plan.pages_per_split, kt),
                    (pass_id, G, sq, D, page_size, max_pages, int(m),
                     plan.splits, plan.pages_per_split, kt))
            if tally.smem[key][0] > SMEM_OPTIN:
                f.append(Finding(
                    "kernelcheck", "KC106", *where,
                    f"{site} Sq={sq} pass {pass_id}",
                    f"{tally.smem[key][0]} B of dynamic shared memory, over "
                    f"the {SMEM_OPTIN} B opt-in limit"))
    return f


def check_contiguous_plan(G: int, Sq: int, Sk: int, D: int,
                          masked: bool = False, plan=None, single=None,
                          tally: Optional[_Tally] = None,
                          smem_cases=None) -> list[Finding]:
    """KC101/KC105/KC106 of one contiguous or one-tile call;
    ``smem_cases``: the (Sq, masked) layouts to size, else the call's."""
    from ..kernels import acam_attention as A
    single = A.one_tile(G, Sq, Sk) if single is None else single
    bk = A.key_block(Sk)
    if plan is None:
        plan = (A.single_plan(G, Sq, Sk) if single
                else A.contiguous_plan(G, Sq, Sk, bk))
    tally = tally if tally is not None else _Tally()
    tally.plans += 1
    where = _anchor(A.single_plan if single else A.contiguous_plan)
    site = (f"{'single' if single else 'contiguous'} G={G} Sq={Sq} Sk={Sk} "
            f"D={D}")
    f: list[Finding] = []
    if plan.units > GRID_X or plan.splits > GRID_Y:
        f.append(Finding("kernelcheck", "KC101", *where, site,
                         f"grid ({plan.units}, {plan.splits}) exceeds CUDA's "
                         f"limits"))
    if single and plan.units * plan.splits > SMS:
        f.append(Finding("kernelcheck", "KC101", *where, site,
                         f"cooperative launch of {plan.units * plan.splits} "
                         f"CTAs is not co-resident on {SMS} SMs"))
    n = plan.blocks if plan.blocks > 1 else plan.runs
    _cover(f, n, plan.splits, plan.per, site, where)
    if not single and plan.psp < plan.blocks * bk:
        f.append(Finding("kernelcheck", "KC101", *where, site,
                         f"code pitch {plan.psp} < {plan.blocks * bk} keys"))
    prev = 0
    for s in range(plan.splits):
        ka, ke_all = contiguous_slice(plan, Sk, bk, s, Sk)
        if ka < prev or ka > plan.blocks * bk:
            f.append(Finding(
                "kernelcheck", "KC101", *_anchor(contiguous_slice), site,
                f"span {s} starts at key {ka}, before span {s - 1} or past "
                f"the {plan.blocks * bk} keys of its blocks"))
            return f
        prev = ka
        for length in _lengths(ka, ke_all, Sk):
            tally.block_checks += 1
            ka, ke = contiguous_slice(plan, Sk, bk, s, length)
            if ke > length:
                f.append(Finding(
                    "kernelcheck", "KC105", *_anchor(contiguous_slice), site,
                    f"span {s} at length {length} stages keys [{ka}, {ke}) "
                    f"past the group's {length} keys"))
                return f
    kinds = (2,) if single else (0, 1)
    for sq, m in smem_cases or ((Sq, masked),):
        for kind in kinds:
            nb = plan.blocks
            key = ("single" if single else "contiguous", kind,
                   (sq + 15) // 16, D, bk, nb > 1, m,
                   bk if nb > 1 else min(plan.per * K_RUN, bk))
            if key not in tally.smem:
                args = ((G, sq, Sk, D, bk, int(m), plan.splits, plan.per)
                        if single else (kind, G, sq, Sk, D, bk, int(m),
                                        plan.splits, plan.per, plan.psp))
                tally.smem[key] = (smem_contiguous(kind, sq, Sk, D, bk, m,
                                                   plan.per), args)
            if tally.smem[key][0] > SMEM_OPTIN:
                f.append(Finding(
                    "kernelcheck", "KC106", *where,
                    f"{site} Sq={sq} kind {kind}",
                    f"{tally.smem[key][0]} B of dynamic shared memory, over "
                    f"the {SMEM_OPTIN} B opt-in limit"))
    return f


def smem_probes(tally: _Tally) -> list:
    """(export, its arguments, the mirror's bytes) of every layout the plan
    checks met, for the chip check: ``acam_attention_paged_smem``,
    ``acam_attention_contiguous_smem`` or ``acam_attention_single_smem``."""
    names = {"paged": "acam_attention_paged_smem",
             "contiguous": "acam_attention_contiguous_smem",
             "single": "acam_attention_single_smem"}
    return [(names[key[0]], args, nbytes)
            for key, (nbytes, args) in sorted(tally.smem.items(), key=repr)]


def check_serving_plans(max_len: int = MAX_LEN) -> tuple[list, dict, _Tally]:
    """KC101/KC105/KC106 over the serving domain (see the module)."""
    from ..kernels import acam_attention as A
    heads, kv, dims = _catalog_heads()
    tally = _Tally()
    findings: list[Finding] = []
    groups = sorted({h * slots for h in set(heads) | set(kv)
                     for slots in range(1, 9)})
    Dmax = max(dims)
    # the plans depend on G and on Sq only through its row tiles (one up
    # to 64 rows): each distinct plan's splits are checked once, its shared
    # memory at every staged row count (Sq rounded up to 16) and with and
    # without a mask, at the widest head dim (the largest layout)
    rows = (1, 16, 17, 32, 33, 48, 49, 64)
    paged_cases = [(sq, m) for sq in (16, 32, 48, 64) for m in (False, True)]
    for ps in page_sizes(max_len):
        for mp in range(1, max_len // ps + 1):
            seen = set()
            for G in groups:
                plan = A.paged_plan(G, 1, mp, ps)
                # the blocks' index math reads the split, not the units
                if (plan.splits, plan.pages_per_split) not in seen:
                    seen.add((plan.splits, plan.pages_per_split))
                    findings += check_paged_plan(
                        G, 1, Dmax, mp, ps, plan=plan, tally=tally,
                        smem_cases=paged_cases)
    for Sk in range(1, max_len + 1):
        seen = set()
        for G in groups:
            for Sq in rows:
                single = A.one_tile(G, Sq, Sk)
                plan = (A.single_plan(G, Sq, Sk) if single else
                        A.contiguous_plan(G, Sq, Sk, A.key_block(Sk)))
                if (plan.splits, plan.per, single, Sq > 16) in seen:
                    continue
                seen.add((plan.splits, plan.per, single, Sq > 16))
                cases = [(sq, m) for sq in ((Sq,) if single else rows)
                         if (sq > 16) == (Sq > 16) for m in (False, True)]
                findings += check_contiguous_plan(
                    G, Sq, Sk, Dmax, plan=plan, single=single, tally=tally,
                    smem_cases=cases)
    cov = dict(max_len=max_len, page_sizes=len(page_sizes(max_len)),
               group_counts=len(groups), head_dim=Dmax, plans=tally.plans,
               block_checks=tally.block_checks,
               smem_layouts=len(tally.smem),
               smem_max=max(b for b, _ in tally.smem.values()))
    return findings, cov, tally


# ---------------------------------------------------------------------------
# the paged operand prolog (csrc/acam_prolog.cu)
# ---------------------------------------------------------------------------

def prolog_slab_span(plan, c: int, n: int) -> tuple[int, int]:
    """[lo, hi): the elements block ``c`` of a page takes of the first
    ``n`` of its slab (``prolog_max``: the live ones; ``prolog_quant``:
    all of them)."""
    lo = c * plan.chunk
    return lo, min(lo + plan.chunk, n)


def prolog_code_at(i: int, page: int, t: int, page_size: int, kv_heads: int,
                   head_dim: int, rep: int) -> int:
    """The code offset ``prolog_quant`` writes slab element ``i`` of
    ``page`` to, copy ``t`` of its KV head."""
    row = kv_heads * head_dim
    r, kvh, d = i // row, (i % row) // head_dim, i % head_dim
    return (((page * kv_heads + kvh) * rep + t) * page_size + r) * head_dim + d


def _spans_cover(spans, n: int) -> bool:
    """The non-empty [lo, hi) spans tile [0, n) in order."""
    at = 0
    for lo, hi in spans:
        if hi <= lo:
            continue
        if lo != at:
            return False
        at = hi
    return at == n


def check_prolog_plan(n_slots: int, max_pages: int, n_pages: int,
                      page_size: int, kv_heads: int, head_dim: int, n_q: int,
                      rep: int = 1, plan=None) -> list[Finding]:
    """KC110 of one prolog call (``plan``: the call's own)."""
    from ..kernels import acam_prolog as AP
    plan = plan or AP.prolog_plan(n_slots, max_pages, n_pages, page_size,
                                  kv_heads, head_dim, n_q)
    where = _anchor(AP.prolog_plan)
    site = (f"prolog ps={page_size} KV={kv_heads} hd={head_dim} rep={rep} "
            f"slots={n_slots} mp={max_pages} q={n_q}")
    f: list[Finding] = []

    def bad(msg):
        f.append(Finding("kernelcheck", "KC110", *where, site, msg))
        return f
    row = kv_heads * head_dim
    if plan.slab != page_size * row:
        return bad(f"slab {plan.slab} != page_size x KV x head_dim")
    if max(plan.grid_max, plan.grid_quant) > GRID_X or plan.slab >= 2 ** 31:
        return bad(f"grids ({plan.grid_max}, {plan.grid_quant}) or slab "
                   f"{plan.slab} exceed CUDA's limits")
    if plan.chunk % (4 * AP.PROLOG_THREADS):
        return bad(f"chunk {plan.chunk} is not a whole number of 4-element "
                   f"steps of {AP.PROLOG_THREADS} threads")
    pages_max = n_slots * max_pages * plan.slab_blocks
    if plan.grid_max != pages_max + plan.q_blocks or \
            plan.grid_quant != n_pages * plan.slab_blocks + plan.q_blocks:
        return bad("grids do not hold the page blocks and the q blocks")
    for live in sorted({0, 1, page_size // 2, page_size - 1, page_size}):
        n = live * row
        spans = [prolog_slab_span(plan, c, n)
                 for c in range(plan.slab_blocks)]
        if not _spans_cover(spans, n) or any(hi > n for _, hi in spans):
            return bad(f"max launch blocks do not read the {live} live rows "
                       f"once, or read past them")
    if not _spans_cover([prolog_slab_span(plan, c, n_q)
                         for c in range(plan.q_blocks)], n_q):
        return bad("q blocks do not cover q once")
    spans = [prolog_slab_span(plan, c, plan.slab)
             for c in range(plan.slab_blocks)]
    if not _spans_cover(spans, plan.slab):
        return bad("quantise launch blocks do not cover a slab once")
    if head_dim % 4 == 0 and any(lo % 4 for lo, _ in spans):
        return bad("a 4-element step crosses a row")
    page = n_pages - 1
    base, size = page * row * rep * page_size, row * rep * page_size
    probe = ([(i, t) for i in range(plan.slab) for t in range(rep)]
             if plan.slab * rep <= 1 << 11 else
             [(i, t) for lo, hi in spans for i in (lo, hi - 1)
              for t in {0, rep - 1}])
    at = [prolog_code_at(i, page, t, page_size, kv_heads, head_dim, rep)
          for i, t in probe]
    if any(not base <= a < base + size for a in at) or \
            len(set(at)) != len(at) or (len(at) == size and
                                        sorted(at)[-1] != base + size - 1):
        return bad("code offsets leave the page's stripe rows or repeat")
    return f


def _catalog_attention_shapes() -> list:
    """(KV heads, head dim, rep) of the catalog's attention models."""
    from ..configs import get_config
    from ..configs.catalog import PORTED
    out = set()
    for name in PORTED:
        cfg = get_config(name)
        if cfg.n_heads:
            out.add((cfg.n_kv_heads, cfg.resolved_head_dim,
                     cfg.n_heads // cfg.n_kv_heads))
    return sorted(out)


def check_prolog_plans(max_len: int = MAX_LEN) -> tuple[list, int]:
    """KC110 over the serving domain: the catalog's shapes, flat (rep
    copies) and GQA-native (one), every page size, 8 slots of ``max_len``
    keys, a decode call and a 64-row chunk. (findings, plans checked)"""
    f: list[Finding] = []
    n = 0
    for kv, hd, rep in _catalog_attention_shapes():
        for ps in page_sizes(max_len):
            mp = max_len // ps
            for rows in {rep, 1}:
                for sq in (1, 64):
                    n += 1
                    f += check_prolog_plan(8, mp, 1 + 8 * mp, ps, kv, hd,
                                           8 * kv * rep * sq * hd, rows)
    return f, n


# ---------------------------------------------------------------------------
# concrete serving-side probes: write fencing + allocator
# ---------------------------------------------------------------------------

def check_write_fence(route_chunk: Optional[Callable] = None,
                      route_decode: Optional[Callable] = None,
                      ) -> list[Finding]:
    """KC107: every paged cache write lands on the written token's own page
    or the trash page — exhaustively, including fills past table capacity."""
    from ..models import layers
    route_chunk = route_chunk or layers.paged_write_targets_chunk
    route_decode = route_decode or layers.paged_write_targets_decode
    findings: list[Finding] = []
    ps, mp, b_rows = 4, 2, 3
    cap = ps * mp
    bt = np.asarray([[3, 1], [5, 2], [4, 6]], np.int32)   # distinct, no 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))

    sq = 4
    path, line = _anchor(route_chunk)
    for l0 in range(0, cap + 3):
        for o0 in range(0, l0 + 1):
            lens = np.asarray([l0, cap, 0], np.int32)
            offs = np.asarray([o0, 0, 0], np.int32)
            pages, slot = (np.asarray(a) for a in route_chunk(
                t(bt), t(lens), t(offs), sq, ps))
            for b in range(b_rows):
                for j in range(sq):
                    col = int(offs[b]) + j
                    live = col < min(int(lens[b]), cap)
                    want_page = int(bt[b, col // ps]) if live else 0
                    want_slot = col % ps if live else None
                    if int(pages[b, j]) != want_page or (
                            live and int(slot[b, j]) != want_slot):
                        findings.append(Finding(
                            "kernelcheck", "KC107", path, line,
                            "write_fence:chunk",
                            f"lens={lens.tolist()} offs={offs.tolist()} "
                            f"row {b} token {j} (col {col}): wrote page "
                            f"{int(pages[b, j])} slot {int(slot[b, j])}, "
                            f"contract wants "
                            f"{'page %d slot %d' % (want_page, want_slot) if live else 'trash page 0'}"))
                        return findings
    path, line = _anchor(route_decode)
    for l0 in range(0, cap + 3):
        lens = np.asarray([l0, 1, cap + 2], np.int32)
        pages, slot = (np.asarray(a) for a in route_decode(t(bt), t(lens),
                                                           ps))
        for b in range(b_rows):
            lb = int(lens[b])
            live = 0 < lb <= cap
            pos = lb - 1
            want_page = int(bt[b, pos // ps]) if live else 0
            if int(pages[b]) != want_page or (
                    live and int(slot[b]) != pos % ps):
                findings.append(Finding(
                    "kernelcheck", "KC107", path, line,
                    "write_fence:decode",
                    f"lens={lens.tolist()} row {b}: wrote page "
                    f"{int(pages[b])} slot {int(slot[b])}, contract wants "
                    f"{'page %d slot %d' % (want_page, pos % ps) if live else 'trash page 0'}"))
                return findings
    return findings


def check_allocator(allocator_cls=None) -> list[Finding]:
    """KC108: PageAllocator never issues physical page 0 through any
    alloc/free/promote/evict/leak cycle."""
    from ..serve.paged import PageAllocator
    cls = allocator_cls or PageAllocator
    findings: list[Finding] = []
    path, line = _anchor(cls)

    def issue(pages):
        if pages and 0 in pages:
            findings.append(Finding(
                "kernelcheck", "KC108", path, line, "allocator",
                f"alloc() handed out the trash page: {pages}"))

    a = cls(8)
    p0 = a.alloc(0, 7) or []
    issue(p0)                       # exhaustion: every page but 0 issued
    assert a.alloc(1, 1) is None or issue(a.alloc(1, 1))
    a.free_slot(0)
    p1 = a.alloc(1, 3) or []
    issue(p1)
    if p1:
        a.promote(1, p1[0])         # slot-owned -> shared
        a.acquire(2, p1[0])
        a.release_refs(2)
        a.free_slot(1)
        a.evict_shared(p1[0])       # shared -> free again
    p2 = a.alloc(3, 7) or []
    issue(p2)
    a.leak_slot(3)
    a.assert_invariants()
    return findings


# ---------------------------------------------------------------------------
# entry point + contract report
# ---------------------------------------------------------------------------

def run(max_len: int = MAX_LEN) -> tuple[list[Finding], dict, str]:
    """(findings, coverage, kernel-contracts markdown)."""
    findings, cov, tally = check_serving_plans(max_len)
    prolog, cov["prolog_plans"] = check_prolog_plans(max_len)
    findings += prolog
    findings += check_write_fence()
    findings += check_allocator()
    return findings, cov, contracts_markdown(cov, tally)


def contracts_markdown(cov: dict, tally: _Tally) -> str:
    """The contract report of the CUDA launch plans (deterministic)."""
    by_layout: dict = {}
    for key, (nbytes, _) in tally.smem.items():
        name = f"{key[0]} {'pass ' + 'AB'[key[1]] if key[1] < 2 else 'one-tile'}"
        lo, hi = by_layout.get(name, (nbytes, nbytes))
        by_layout[name] = (min(lo, nbytes), max(hi, nbytes))
    out = [
        "# Kernel contracts of the CUDA launches",
        "",
        "Generated by `python -m repro_torch.analysis --write-contracts` — "
        "do not",
        "edit by hand. The host plans of the attention kernels and a mirror "
        "of",
        "their index math, checked over the serving domain: KC101 (splits "
        "cover",
        "every page or key run once, grid limits, co-residency), KC105 "
        "(columns",
        "and keys within the live frontier), KC106 (dynamic shared memory "
        "within",
        f"{SMEM_OPTIN} B).",
        "",
        "| layout | dynamic shared memory, least | most |",
        "|---|---|---|",
    ]
    for name in sorted(by_layout):
        lo, hi = by_layout[name]
        out.append(f"| {name} | {lo} B | {hi} B |")
    out += ["", "## Coverage", ""]
    for k in sorted(cov):
        out.append(f"- {k}: {cov[k]}")
    out.append("")
    return "\n".join(out)
