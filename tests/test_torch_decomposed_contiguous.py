"""The decompositions of the port's contiguous two-pass and one-tile
attention kernels, on the CPU, against the plain versions and the Pallas
kernel.

``csrc/acam_attention.cu`` (``contiguous_sums``/``contiguous_probv``) and
``csrc/acam_attention_single.cu`` (``single_tile``) cannot run here; what
they compute in their own order can. `contiguous_decomposed` and
`single_decomposed` below repeat it from the host plan: each span of a
group's keys (runs of its one key block, or whole key blocks) writes the
total of every run it owns that starts below the fill level, each run
added key by key; the finisher adds a key block's run totals in run order
from 0.0 and the block sums in block order from 0.0, and takes the row max
over the spans that start below the fill level; PROB . V is the sum of the
int32 partials of the spans. Unwritten run totals are NaN and unwritten
span maxima 1000, so a plan that leaves a run to no span, or a finisher
that reads past what was written, gives another result. Both must equal the
unchanged plain versions and the Pallas kernel (interpret mode) bit for
bit, for every split the plans can pick. The plans themselves are held at
the main path's shapes.
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.acam_attention import (  # noqa: E402
    acam_attention_codes as r_codes)
from repro_torch.kernels import acam_attention as TA  # noqa: E402

MODES = ("pot", "pot_fine", "uniform")
CODE_MIN, CODE_MAX = TA.LOGIT_FMT.code_min, TA.LOGIT_FMT.code_max


def _run_starts(bk):
    runs = TA.sum_chunks(bk)
    return runs, np.concatenate([[0], np.cumsum(runs)[:-1]]).tolist()


def _span_start(plan, bk, sp):
    """First key of span ``sp`` (acam_contiguous.cuh span_start)."""
    if plan.blocks > 1:
        return sp * plan.per * bk
    return _run_starts(bk)[1][sp * plan.per]


def contiguous_decomposed(q, k, v, s1, mask, lens, per_row, mode, cmax_floor,
                          q_offset, causal, plan=None):
    """The two-pass kernels' decomposition (see the module docstring).
    Arguments as `acam_attention_contiguous_plain`'s; ``plan`` defaults to
    the call's own `contiguous_plan`."""
    G, Sq, D = q.shape
    Sk = k.shape[1]
    bk = TA.key_block(Sk)
    plan = plan or TA.contiguous_plan(G, Sq, Sk, bk)
    exp_val, log_lut, prob_lut, e_min, step, fs = TA._device_tables(
        mode, q.device)
    runs, starts = _run_starts(bk)
    nb, nch = plan.blocks, plan.runs
    assert (nb, nch) == (-(-Sk // bk), len(runs))
    n_units = nch if nb == 1 else nb
    lens_l = [int(x) for x in lens]
    xc = TA._logit_codes(q, k, s1, mask, causal, q_offset)
    e = exp_val[(xc + 128).long()]

    # pass A: every span's run totals and LOGIT max, per group
    run_tot = torch.full((G, Sq, nb, nch), float("nan"))
    span_max = torch.full((G, Sq, plan.splits), 1000, dtype=torch.int32)
    spans = []
    for sp in range(plan.splits):
        u0, u1 = sp * plan.per, min((sp + 1) * plan.per, n_units)
        owned = ([(0, c) for c in range(u0, u1)] if nb == 1 else
                 [(j, c) for j in range(u0, u1) for c in range(nch)])
        ka = _span_start(plan, bk, sp)
        kb = Sk if u1 == n_units else _span_start(plan, bk, sp + 1)
        spans.append((ka, kb))
        for g in range(G):
            ke = min(kb, lens_l[g])
            if ka >= ke:
                continue  # a span wholly past the fill level: skipped
            for j, c in owned:
                a = j * bk + starts[c]
                if a >= ke:
                    continue
                tot = e[g, :, a]
                for t in range(a + 1, min(a + runs[c], ke)):
                    tot = tot + e[g, :, t]
                run_tot[g, :, j, c] = tot
            span_max[g, :, sp] = xc[g, :, ka:ke].amax(-1)

    # the finisher: run totals in run order, block sums in block order
    S = torch.zeros((G, Sq), dtype=torch.float32)
    xmax = torch.full((G, Sq), CODE_MIN, dtype=torch.int32)
    zero = torch.zeros((Sq,), dtype=torch.float32)
    for g in range(G):
        for j in range(nb):
            if j * bk >= lens_l[g]:
                break
            bs = zero
            for c in range(nch):
                live = j * bk + starts[c] < lens_l[g]
                bs = bs + (run_tot[g, :, j, c] if live else zero)
            S[g] = S[g] + bs
        for sp, (ka, _) in enumerate(spans):
            if ka >= lens_l[g]:
                break
            xmax[g] = torch.maximum(xmax[g], span_max[g, :, sp])
    L, cmax = TA._row_finish(S, xmax, lens, per_row, log_lut, prob_lut,
                             e_min, step, fs, cmax_floor)

    # pass B: the int32 PROB . V partials of the spans
    d = torch.clamp(xc - (L * (1 << fs))[..., None], CODE_MIN, CODE_MAX)
    pc = TA.requant_code_table(cmax, prob_lut)[(d + 128).long()].long()
    out = torch.zeros((G, Sq, D), dtype=torch.int64)
    for ka, kb in spans:
        for g in range(G):
            ke = min(kb, lens_l[g])
            if ka < ke:
                out[g] += pc[g, :, ka:ke] @ v[g, ka:ke].long()
    return out.to(torch.int32), cmax.to(torch.int32)


def single_decomposed(q, k, v, s1, mask, lens, per_row, mode, cmax_floor,
                      q_offset, causal, plan=None):
    """The one-tile kernel's decomposition: the same spans over the ``Skp``
    keys (``Skp == key_block(Sk)``, one key block), split by `single_plan`;
    one reduction over all ``Skp`` keys is that block's sum plus 0.0."""
    G, Sq, _ = q.shape
    assert TA.one_tile(G, Sq, k.shape[1])
    return contiguous_decomposed(
        q, k, v, s1, mask, lens, per_row, mode, cmax_floor, q_offset, causal,
        plan or TA.single_plan(G, Sq, k.shape[1]))


def _every_split(plan):
    """The plan with every other number of runs (or blocks) per span."""
    n = plan.runs if plan.blocks == 1 else plan.blocks
    for per in range(1, n + 1):
        yield dataclasses.replace(plan, per=per, splits=-(-n // per))


def _case(kind, Sk, mode, seed, G=10, heads=5, floor=None):
    """Operands of one call; ``kind`` is decode (scalar kv_len), lens
    (per-group lengths, zeros among them), causal (q_offset 0), causal9
    (q_offset 9), pad (a left-pad mask per batch row of ``heads`` groups,
    causal on top, as a bucket prefill), masked (a random mask with fully
    masked rows) or gqa (8 rows per group, per-group lengths)."""
    rng = np.random.default_rng(seed)
    Sq = {"decode": 1, "lens": 1, "gqa": 8, "causal": 6, "causal9": 6,
          "pad": 5, "masked": 7}[kind]
    D = 16
    q = rng.integers(-128, 128, (G, Sq, D), dtype=np.int8)
    k = rng.integers(-128, 128, (G, Sk, D), dtype=np.int8)
    v = rng.integers(-128, 128, (G, Sk, D), dtype=np.int8)
    # a few LOGIT units per key, so the row sums cross many PoT codes
    s1 = np.float32(rng.uniform(1e-3, 6e-3))
    c = dict(kind=kind, q=q, k=k, v=v, s1=s1, mode=mode, mask=None,
             mask_g=None, kv=None, q_offset=0, causal=False,
             floor=None if floor is None else np.int32(floor))
    if kind == "decode":
        c["kv"] = np.int32(rng.integers(1, Sk + 1))
    elif kind in ("lens", "gqa"):
        kv = rng.integers(1, Sk + 1, G).astype(np.int32)
        kv[[0, G // 2]] = 0
        kv[1] = Sk
        c["kv"] = kv
    elif kind in ("causal", "causal9"):
        c["causal"] = True
        c["q_offset"] = 0 if kind == "causal" else 9
    elif kind == "pad":
        pads = rng.integers(0, Sk // 2, G // heads)
        pads[0] = 0
        cols = np.arange(Sk)[None, None, :]
        m = (cols >= pads[:, None, None]) & (
            cols <= np.arange(Sq)[None, :, None] + (Sk - Sq))
        c["mask"] = m.astype(np.int8)                # one row per batch row
        c["mask_g"] = np.repeat(c["mask"], heads, 0)  # the reference's form
    else:  # masked: rows 0 and 3 see no key
        m = rng.random((G, Sq, Sk)) < 0.7
        m[:, [0, 3]] = False
        c["mask"] = c["mask_g"] = m.astype(np.int8)
    return c


def _pallas(c):
    m = c["mask_g"]
    out, cmax = r_codes(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.float32(c["s1"]), None if m is None else jnp.asarray(m),
        kv_len=None if c["kv"] is None else jnp.asarray(c["kv"]),
        mode=c["mode"], q_offset=c["q_offset"], causal=c["causal"],
        cmax_floor=None if c["floor"] is None else jnp.asarray(c["floor"]),
        interpret=True)
    return np.asarray(out), int(cmax)


def _port(c):
    """(wrapper's plain result, the decomposition's arguments)."""
    t = torch.from_numpy
    G, _, _ = c["q"].shape
    Sk = c["k"].shape[1]
    args = (t(c["q"]), t(c["k"]), t(c["v"]), torch.tensor(c["s1"]),
            None if c["mask"] is None else t(c["mask"]))
    kv = None if c["kv"] is None else torch.as_tensor(c["kv"])
    floor = None if c["floor"] is None else torch.tensor(c["floor"])
    got = TA.acam_attention_codes(*args, kv_len=kv, mode=c["mode"],
                                  cmax_floor=floor, q_offset=c["q_offset"],
                                  causal=c["causal"])
    per_row = kv is not None and kv.ndim == 1
    lens = torch.full((G,), Sk, dtype=torch.int32) if kv is None else \
        torch.clamp(kv.to(torch.int32), max=Sk).expand(G).contiguous()
    rest = (lens, per_row, c["mode"], floor, c["q_offset"], c["causal"])
    return got, args + rest


def _hold(c, single=False):
    """The plain versions and every split's decomposition equal the Pallas
    kernel; returns the output."""
    w_out, w_cmax = _pallas(c)
    (p_out, p_cmax), dargs = _port(c)
    assert int(p_cmax) == w_cmax
    np.testing.assert_array_equal(p_out.numpy(), w_out)
    G, Sq, _ = c["q"].shape
    Sk = c["k"].shape[1]
    plans = [(contiguous_decomposed, p) for p in _every_split(
        TA.contiguous_plan(G, Sq, Sk, TA.key_block(Sk)))]
    if single:
        plans += [(single_decomposed, p) for p in _every_split(
            TA.single_plan(G, Sq, Sk))]
    for fn, plan in plans:
        out, cmax = fn(*dargs, plan=plan)
        assert int(cmax) == w_cmax, (fn.__name__, plan)
        np.testing.assert_array_equal(out.numpy(), w_out,
                                      err_msg=f"{fn.__name__} {plan}")
    return w_out


KINDS = ("decode", "lens", "causal", "causal9", "pad", "masked")
SKS = (64, 300, 448, 512, 600, 1100)


@pytest.mark.parametrize(
    "kind,Sk,mode",
    [(kd, sk, MODES[(i + j) % 3]) for (i, kd), (j, sk) in
     itertools.product(enumerate(KINDS), enumerate(SKS))])
def test_contiguous_decomposition_every_split(kind, Sk, mode):
    """Runs of 32 and the split halves of Sk = 300 (22 + 32 * 8 + 22), one
    and several key blocks (600, 1100, the last padded), fill levels
    mid-run, masked keys in the row sum at the LOGIT minimum, zero-length
    groups, fully masked rows: every split of the two-pass kernels' plan
    equals the plain version and the Pallas kernel."""
    c = _case(kind, Sk, mode, seed=Sk * 7 + KINDS.index(kind))
    out = _hold(c)
    if kind in ("lens",):  # zero-length groups give zero rows
        assert not out[c["kv"] == 0].any()


@pytest.mark.parametrize("floor", [0, 90, 250])
def test_contiguous_decomposition_cmax_floor(floor):
    c = _case("lens", 300, "pot", seed=3, floor=floor)
    w_out, w_cmax = _pallas(c)
    assert w_cmax >= floor
    _hold(c)


@pytest.mark.parametrize("kind,G,Sk", [("gqa", 8, 512), ("gqa", 4, 300),
                                       ("decode", 1, 64), ("masked", 2, 300),
                                       ("causal9", 3, 200)])
@pytest.mark.parametrize("mode", MODES)
def test_single_decomposition_every_split(kind, G, Sk, mode):
    """The one-tile shapes (G <= 8, Sq <= 256, Sk <= 512): every split of
    `single_plan` and of `contiguous_plan` equals the plain one-tile version
    and the Pallas kernel (`_attn_kernel_single`)."""
    c = _case(kind, Sk, mode, seed=G * 100 + Sk, G=G, heads=G)
    assert TA.one_tile(G, c["q"].shape[1], Sk)
    _hold(c, single=True)


def test_single_decomposition_70_rows():
    """70 rows: two row tiles of the one-tile kernel, masked, Sk = 300."""
    rng = np.random.default_rng(70)
    c = _case("masked", 300, "pot_fine", seed=70, G=2, heads=2)
    c["q"] = rng.integers(-128, 128, (2, 70, 16), dtype=np.int8)
    m = rng.random((2, 70, 300)) < 0.5
    m[:, 69] = False
    c["mask"] = c["mask_g"] = m.astype(np.int8)
    _hold(c, single=True)


def test_contiguous_plan_main_path():
    """gpt2-large bucket decode (G 80, 512 keys) and prefill (G 80, Sq 448),
    command-r prefill (G 64, Sq 256): spans on run boundaries until the
    blocks fill the card 3 times over (4 asked, less what whole runs
    allow), spans of at least 8 runs past 16 rows a unit, codes pitch a
    multiple of 16 bytes."""
    for G, Sq, Sk, splits, per in ((80, 1, 512, 6, 3), (80, 448, 448, 2, 8),
                                   (64, 256, 256, 1, 8), (8, 70, 512, 2, 8)):
        plan = TA.contiguous_plan(G, Sq, Sk, TA.key_block(Sk))
        assert (plan.splits, plan.per) == (splits, per)
        assert plan.blocks == 1 and plan.runs == Sk // 32
        assert plan.units == G * -(-Sq // 64)
        assert plan.units * plan.splits >= 3 * 132 or plan.per == 8
        assert plan.psp % 16 == 0 and plan.psp >= Sk
    # several key blocks: a span is whole blocks
    plan = TA.contiguous_plan(4, 5, 1100, 512)
    assert (plan.blocks, plan.runs, plan.splits, plan.per, plan.psp) == \
        (3, 16, 3, 1, 1536)
    plan = TA.contiguous_plan(3, 1, 300, 300)
    assert (plan.runs, plan.splits, plan.per) == (10, 10, 1)


def test_single_plan_main_path():
    """command-r solo GQA decode (G 8, Sq 8, 512 keys): 8 spans of two
    runs, 64 CTAs; a 256-row prefill tile: 4 row tiles x 2 spans; never
    more than 64 CTAs (the cooperative launch needs them all resident)."""
    plan = TA.single_plan(8, 8, 512)
    assert (plan.units, plan.splits, plan.per) == (8, 8, 2)
    plan = TA.single_plan(8, 256, 512)
    assert (plan.units, plan.splits, plan.per) == (32, 2, 8)
    for G, Sq, Sk in itertools.product((1, 3, 8), (1, 8, 100, 256),
                                       (1, 64, 300, 512)):
        plan = TA.single_plan(G, Sq, Sk)
        assert plan.units * plan.splits <= 64
        assert plan.blocks == 1
