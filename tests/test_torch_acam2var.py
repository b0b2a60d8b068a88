"""The staged oracle's Compute-ACAM leftovers in the port, against the
reference: the two-variable compiler and its 4-bit multiply tables, the
match-line emulation (``hw=True``), the nibble-table fidelity of the
data-dependent matmuls and its plan slot.

Everything here is integer or table-driven, so everything is held bit for
bit (no tolerance):

* the 2-var truth tables, the greedy rectangle cover (rectangles in the
  reference's order), the padded `RectArrays`/`RangeArrays` and the cell
  counts the cost model reads, for `mult4_programs` (ss, su, uu),
  `mult4_paper` and random 8-bit 16x16 tables (tests/test_core_acam.py);
* `apply_codes(hw=True)` of every operator of `core.ops.OPS` on every input
  code: the reference's codes, and the LUT path's;
* `mult8_codes` over all 256 x 256 pairs, with ``hw`` False and True, equal
  to x * y; `dd_matmul_codes(fidelity="acam")` equal to ``"int"``;
* the staged `raceit_attention` with ``fidelity="acam"`` and with
  ``hw=True`` equal to the reference's outputs
  (tests/test_crossbar_softmax.py), and a staged prefill of a tiny model
  under ``matmul_fidelity="acam"`` equal to its ``"int"`` logits;
* `plan.explain()` under ``matmul_fidelity="acam"`` prints the reference's
  lines (the ``dd_matmul -> acam`` slot and the fused attention degrade).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ExecConfig  # noqa: E402
from repro.core import attention as RA  # noqa: E402
from repro.core import compiler as RCo  # noqa: E402
from repro.core import ops as RO  # noqa: E402
from repro.exec import resolve_plan as r_resolve  # noqa: E402
from repro_torch.core import acam as TAc  # noqa: E402
from repro_torch.core import attention as TA  # noqa: E402
from repro_torch.core import compiler as TCo  # noqa: E402
from repro_torch.core import ops as TO  # noqa: E402
from repro_torch.core import softmax as TS  # noqa: E402
from repro_torch.exec import resolve_plan as t_resolve  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402

from _torch_helpers import port_exec_config, port_model_config  # noqa: E402
from conftest import tiny_config  # noqa: E402

MODES = ("pot", "pot_fine", "uniform")


def _rects(prog):
    return [[(r.x_lo, r.x_hi, r.y_lo, r.y_hi) for r in bit]
            for bit in prog.rects]


def _assert_same_2var(t, r):
    """Table, rectangles (in order), padded arrays and costs."""
    np.testing.assert_array_equal(t.table, r.table)
    assert t.table.dtype == r.table.dtype
    assert _rects(t.program) == _rects(r.program)
    assert (t.program.out_bits, t.program.encoded) == (
        r.program.out_bits, r.program.encoded)
    assert t.program.cells_per_bit == r.program.cells_per_bit
    assert t.program.rows_needed() == r.program.rows_needed()
    assert dataclasses.asdict(t.cost) == dataclasses.asdict(r.cost)
    np.testing.assert_array_equal(t._lut, r._lut)
    for f in ("x_lo", "x_hi", "y_lo", "y_hi", "mask"):
        np.testing.assert_array_equal(getattr(t._hw, f), getattr(r._hw, f))


# ------------------------------------------------------------ compiler

@pytest.mark.parametrize("encode", [True, False])
def test_mult4_programs_equal_reference(encode):
    for t, r in zip(TO.mult4_programs(encode), RO.mult4_programs(encode)):
        assert t.name == r.name
        _assert_same_2var(t, r)


@pytest.mark.parametrize("encode", [False, True])
def test_mult4_paper_equals_reference(encode):
    t, r = TO.mult4_paper(encode), RO.mult4_paper(encode)
    _assert_same_2var(t, r)
    if not encode:  # Figure 7's counts, as the reference's test holds them
        for o, p in zip(t.program.cells_per_bit, [8, 21, 36, 58]):
            assert abs(o - p) <= 2


@pytest.mark.parametrize("encode", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_random_2var_tables(seed, encode):
    """Random 8-bit 16x16 tables: the same rectangles as the reference, and
    the rectangle program evaluates back to the table (numpy and tensors)."""
    table = np.random.default_rng(seed).integers(0, 256, (16, 16)
                                                 ).astype(np.uint32)
    t = TCo.compile_2var(table, 8, encode=encode)
    r = RCo.compile_2var(table, 8, encode=encode)
    assert _rects(t) == _rects(r)
    xi, yi = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    np.testing.assert_array_equal(TCo.eval_rect_program(t, xi, yi), table)
    arr = TAc.RectArrays.from_program(t)
    got = arr(torch.from_numpy(xi), torch.from_numpy(yi))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), table.astype(np.int32))


@pytest.mark.parametrize("name", RO.OPS)
def test_range_arrays_and_eval_equal_reference(name):
    t, r = TO.get_op(name), RO.get_op(name)
    for f in ("lo", "hi", "mask"):
        np.testing.assert_array_equal(getattr(t._hw, f), getattr(r._hw, f))
    assert (t._hw.out_bits, t._hw.encoded) == (r._hw.out_bits, r._hw.encoded)
    pos = np.arange(len(t.table))
    np.testing.assert_array_equal(TCo.eval_range_program(t.program, pos),
                                  RCo.eval_range_program(r.program, pos))
    np.testing.assert_array_equal(TCo.eval_range_program(t.program, pos),
                                  t.table)


def test_build_table_2var_equals_reference():
    for fn in (lambda x, y: x * y, lambda x, y: x - y,
               lambda x, y: np.maximum(x, y)):
        want = RCo.build_table_2var(fn, RO.int4s, RO.int4u, RO.int8s)
        got = TCo.build_table_2var(fn, TO.int4s, TO.int4u, TO.int8s)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


# ----------------------------------------------------- match-line emulation

@pytest.mark.parametrize("name", RO.OPS)
def test_apply_codes_hw_equals_reference_and_lut(name):
    """Every input code of every operator: the match lines give the
    reference's codes and the table's."""
    op = TO.get_op(name)
    lo = getattr(op.in_fmt, "code_min", 0)
    codes = np.arange(op.in_fmt.num_codes, dtype=np.int32) + lo
    want = np.asarray(RO.get_op(name).apply_codes(jnp.asarray(codes),
                                                  hw=True))
    hw = op.apply_codes(torch.from_numpy(codes), hw=True)
    lut = op.apply_codes(torch.from_numpy(codes), hw=False)
    np.testing.assert_array_equal(hw.numpy(), want)
    np.testing.assert_array_equal(hw.numpy(), lut.numpy())


@pytest.mark.parametrize("hw", [False, True])
def test_mult8_codes_exhaustive(hw):
    x = np.arange(-128, 128, dtype=np.int32)
    X, Y = np.meshgrid(x, x, indexing="ij")
    got = TO.mult8_codes(torch.from_numpy(X), torch.from_numpy(Y), hw=hw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), X * Y)


def test_mult8_codes_of_int8_inputs_equal_reference():
    """int8 codes (what the attention's quantizer gives), cast to int32
    before the nibble split, with the reference's match-line results."""
    rng = np.random.default_rng(3)
    a = rng.integers(-128, 128, (64,)).astype(np.int8)
    b = rng.integers(-128, 128, (64,)).astype(np.int8)
    want = np.asarray(RO.mult8_codes(jnp.asarray(a), jnp.asarray(b), hw=True))
    got = TO.mult8_codes(torch.from_numpy(a), torch.from_numpy(b), hw=True)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [((2, 3, 5, 16), (2, 3, 16, 7)),
                                   ((4, 16, 64), (64, 16))])
def test_dd_matmul_acam_equals_int(shape):
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.integers(-128, 128, shape[0]).astype(np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, shape[1]).astype(np.int8))
    want = TA.dd_matmul_codes(a, b, fidelity="int")
    got = TA.dd_matmul_codes(a, b, fidelity="acam")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        got.numpy(), a.numpy().astype(np.int64) @ b.numpy().astype(np.int64))


# ------------------------------------------------------ staged attention

def _qkv(seed, sq=5, sk=6, d=8):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, s, (1, 2, n, d)).astype(np.float32)
            for s, n in ((1.5, sq), (1.0, sk), (1.0, sk))]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("hw", [False, True])
@pytest.mark.parametrize("fidelity", ["int", "acam"])
def test_raceit_attention_fidelity_and_hw_equal_reference(fidelity, hw,
                                                          masked):
    q, k, v = _qkv(int(hw) + 2 * masked)
    mask = (np.tril(np.ones((5, 6), bool), 1)[None, None] if masked
            else None)
    want = np.asarray(RA.raceit_attention(
        *map(jnp.asarray, (q, k, v)),
        None if mask is None else jnp.asarray(mask),
        fidelity=fidelity, hw=hw))
    got = TA.raceit_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask),
        fidelity=fidelity, hw=hw)
    np.testing.assert_array_equal(got.numpy(), want)
    base = TA.raceit_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), base.numpy())


@pytest.mark.parametrize("mode", MODES)
def test_acam_softmax_hw_equals_lut(mode):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0, 3, (3, 40)).astype(np.float32))
    x[:, 0] = -16.0
    np.testing.assert_array_equal(TS.acam_softmax(x, mode=mode, hw=True).numpy(),
                                  TS.acam_softmax(x, mode=mode).numpy())


def test_fused_entry_still_refuses_acam_and_hw():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0))
    for kw, what in (({"fidelity": "acam"}, "fidelity"), ({"hw": True}, "hw")):
        with pytest.raises(ValueError, match=what):
            TA.raceit_attention(q, k, v, fused=True, **kw)
    assert TA.fused_attention_supported("acam") == \
        RA.fused_attention_supported("acam")
    assert TA.fused_attention_supported(hw=True) == \
        RA.fused_attention_supported(hw=True)


# ------------------------------------------------------------------ plan

@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", ["gpt2-large", "command-r-35b"])
def test_plan_explain_acam_fidelity(name, fused):
    cfg = tiny_config(get_config(name))
    ec = ExecConfig.serving(mode="raceit", fused_attention=fused,
                            matmul_fidelity="acam")
    want = r_resolve(cfg, ec).explain()
    plan = t_resolve(port_model_config(cfg), port_exec_config(ec))
    assert plan.explain().splitlines() == want.splitlines()
    assert plan.backend("dd_matmul") == "acam"
    assert "bit-identical to 'int', slow" in plan.explain()


def test_staged_prefill_acam_fidelity_equals_int():
    """A tiny model's staged prefill: the nibble tables through the plan's
    dd_matmul slot give the integer matmul's logits, bit for bit."""
    cfg = port_model_config(tiny_config(get_config("command-r-35b"))
                            ).replace(n_layers=1)
    out = []
    for fid in ("int", "acam"):
        ec = ExecConfig.serving(mode="raceit", fused_attention=False,
                                matmul_fidelity=fid)
        m = TModel(cfg, port_exec_config(ec), device="cpu")
        params = m.init(torch.Generator().manual_seed(0))
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, (1, 7)).astype(np.int32))
        logits, _ = m.prefill(params, tokens, m.init_cache(1, 16))
        out.append(logits)
    assert m.plan.backend("dd_matmul") == "acam"
    np.testing.assert_array_equal(out[0].numpy(), out[1].numpy())
