"""Truth-table -> Compute-ACAM range/rectangle compiler (paper Sections III & V).

The port of `repro.core.compiler` (numpy only), kept in the port so that it
imports nothing of the reference package. For a 1-variable function each
output bit's match line stores the runs of 1s of the value-ordered truth
table; for a 2-variable function each cell stores an axis-aligned rectangle
of the 2-D input grid, and the compiler covers the 1s of each bit plane with
greedy maximal rectangles (overlap is allowed: the match line is an OR).
The greedy cover's seed order (a raster scan) and growth orders are the
reference's, so the rectangles, and the cell counts the cost model reads,
are the same. Gray-coded output halves the runs (Section V-A), and arrays
are sized per Section V-B (4x8 arrays, 16 per group).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .gray import gray_decode, gray_encode
from .quant import FixedPointFormat

__all__ = ["RangeProgram", "Rect", "RectProgram", "ArrayCost",
           "build_table_2var", "compile_1var", "compile_2var",
           "eval_range_program", "eval_rect_program", "array_cost",
           "ACAM_ARRAY_ROWS", "ACAM_ARRAY_COLS", "ACAM_ARRAYS_PER_GROUP"]

# Section V-B design point: 4x8 arrays, 16 arrays per group.
ACAM_ARRAY_ROWS = 4
ACAM_ARRAY_COLS = 8
ACAM_ARRAYS_PER_GROUP = 16


def build_table_2var(
    fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    x_fmt: FixedPointFormat,
    y_fmt: FixedPointFormat,
    out_fmt: FixedPointFormat,
) -> np.ndarray:
    """2-D truth table (value order on both axes) of unsigned output patterns."""
    X = x_fmt.decode(x_fmt.all_codes_value_order())[:, None]
    Y = y_fmt.decode(y_fmt.all_codes_value_order())[None, :]
    Z = np.asarray(fn(X, Y), dtype=np.float64)
    return out_fmt.to_bits(out_fmt.encode(Z))


@dataclasses.dataclass
class RangeProgram:
    """Per-output-bit list of half-open [lo, hi) ranges in value-position space."""

    ranges: list[list[tuple[int, int]]]  # [bit][k] -> (lo, hi), MSB first
    out_bits: int
    encoded: bool  # True if ranges were compiled against Gray-coded output

    @property
    def num_cells(self) -> int:
        return sum(len(r) for r in self.ranges)

    @property
    def cells_per_bit(self) -> list[int]:
        return [len(r) for r in self.ranges]

    def rows_needed(self, array_cols: int = ACAM_ARRAY_COLS) -> int:
        """ML rows after splitting each bit's ranges across array_cols-wide rows.

        Rows of the same bit in different arrays are OR-wired together through
        the shared global ML pull-down (Figure 10(c))."""
        return sum(max(1, -(-len(r) // array_cols)) for r in self.ranges)


def _runs_of_ones(bits: np.ndarray) -> list[tuple[int, int]]:
    """Half-open [lo, hi) index ranges where bits==1."""
    padded = np.concatenate([[0], bits.astype(np.int8), [0]])
    diff = np.diff(padded)
    starts = np.nonzero(diff == 1)[0]
    ends = np.nonzero(diff == -1)[0]
    return list(zip(starts.tolist(), ends.tolist()))


def compile_1var(table: np.ndarray, out_bits: int, encode: bool = True) -> RangeProgram:
    """Compile a value-ordered table of unsigned output patterns into ranges."""
    tab = gray_encode(table) if encode else table
    ranges = []
    for bit in range(out_bits - 1, -1, -1):  # MSB first
        plane = (tab >> bit) & 1
        ranges.append(_runs_of_ones(plane))
    return RangeProgram(ranges=ranges, out_bits=out_bits, encoded=encode)


def eval_range_program(prog: RangeProgram, positions: np.ndarray) -> np.ndarray:
    """Hardware-semantics evaluation: OR of range matches per bit -> pattern.

    `positions` are value-order indices (the analog input). Returns the
    *unsigned binary* output pattern (Gray-decoded if the program is encoded),
    so it must equal the original truth table exactly.
    """
    positions = np.asarray(positions)
    out = np.zeros(positions.shape, dtype=np.uint32)
    for i, bit_ranges in enumerate(prog.ranges):
        bit = prog.out_bits - 1 - i
        match = np.zeros(positions.shape, dtype=bool)
        for lo, hi in bit_ranges:
            match |= (positions >= lo) & (positions < hi)
        out |= match.astype(np.uint32) << bit
    if prog.encoded:
        out = gray_decode(out, prog.out_bits)
    return out


# --------------------------------------------------------------------------
# 2-variable compilation: greedy maximal-rectangle cover (Figure 7 / 9(b)).
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Rect:
    x_lo: int
    x_hi: int  # half open
    y_lo: int
    y_hi: int

    def contains(self, x, y):
        return (x >= self.x_lo) & (x < self.x_hi) & (y >= self.y_lo) & (y < self.y_hi)


@dataclasses.dataclass
class RectProgram:
    rects: list[list[Rect]]  # [bit][k], MSB first
    out_bits: int
    encoded: bool

    @property
    def num_cells(self) -> int:
        return sum(len(r) for r in self.rects)

    @property
    def cells_per_bit(self) -> list[int]:
        return [len(r) for r in self.rects]

    def rows_needed(self, array_cols: int = ACAM_ARRAY_COLS) -> int:
        return sum(max(1, -(-len(r) // array_cols)) for r in self.rects)


def _max_rect_from(plane: np.ndarray, covered: np.ndarray, i: int, j: int) -> Rect:
    """Grow a maximal all-ones rectangle from seed (i, j); two growth orders,
    keep the one covering more currently-uncovered ones (the first on a tie)."""
    H, W = plane.shape

    def grow(row_first: bool) -> Rect:
        x_lo, x_hi, y_lo, y_hi = i, i + 1, j, j + 1
        dirs = ["down", "up", "right", "left"]
        if not row_first:
            dirs = ["right", "left", "down", "up"]
        for d in dirs:
            while True:
                if d == "down" and x_hi < H and plane[x_hi, y_lo:y_hi].all():
                    x_hi += 1
                elif d == "up" and x_lo > 0 and plane[x_lo - 1, y_lo:y_hi].all():
                    x_lo -= 1
                elif d == "right" and y_hi < W and plane[x_lo:x_hi, y_hi].all():
                    y_hi += 1
                elif d == "left" and y_lo > 0 and plane[x_lo:x_hi, y_lo - 1].all():
                    y_lo -= 1
                else:
                    break
        return Rect(x_lo, x_hi, y_lo, y_hi)

    best, best_gain = None, -1
    for rf in (True, False):
        r = grow(rf)
        gain = int((~covered[r.x_lo : r.x_hi, r.y_lo : r.y_hi]).sum())
        if gain > best_gain:
            best, best_gain = r, gain
    return best


def _cover_plane(plane: np.ndarray) -> list[Rect]:
    """Greedy cover of the 1-cells of `plane` with maximal rectangles."""
    covered = np.zeros_like(plane, dtype=bool)
    rects: list[Rect] = []
    # seed order: raster scan; rectangles may overlap (ML is an OR)
    for i, j in np.argwhere(plane):
        if covered[i, j]:
            continue
        r = _max_rect_from(plane, covered, int(i), int(j))
        covered[r.x_lo : r.x_hi, r.y_lo : r.y_hi] = True
        rects.append(r)
    return rects


def compile_2var(table2d: np.ndarray, out_bits: int, encode: bool = True) -> RectProgram:
    tab = gray_encode(table2d) if encode else table2d
    rects = []
    for bit in range(out_bits - 1, -1, -1):  # MSB first
        plane = ((tab >> bit) & 1).astype(bool)
        rects.append(_cover_plane(plane))
    return RectProgram(rects=rects, out_bits=out_bits, encoded=encode)


def eval_rect_program(prog: RectProgram, xi: np.ndarray, yi: np.ndarray) -> np.ndarray:
    """`eval_range_program` for rectangles over (x, y) value positions."""
    xi, yi = np.asarray(xi), np.asarray(yi)
    out = np.zeros(np.broadcast(xi, yi).shape, dtype=np.uint32)
    for i, bit_rects in enumerate(prog.rects):
        bit = prog.out_bits - 1 - i
        match = np.zeros(out.shape, dtype=bool)
        for r in bit_rects:
            match |= r.contains(xi, yi)
        out |= match.astype(np.uint32) << bit
    if prog.encoded:
        out = gray_decode(out, prog.out_bits)
    return out


@dataclasses.dataclass
class ArrayCost:
    num_cells: int
    rows: int
    arrays: float  # fractional 4x8 arrays (rows / 4)
    groups: int
    utilization: float  # used cells / provisioned cells


def array_cost(prog) -> ArrayCost:
    rows = prog.rows_needed(ACAM_ARRAY_COLS)
    arrays = rows / ACAM_ARRAY_ROWS
    groups = max(1, -(-int(np.ceil(arrays)) // ACAM_ARRAYS_PER_GROUP))
    provisioned = rows * ACAM_ARRAY_COLS
    return ArrayCost(
        num_cells=prog.num_cells,
        rows=rows,
        arrays=arrays,
        groups=groups,
        utilization=prog.num_cells / max(provisioned, 1),
    )
