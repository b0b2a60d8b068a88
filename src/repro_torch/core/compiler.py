"""Truth-table -> Compute-ACAM range compiler (paper Sections III & V).

The one-variable half of `repro.core.compiler` (numpy only), kept in the
port so that it imports nothing of the reference package: each output bit's
match line stores the runs of 1s of the value-ordered truth table, Gray-coded
output halves the runs (Section V-A), and arrays are sized per Section V-B
(4x8 arrays, 16 per group). The two-variable rectangle compiler is not
ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .gray import gray_encode

__all__ = ["RangeProgram", "ArrayCost", "compile_1var", "array_cost",
           "ACAM_ARRAY_ROWS", "ACAM_ARRAY_COLS", "ACAM_ARRAYS_PER_GROUP"]

# Section V-B design point: 4x8 arrays, 16 arrays per group.
ACAM_ARRAY_ROWS = 4
ACAM_ARRAY_COLS = 8
ACAM_ARRAYS_PER_GROUP = 16


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
