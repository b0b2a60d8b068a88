"""Compute-ACAM functions: compiled range programs and their LUT form.

The port of `repro.core.acam` (the LUT path). Compilation is numpy, as in
the reference, so every table is the reference's table; `apply_codes` is the
``hw=False`` gather on tensors. The analog match-line emulation
(``hw=True``) and device-noise variants are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Union

import numpy as np
import torch

from . import compiler
from .quant import FixedPointFormat, PoTFormat, ScaledFormat

Format = Union[FixedPointFormat, ScaledFormat, PoTFormat]

__all__ = ["AcamFunction"]


def _fmt_to_position(fmt: Format, codes):
    """Map stored codes to value-order positions (= unsigned code)."""
    if isinstance(fmt, PoTFormat):
        return codes  # PoT codes are already value-ordered, unsigned
    return fmt.to_unsigned(codes)


@dataclasses.dataclass
class AcamFunction:
    """A compiled 1-variable Compute-ACAM function."""

    name: str
    in_fmt: Format
    out_fmt: Format
    table: np.ndarray  # unsigned output pattern per value-ordered input
    program: compiler.RangeProgram
    cost: compiler.ArrayCost
    _lut: np.ndarray = None  # value-position -> output code (signed domain)
    _luts: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def compile(cls, name: str, fn: Callable, in_fmt: Format,
                out_fmt: Format, encode: bool = True) -> "AcamFunction":
        if isinstance(in_fmt, PoTFormat):
            x = in_fmt.decode(np.arange(in_fmt.num_codes))
        else:
            x = in_fmt.decode(in_fmt.all_codes_value_order())
        y = np.asarray(fn(x), dtype=np.float64)
        if isinstance(out_fmt, PoTFormat):
            table = out_fmt.encode(y).astype(np.uint32)
        else:
            table = out_fmt.to_bits(out_fmt.encode(y))
        out_bits = 8 if isinstance(out_fmt, PoTFormat) else out_fmt.bits
        prog = compiler.compile_1var(table, out_bits, encode=encode)
        out_codes = table.astype(np.int64)
        if not isinstance(out_fmt, PoTFormat):
            out_codes = out_fmt.from_unsigned(out_codes)
        return cls(name=name, in_fmt=in_fmt, out_fmt=out_fmt, table=table,
                   program=prog, cost=compiler.array_cost(prog),
                   _lut=out_codes.astype(np.int32))

    def lut(self, device) -> torch.Tensor:
        """The LUT as an int32 tensor on ``device`` (cached per device)."""
        key = str(device)
        if key not in self._luts:
            self._luts[key] = torch.from_numpy(self._lut).to(device)
        return self._luts[key]

    def apply_codes(self, codes: torch.Tensor, hw: bool = False) -> torch.Tensor:
        """Input codes -> output codes through the table."""
        if hw:
            raise NotImplementedError(
                "the match-line emulation (hw=True) is not ported yet")
        pos = _fmt_to_position(self.in_fmt, codes)
        return self.lut(codes.device)[pos.long()]

    def __call__(self, x: torch.Tensor, hw: bool = False) -> torch.Tensor:
        codes = self.in_fmt.encode(x)
        out = self.apply_codes(codes, hw=hw)
        return self.out_fmt.decode(out)
