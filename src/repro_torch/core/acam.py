"""Vectorized functional simulation of Compute-ACAM arrays (paper Section III).

The port of `repro.core.acam`. Compilation is numpy, as in the reference, so
every table, range and rectangle is the reference's. Two evaluation paths,
equal on every input:

* the **hardware path** (``hw=True``): the compiled ranges/rectangles padded
  into dense arrays (`RangeArrays`, `RectArrays`), evaluated as the match
  lines do: per output bit, an OR over cells of "input in [lo, hi)", the
  bits weighted MSB first, then the Gray decode (XOR prefix), all int32;
* the **LUT path** (``hw=False``): the 2^n-entry table as a gather.

The device-noise variants (`jitter_codes`, `RangeArrays.jittered`,
`apply_codes_noisy`) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Union

import numpy as np
import torch

from . import compiler
from .gray import gray_decode
from .quant import FixedPointFormat, PoTFormat, ScaledFormat

Format = Union[FixedPointFormat, ScaledFormat, PoTFormat]

__all__ = ["RangeArrays", "RectArrays", "AcamFunction", "Acam2VarFunction"]


def _fmt_to_position(fmt: Format, codes):
    """Map stored codes to value-order positions (= unsigned code)."""
    if isinstance(fmt, PoTFormat):
        return codes  # PoT codes are already value-ordered, unsigned
    return fmt.to_unsigned(codes)


def _fmt_from_position(fmt: Format, pos):
    if isinstance(fmt, PoTFormat):
        return pos
    return fmt.from_unsigned(pos)


def _device_copy(cache: dict, arr: np.ndarray, device) -> torch.Tensor:
    """``arr`` as a tensor on ``device``, kept in ``cache`` per device."""
    key = str(device)
    if key not in cache:
        cache[key] = torch.from_numpy(arr).to(device)
    return cache[key]


class _DeviceArrays:
    """Padded cell arrays (the numpy fields named by ``_FIELDS``) evaluated
    as match lines on tensors."""

    _FIELDS: tuple = ()

    def on(self, device) -> list:
        caches = self.__dict__.setdefault("_on", {})
        return [_device_copy(caches.setdefault(f, {}), getattr(self, f),
                             device) for f in self._FIELDS]

    def _decode(self, match: torch.Tensor) -> torch.Tensor:
        """(..., out_bits, R) matches -> unsigned output patterns (...,)."""
        bits = match.any(dim=-1).to(torch.int32)  # (..., bits) MSB first
        weights = torch.tensor([1 << b for b in range(self.out_bits - 1, -1, -1)],
                               dtype=torch.int32, device=match.device)
        out = (bits * weights).sum(dim=-1, dtype=torch.int32)
        if self.encoded:
            out = gray_decode(out, self.out_bits)
        return out


@dataclasses.dataclass
class RangeArrays(_DeviceArrays):
    """Padded [lo, hi) ranges per output bit for vectorized evaluation."""

    lo: np.ndarray  # (out_bits, R) int32
    hi: np.ndarray  # (out_bits, R) int32
    mask: np.ndarray  # (out_bits, R) bool
    out_bits: int
    encoded: bool

    _FIELDS = ("lo", "hi", "mask")

    @classmethod
    def from_program(cls, prog: compiler.RangeProgram) -> "RangeArrays":
        R = max(1, max(len(r) for r in prog.ranges))
        lo = np.zeros((prog.out_bits, R), np.int32)
        hi = np.zeros((prog.out_bits, R), np.int32)
        mask = np.zeros((prog.out_bits, R), bool)
        for i, ranges in enumerate(prog.ranges):
            for k, (a, b) in enumerate(ranges):
                lo[i, k], hi[i, k], mask[i, k] = a, b, True
        return cls(lo, hi, mask, prog.out_bits, prog.encoded)

    def __call__(self, positions: torch.Tensor) -> torch.Tensor:
        """positions (...,) int -> unsigned output patterns (...,) int32."""
        lo, hi, mask = self.on(positions.device)
        p = positions.to(torch.int32)[..., None, None]  # (..., 1, 1)
        return self._decode((p >= lo) & (p < hi) & mask)  # (..., bits, R)


@dataclasses.dataclass
class RectArrays(_DeviceArrays):
    """Padded rectangles per output bit: [x_lo, x_hi) x [y_lo, y_hi)."""

    x_lo: np.ndarray  # (out_bits, R) int32
    x_hi: np.ndarray
    y_lo: np.ndarray
    y_hi: np.ndarray
    mask: np.ndarray  # (out_bits, R) bool
    out_bits: int
    encoded: bool

    _FIELDS = ("x_lo", "x_hi", "y_lo", "y_hi", "mask")

    @classmethod
    def from_program(cls, prog: compiler.RectProgram) -> "RectArrays":
        R = max(1, max(len(r) for r in prog.rects))
        arrs = {k: np.zeros((prog.out_bits, R), np.int32)
                for k in ("xl", "xh", "yl", "yh")}
        mask = np.zeros((prog.out_bits, R), bool)
        for i, rects in enumerate(prog.rects):
            for k, r in enumerate(rects):
                arrs["xl"][i, k], arrs["xh"][i, k] = r.x_lo, r.x_hi
                arrs["yl"][i, k], arrs["yh"][i, k] = r.y_lo, r.y_hi
                mask[i, k] = True
        return cls(arrs["xl"], arrs["xh"], arrs["yl"], arrs["yh"], mask,
                   prog.out_bits, prog.encoded)

    def __call__(self, xpos: torch.Tensor, ypos: torch.Tensor) -> torch.Tensor:
        x_lo, x_hi, y_lo, y_hi, mask = self.on(xpos.device)
        xp = xpos.to(torch.int32)[..., None, None]
        yp = ypos.to(torch.int32)[..., None, None]
        return self._decode((xp >= x_lo) & (xp < x_hi) & (yp >= y_lo)
                            & (yp < y_hi) & mask)


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
    _hw: RangeArrays = None
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
                   _lut=out_codes.astype(np.int32),
                   _hw=RangeArrays.from_program(prog))

    def lut(self, device) -> torch.Tensor:
        """The LUT as an int32 tensor on ``device`` (cached per device)."""
        return _device_copy(self._luts, self._lut, device)

    def apply_codes(self, codes: torch.Tensor, hw: bool = False) -> torch.Tensor:
        """Input codes -> output codes. hw=True uses the analog range semantics."""
        pos = _fmt_to_position(self.in_fmt, codes)
        if hw:
            return _fmt_from_position(self.out_fmt, self._hw(pos))
        return self.lut(codes.device)[pos.long()]

    def __call__(self, x: torch.Tensor, hw: bool = False) -> torch.Tensor:
        codes = self.in_fmt.encode(x)
        out = self.apply_codes(codes, hw=hw)
        return self.out_fmt.decode(out)


@dataclasses.dataclass
class Acam2VarFunction:
    """A compiled 2-variable (4-bit x 4-bit) Compute-ACAM function."""

    name: str
    x_fmt: FixedPointFormat
    y_fmt: FixedPointFormat
    out_fmt: FixedPointFormat
    table: np.ndarray  # (Nx, Ny) unsigned output patterns
    program: compiler.RectProgram
    cost: compiler.ArrayCost
    _lut: np.ndarray = None  # (Nx, Ny) output codes (signed domain)
    _hw: RectArrays = None
    _luts: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def compile(cls, name, fn, x_fmt, y_fmt, out_fmt, encode: bool = True):
        table = compiler.build_table_2var(fn, x_fmt, y_fmt, out_fmt)
        prog = compiler.compile_2var(table, out_fmt.bits, encode=encode)
        out_codes = out_fmt.from_unsigned(table.astype(np.int64))
        return cls(name=name, x_fmt=x_fmt, y_fmt=y_fmt, out_fmt=out_fmt,
                   table=table, program=prog, cost=compiler.array_cost(prog),
                   _lut=out_codes.astype(np.int32),
                   _hw=RectArrays.from_program(prog))

    def lut(self, device) -> torch.Tensor:
        """The (Nx, Ny) table as an int32 tensor on ``device`` (cached)."""
        return _device_copy(self._luts, self._lut, device)

    def apply_codes(self, xc: torch.Tensor, yc: torch.Tensor,
                    hw: bool = False) -> torch.Tensor:
        xpos = _fmt_to_position(self.x_fmt, xc)
        ypos = _fmt_to_position(self.y_fmt, yc)
        if hw:
            return _fmt_from_position(self.out_fmt, self._hw(xpos, ypos))
        return self.lut(xc.device)[xpos.long(), ypos.long()]

    def __call__(self, x, y, hw: bool = False):
        out = self.apply_codes(self.x_fmt.encode(x), self.y_fmt.encode(y), hw=hw)
        return self.out_fmt.decode(out)
