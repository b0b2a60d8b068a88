"""Vectorized functional simulation of Compute-ACAM arrays (paper Section III).

The port of `repro.core.acam`. Compilation is numpy, as in the reference, so
every table, range and rectangle is the reference's. Two evaluation paths,
equal on every input:

* the **hardware path** (``hw=True``): the compiled ranges/rectangles padded
  into dense arrays (`RangeArrays`, `RectArrays`), evaluated as the match
  lines do: per output bit, an OR over cells of "input in [lo, hi)", the
  bits weighted MSB first, then the Gray decode (XOR prefix), all int32;
* the **LUT path** (``hw=False``): the 2^n-entry table as a gather.

Under device variation (`repro_torch.hw.noise`): `jitter_codes` (the
input-referred threshold jitter on searched or produced codes),
`RangeArrays.jittered` (the per-cell form, on the compiled bounds) and
`AcamFunction.apply_codes_noisy`, each drawing the reference's numbers.
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

__all__ = ["RangeArrays", "RectArrays", "AcamFunction", "Acam2VarFunction",
           "jitter_codes"]


def _fmt_num_codes(fmt: Format) -> int:
    return fmt.num_codes


def _fmt_code_bounds(fmt: Format) -> tuple:
    """Clip bounds for jittered codes of this format (signed domain for
    fixed-point/scaled formats, [0, num_codes) for value-ordered PoT)."""
    if isinstance(fmt, PoTFormat):
        return 0, fmt.num_codes - 1
    return fmt.code_min, fmt.code_max


def jitter_codes(codes: torch.Tensor, sigma: float, key: np.ndarray,
                 code_min: int, code_max: int) -> torch.Tensor:
    """Additive integer Gaussian jitter on stored/searched codes.

    The input-referred form of ACAM threshold-voltage variation: one
    rounded N(0, sigma) draw per element (``key`` a `repro_torch.hw.prng`
    key, the draw JAX's), added in int32 and clipped before the cast back,
    so int8 codes saturate rather than wrap. ``sigma <= 0`` returns the
    input unchanged.
    """
    if sigma <= 0.0:
        return codes
    from ..hw.noise import normal_offsets  # lazy: repro_torch.hw imports core
    n = normal_offsets(key, tuple(codes.shape), sigma, codes.device)
    out = torch.clamp(codes.to(torch.int32) + n, code_min, code_max)
    return out.to(codes.dtype)


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

    def jittered(self, sigma: float, key: np.ndarray) -> "RangeArrays":
        """Per-cell Gaussian jitter on the compiled match-window bounds:
        every stored [lo, hi) edge moves by round(N(0, sigma)) positions
        (numpy bounds, the draws the reference's). Windows whose edges
        cross never match. ``sigma <= 0`` returns self unchanged."""
        if sigma <= 0.0:
            return self
        from ..hw import prng
        kl, kh = prng.split(key)
        s = np.float32(sigma)
        dlo = np.round(s * prng.normal(kl, self.lo.shape)).astype(np.int32)
        dhi = np.round(s * prng.normal(kh, self.hi.shape)).astype(np.int32)
        return dataclasses.replace(self, lo=self.lo + dlo, hi=self.hi + dhi)


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

    def apply_codes_noisy(self, codes: torch.Tensor, key: np.ndarray,
                          in_sigma: float = 0.0,
                          out_sigma: float = 0.0) -> torch.Tensor:
        """`apply_codes` under device variation: ``in_sigma`` of threshold
        jitter in the value-ordered position domain, ``out_sigma`` of
        readout noise on the produced codes, clipped to the output format.
        The key always splits in two (input, output); bit-identical to
        `apply_codes` when both sigmas are zero."""
        if in_sigma <= 0.0 and out_sigma <= 0.0:
            return self.apply_codes(codes)
        from ..hw import prng
        kin, kout = prng.split(key)
        pos = _fmt_to_position(self.in_fmt, codes)
        pos = jitter_codes(pos, in_sigma, kin, 0,
                           _fmt_num_codes(self.in_fmt) - 1)
        out = self.lut(codes.device)[pos.long()]
        return jitter_codes(out, out_sigma, kout,
                            *_fmt_code_bounds(self.out_fmt))

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
