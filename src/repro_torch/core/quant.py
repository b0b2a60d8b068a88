"""Fixed-point formats and quantizers used by Compute-ACAM numerics.

The port of `repro.core.quant`. Formats work on numpy arrays (the table
compiler, float64 as in the reference) and on tensors (the serving path,
float32). Tensor arithmetic reproduces the f32 op sequence that the
reference's jitted graphs run, which is not always the one its source
spells out:

* XLA rewrites a division by a constant into a multiplication by the
  rounded reciprocal, so ``max(amax, 1e-12) / 127`` inside a jitted
  function is ``max(amax, 1e-12) * f32(1/127)`` (`recip_scale`). A
  division by a runtime value stays a division.
* ``jnp.log2(x)`` is ``log(x) * f32(1/ln 2)`` with XLA's CPU ``log``, a
  Cephes polynomial evaluated with fused multiply-adds (`ref_log`, which
  agrees with XLA on every float32 in [2^-26, 2^41)). In the PoT encoder
  the multiply and the following ``- e_min`` contract into one more fused
  multiply-add. The encoder rounds that value, so a one-ulp difference
  would flip a code at half-step boundaries.
* ``jnp.exp2(e)`` is ``exp(f32(ln 2) * e)``. A constant table folds it with
  a correctly rounded ``expf`` (`pot_decode_f32`); at run time XLA's CPU
  evaluates the Cephes polynomial with fused multiply-adds (`ref_exp`),
  which is one ulp off at some arguments, so a runtime PoT decode
  (`PoTFormat.decode` on a tensor, `pot_decode_runtime`) has other values.
* ``jnp.sum`` over the last axis adds runs of 32 elements one by one, then
  sums the run totals by the same rule (`sum_chunks`, `ref_sum`).
* XLA moves the ``1/127`` constants out of a product of two quantizer
  scales and folds them (`scale_product`).
* The attention kernels' ``logits / sqrt_d`` (``sqrt_d`` a trace-time
  constant, sqrt(d) not a power of two) is a multiply by ``f32(1 /
  sqrt(d))`` after the one by ``s1``, in the interpret-mode Pallas kernel
  too (a sweep of logits an ulp from a LOGIT half step rules out the
  division; `repro_torch.kernels.acam_attention.sqrt_d_rule`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = [
    "FixedPointFormat", "ScaledFormat", "PoTFormat", "QuantizedTensor",
    "quantize_tensor", "recip_scale", "ref_log", "ref_log2", "ref_exp",
    "ref_sum", "sum_chunks", "pot_encode", "pot_decode_f32",
    "pot_decode_runtime", "runtime_pot_values", "scale_product",
    "dequantize_tensor", "fake_quant",
]

_F32 = np.float32


def recip_scale(amax: torch.Tensor, qmax: int) -> torch.Tensor:
    """``jnp.maximum(amax, 1e-12) / qmax`` as a jitted reference graph runs it."""
    inv = float(_F32(1) / _F32(qmax))
    return torch.clamp_min(amax, float(_F32(1e-12))) * inv


# Cephes logf coefficients (XLA's CPU log for float32)
_LOG_P = [float(_F32(c)) for c in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1)]
_LOG_Q1 = float(_F32(-2.12194440e-4))
_LOG_Q2 = float(_F32(0.693359375))
_SQRTHF = float(_F32(0.707106781186547524))
INV_LN2 = float(_F32(1) / _F32(np.log(2.0)))


def _fma(a, b, c):
    # float32 fused multiply-add: the product of two float32 is exact in
    # float64, so one float64 add and a cast give the fused result (up to a
    # double rounding that the exhaustive sweep never met)
    return (a.double() * b + c).float()


def ref_log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log as XLA's CPU backend computes it (positive x)."""
    x = torch.clamp_min(x.float(), float(_F32(1.17549435e-38)))
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 126).float()
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < _SQRTHF
    xx = m - 1.0
    e = e - small.float()
    xx = xx + torch.where(small, m, torch.zeros_like(m))
    x2 = xx * xx
    x3 = x2 * xx
    p = _LOG_P
    y = _fma(xx, p[0], torch.full_like(xx, p[1]))
    y1 = _fma(xx, p[3], torch.full_like(xx, p[4]))
    y2 = _fma(xx, p[6], torch.full_like(xx, p[7]))
    y = _fma(y, xx, torch.full_like(xx, p[2]))
    y1 = _fma(y1, xx, torch.full_like(xx, p[5]))
    y2 = _fma(y2, xx, torch.full_like(xx, p[8]))
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    xx = xx - x2 * 0.5
    xx = xx + y
    return xx + e * _LOG_Q2


def ref_log2(x: torch.Tensor) -> torch.Tensor:
    """float32 ``jnp.log2`` as the reference's jitted graphs compute it."""
    return ref_log(x) * INV_LN2


# Cephes expf coefficients (XLA's CPU exp for float32)
_EXP_P = [float(_F32(c)) for c in (
    1.9875691500E-4, 1.3981999507E-3, 8.3334519073E-3, 4.1665795894E-2,
    1.6666665459E-1, 5.0000001201E-1)]
LN2_F32 = _F32(np.log(2.0))


def ref_exp(x: torch.Tensor) -> torch.Tensor:
    """float32 exp as XLA's CPU backend evaluates it at run time.

    The Cephes range reduction and polynomial, every multiply-add fused
    (tests/test_torch_xla_numerics.py holds it to XLA on 4 M random
    arguments and on every float32 of five binade ranges). It differs from
    a correctly rounded ``expf`` by one ulp at about one argument in ten.
    """
    x = torch.clamp(x.float(), -104.0, 88.8)
    n = torch.floor(_fma(x, float(_F32(1.44269504088896341)), 0.5))
    n = torch.clamp(n, -127, 127)
    a = _fma(n, float(_F32(-0.693359375)), x)
    a = _fma(n, float(_F32(2.12194440e-4)), a)
    p = _EXP_P
    z = _fma(a, p[0], p[1])
    for c in p[2:]:
        z = _fma(z, a, c)
    z = _fma(z, a * a, a)
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return (1.0 + z) * pow2


def sum_chunks(n: int) -> list:
    """How XLA's CPU backend splits a sum of ``n`` elements into runs: each
    run is added element by element, and the list of run totals is summed
    again by this rule until one value is left (`ref_sum`).

    Runs of 32; when n is not a multiple of 32 the first run and the
    remainder are split into two halves, the larger first (n = 32m + r,
    0 < r < 32, m >= 1: [ceil((32+r)/2)] + [32]*(m-1) + [floor((32+r)/2)]).
    Measured on jitted sums for every n up to 4096
    (tests/test_torch_xla_numerics.py).
    """
    m, r = divmod(n, 32)
    if m == 0:
        return [n]
    if r == 0:
        return [32] * m
    return [(32 + r + 1) // 2] + [32] * (m - 1) + [(32 + r) // 2]


_RUN_INDEX: dict = {}


def _run_index(n: int, device) -> torch.Tensor:
    """(runs, 32) positions of `sum_chunks(n)`'s runs; n marks padding."""
    key = (n, str(device))
    if key not in _RUN_INDEX:
        runs = sum_chunks(n)
        idx = np.full((len(runs), max(runs)), n, np.int64)
        start = 0
        for c, length in enumerate(runs):
            idx[c, :length] = np.arange(start, start + length)
            start += length
        _RUN_INDEX[key] = torch.from_numpy(idx).to(device)
    return _RUN_INDEX[key]


def ref_sum(e: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis in the order of `sum_chunks`.

    Each level gathers its runs into a (..., runs, 32) tensor, zero-padded
    (adding an exact zero changes no sum), and adds the 32 columns in order.
    """
    if e.shape[-1] == 0:
        return e.new_zeros(e.shape[:-1])
    while e.shape[-1] > 1:
        idx = _run_index(e.shape[-1], e.device)
        padded = torch.cat([e, e.new_zeros(e.shape[:-1] + (1,))], dim=-1)
        g = padded[..., idx]
        acc = g[..., 0]
        for j in range(1, g.shape[-1]):
            acc = acc + g[..., j]
        e = acc
    return e[..., 0]


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


@dataclasses.dataclass(frozen=True)
class FixedPointFormat:
    """An S-I-F fixed point format, e.g. 1-0-3 = sign + 0 int bits + 3 frac bits.

    Codes are two's-complement integers in [-2^(n-1), 2^(n-1)) for signed
    formats, [0, 2^n) for unsigned; value = code * 2^-frac_bits.
    """

    int_bits: int
    frac_bits: int
    signed: bool = True

    @property
    def bits(self) -> int:
        return int(self.signed) + self.int_bits + self.frac_bits

    @property
    def scale(self) -> float:
        return 2.0 ** (-self.frac_bits)

    @property
    def num_codes(self) -> int:
        return 1 << self.bits

    @property
    def code_min(self) -> int:
        return -(1 << (self.bits - 1)) if self.signed else 0

    @property
    def code_max(self) -> int:
        return (1 << (self.bits - 1)) - 1 if self.signed else (1 << self.bits) - 1

    @property
    def min_value(self) -> float:
        return self.code_min * self.scale

    @property
    def max_value(self) -> float:
        return self.code_max * self.scale

    def __str__(self) -> str:  # S-I-F, as in the paper
        return f"{int(self.signed)}-{self.int_bits}-{self.frac_bits}"

    def encode(self, x):
        """Float -> two's complement code (saturating round-to-nearest-even)."""
        if _is_tensor(x):  # power-of-two scale: division is exact
            return torch.clamp(torch.round(x / self.scale), self.code_min,
                               self.code_max).to(torch.int32)
        c = np.clip(np.round(x / self.scale), self.code_min, self.code_max)
        return c.astype(np.int32)

    def decode(self, code):
        if _is_tensor(code):
            return code.float() * self.scale
        return code.astype(np.float32) * self.scale

    def to_unsigned(self, code):
        """Two's-complement code -> unsigned LUT index in [0, 2^n)."""
        if not self.signed:
            return code
        return code + (1 << (self.bits - 1))

    def from_unsigned(self, u):
        if not self.signed:
            return u
        return u - (1 << (self.bits - 1))

    def to_bits(self, code) -> np.ndarray:
        """Unsigned bit-pattern of the two's-complement code (numpy)."""
        u = np.asarray(self.to_unsigned(np.asarray(code)))
        return u.astype(np.uint32)

    def all_codes_value_order(self) -> np.ndarray:
        """All codes sorted by their analog (decoded) value, ascending."""
        return np.arange(self.code_min, self.code_max + 1, dtype=np.int64)

    def quantize_value(self, x):
        return self.decode(self.encode(x))


@dataclasses.dataclass(frozen=True)
class ScaledFormat:
    """Integer format with an arbitrary (calibrated) float scale (numpy: the
    table compiler is its only user)."""

    scale_value: float
    bits: int = 8
    signed: bool = True

    @property
    def scale(self) -> float:
        return self.scale_value

    @property
    def num_codes(self) -> int:
        return 1 << self.bits

    @property
    def code_min(self) -> int:
        return -(1 << (self.bits - 1)) if self.signed else 0

    @property
    def code_max(self) -> int:
        return (1 << (self.bits - 1)) - 1 if self.signed else (1 << self.bits) - 1

    @property
    def min_value(self) -> float:
        return self.code_min * self.scale

    @property
    def max_value(self) -> float:
        return self.code_max * self.scale

    def encode(self, x):
        c = np.clip(np.round(x / self.scale), self.code_min, self.code_max)
        return c.astype(np.int32)

    def decode(self, code):
        if _is_tensor(code):
            return code.float() * float(_F32(self.scale))
        return code.astype(np.float32) * self.scale

    def to_unsigned(self, code):
        return code + (1 << (self.bits - 1)) if self.signed else code

    def from_unsigned(self, u):
        return u - (1 << (self.bits - 1)) if self.signed else u

    def to_bits(self, code) -> np.ndarray:
        return np.asarray(self.to_unsigned(np.asarray(code))).astype(np.uint32)

    def all_codes_value_order(self) -> np.ndarray:
        return np.arange(self.code_min, self.code_max + 1, dtype=np.int64)

    def quantize_value(self, x):
        return self.decode(self.encode(x))


@dataclasses.dataclass(frozen=True)
class PoTFormat:
    """Power-of-Two quantization for non-negative values (exp outputs).

    Code 0 represents exactly 0; code c >= 1 represents
    2^(e_min + (c-1)*octave_step). On numpy arrays the methods are the
    table compiler's (float64); on tensors they are the reference's jitted
    float32 graph: `pot_encode`, and the runtime decode `pot_decode_runtime`
    as a gather from its 2^bits values.
    """

    e_min: int
    bits: int = 8
    octave_step: float = 1.0

    @property
    def num_codes(self) -> int:
        return 1 << self.bits

    @property
    def e_max(self) -> float:
        return self.e_min + (self.num_codes - 2) * self.octave_step

    def encode(self, x):
        if _is_tensor(x):
            return pot_encode(x.float(), self.e_min, self.octave_step)
        x = np.asarray(x, np.float64)
        safe = np.maximum(x, 2.0 ** (self.e_min - 1))
        e = np.clip(np.round((np.log2(safe) - self.e_min) / self.octave_step),
                    0, self.num_codes - 2)
        code = (e + 1).astype(np.int32)
        return np.where(x < 2.0 ** (self.e_min - self.octave_step / 2), 0, code)

    def decode(self, code):
        if _is_tensor(code):
            return runtime_pot_values(self, code.device)[code.long()]
        e = (code - 1).astype(np.float64) * self.octave_step + self.e_min
        val = np.exp2(np.minimum(e, 126.0))
        return np.where(code == 0, 0.0, val)

    def quantize_value(self, x):
        return self.decode(self.encode(x))

    def all_codes_value_order(self) -> np.ndarray:
        return np.arange(self.num_codes, dtype=np.int64)


def pot_encode(S: torch.Tensor, e_min: float, octave_step: float
               ) -> torch.Tensor:
    """f32 PoT encode in the reference's op order (int32 codes)."""
    safe = torch.clamp_min(S, float(_F32(2.0 ** (e_min - 1))))
    # XLA contracts log(x) * (1/ln 2) - e_min into one fused multiply-add
    y = _fma(ref_log(safe), INV_LN2,
             torch.full_like(safe, -float(_F32(e_min))))
    if octave_step != 1.0:  # XLA: division by a constant power of two
        y = y * float(_F32(1.0 / octave_step))
    e = torch.clamp(torch.round(y), 0, 254)
    codes = (e + 1).to(torch.int32)
    thr = float(_F32(2.0 ** (e_min - octave_step / 2)))
    return torch.where(S < thr, torch.zeros_like(codes), codes)


def pot_decode_f32(code: np.ndarray, e_min: float, octave_step: float
                   ) -> np.ndarray:
    """float32 PoT decode as a constant-folded reference graph evaluates it.

    ``jnp.exp2(e)`` lowers to ``exp(f32(ln 2) * e)``; XLA folds constant
    tables with a correctly rounded float32 ``exp``. So even integer
    exponents do not give exact powers of two.
    """
    code = np.asarray(code, np.int64)
    e = ((code - 1).astype(_F32) * _F32(octave_step) + _F32(e_min)).astype(_F32)
    arg = (_F32(np.log(2.0)) * np.minimum(e, _F32(126.0))).astype(_F32)
    val = np.exp(arg.astype(np.float64)).astype(_F32)
    return np.where(code == 0, _F32(0), val).astype(_F32)


def pot_decode_runtime(code, e_min: float, octave_step: float) -> np.ndarray:
    """float32 PoT decode as a jitted reference graph evaluates it on codes
    known only at run time: ``exp2(min(e, 126))`` with XLA's runtime exp
    (`ref_exp`), not the correctly rounded one of folded constants."""
    code = np.asarray(code, np.int64)
    e = ((code - 1).astype(_F32) * _F32(octave_step) + _F32(e_min)).astype(_F32)
    arg = (LN2_F32 * np.minimum(e, _F32(126.0))).astype(_F32)
    val = ref_exp(torch.from_numpy(arg)).numpy()
    return np.where(code == 0, _F32(0), val).astype(_F32)


_POT_VALUES: dict = {}


def runtime_pot_values(fmt: "PoTFormat", device) -> torch.Tensor:
    """`pot_decode_runtime` of every code of ``fmt``, float32 on ``device``."""
    key = (fmt, str(device))
    if key not in _POT_VALUES:
        vals = pot_decode_runtime(np.arange(fmt.num_codes), fmt.e_min,
                                  fmt.octave_step)
        _POT_VALUES[key] = torch.from_numpy(vals).to(device)
    return _POT_VALUES[key]


@dataclasses.dataclass
class QuantizedTensor:
    """Symmetric-quantized integer tensor + scale (per-tensor or per-channel)."""

    codes: torch.Tensor  # int8 / int32
    scale: torch.Tensor  # f32, broadcastable to codes
    bits: int = 8
    amax: Optional[torch.Tensor] = None  # max(|x|, 1e-12) behind the scale


def scale_product(a: QuantizedTensor, b: QuantizedTensor) -> torch.Tensor:
    """``a.scale * b.scale`` as a jitted reference graph computes it.

    Each scale is ``amax * f32(1/qmax)``; XLA moves the two constants out of
    the product and folds them, so the product is ``(amax_a * amax_b) *
    f32(c_a * c_b)``, which often differs from the product of the two
    rounded scales in the last bit. (Eager code, and products where one
    side is broadcast against an array, keep the plain product.)
    """
    c = _F32(_F32(1) / _F32(_qrange(a.bits))) * _F32(
        _F32(1) / _F32(_qrange(b.bits)))
    return (a.amax * b.amax) * float(_F32(c))


def _qrange(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def quantize_tensor(x: torch.Tensor, bits: int = 8, axis=None) -> QuantizedTensor:
    """Symmetric max-abs quantization. axis=None -> per-tensor scale;
    axis=k -> per-channel scales along every dim except k reduced."""
    if axis is None:
        amax = x.abs().amax()
    else:
        reduce_dims = tuple(d for d in range(x.ndim) if d != axis)
        amax = x.abs().amax(dim=reduce_dims, keepdim=True)
    qmax = _qrange(bits)
    scale = recip_scale(amax, qmax)
    codes = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    dtype = torch.int8 if bits <= 8 else torch.int32
    return QuantizedTensor(codes.to(dtype), scale.float(), bits,
                           torch.clamp_min(amax, float(_F32(1e-12))).float())


def dequantize_tensor(q: QuantizedTensor) -> torch.Tensor:
    """codes as float32 times the scale."""
    return q.codes.float() * q.scale


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits, axis):
        y = dequantize_tensor(quantize_tensor(x.detach(), bits=bits,
                                              axis=axis))
        return x + (y - x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def fake_quant(x: torch.Tensor, bits: int = 8, axis=None) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient (the QAT
    helper): the value ``x + (q(x) - x)`` of the reference's jitted graph,
    the gradient the identity."""
    return _FakeQuant.apply(x, bits, axis)
