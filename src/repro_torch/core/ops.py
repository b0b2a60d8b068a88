"""Standard Compute-ACAM operator library (paper Section IV).

The port of `repro.core.ops`: the same formats and operator specs, compiled
by the same numpy compiler, so every table equals the reference's entry for
entry: the 8-bit 1-var operators and the 4-bit 2-var nibble multiplies that
make up an 8-bit multiply (`mult8_codes`: four nibble products and three
adds).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .acam import Acam2VarFunction, AcamFunction
from .quant import FixedPointFormat, PoTFormat, ScaledFormat

__all__ = [
    "int4s", "int4u", "int8s", "int8u",
    "GELU_FMT", "LOGIT_FMT", "PROB_FMT", "EXP_POT", "LOG_OUT_FMT",
    "get_op", "mult4_programs", "mult4_paper", "mult8_codes", "OPS",
]

# ---- formats -------------------------------------------------------------
int4s = FixedPointFormat(int_bits=3, frac_bits=0, signed=True)    # [-8, 7]
int4u = FixedPointFormat(int_bits=4, frac_bits=0, signed=False)   # [0, 15]
int8s = FixedPointFormat(int_bits=7, frac_bits=0, signed=True)    # [-128, 127]
int8u = FixedPointFormat(int_bits=8, frac_bits=0, signed=False)   # [0, 255]

GELU_FMT = FixedPointFormat(int_bits=2, frac_bits=5)   # 1-2-5: [-4, 3.97]
LOGIT_FMT = FixedPointFormat(int_bits=4, frac_bits=3)  # 1-4-3: [-16, 15.875]
PROB_FMT = FixedPointFormat(int_bits=0, frac_bits=8, signed=False)  # [0, 1)
EXP_POT = PoTFormat(e_min=-24, bits=8)                 # exp output, PoT (§VIII-C)
LOG_OUT_FMT = FixedPointFormat(int_bits=5, frac_bits=2)  # log output: [-32, 31.75]


def _np_gelu(x):
    return 0.5 * x * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * x**3)))


def _np_silu(x):
    return x / (1.0 + np.exp(-x))


def _np_softplus(x):
    return np.log1p(np.exp(np.minimum(x, 30.0))) + np.maximum(x - 30.0, 0.0)


def _np_log_with_floor(x):
    """log(v); log(0) hard-set to the output format's minimum (paper §IV-C)."""
    out = np.full_like(x, LOG_OUT_FMT.min_value, dtype=np.float64)
    pos = x > 0
    out[pos] = np.log(x[pos])
    return out


_OP_SPECS = {
    # name: (fn, in_fmt, out_fmt)
    "gelu": (_np_gelu, GELU_FMT, GELU_FMT),
    "silu": (_np_silu, GELU_FMT, GELU_FMT),
    "relu": (lambda x: np.maximum(x, 0.0), GELU_FMT, GELU_FMT),
    "softplus": (_np_softplus, GELU_FMT, GELU_FMT),
    "identity4": (lambda x: x, int4u, int4u),  # the Compute-ACAM ADC (§IV-A)
    "exp_pot": (np.exp, LOGIT_FMT, EXP_POT),   # softmax step 1/5, PoT output
    # Ablation (paper Fig. 14): 8-bit uniform quantization of the exp output
    "exp_uniform": (np.exp, LOGIT_FMT,
                    ScaledFormat(scale_value=float(np.exp(LOGIT_FMT.max_value)) / 255.0,
                                 bits=8, signed=False)),
    "exp_prob": (np.exp, LOGIT_FMT, PROB_FMT),  # softmax step 5 (x - logsum <= 0)
    "log": (_np_log_with_floor, PoTFormat(e_min=-24, bits=8), LOG_OUT_FMT),
    # fractional-octave PoT (log-uniform): quarter-octave steps
    "exp_pot_fine": (np.exp, LOGIT_FMT, PoTFormat(e_min=-24, bits=8, octave_step=0.25)),
    "log_fine": (_np_log_with_floor, PoTFormat(e_min=-24, bits=8, octave_step=0.25), LOG_OUT_FMT),
}

OPS = tuple(_OP_SPECS.keys())


@lru_cache(maxsize=None)
def get_op(name: str, encode: bool = True) -> AcamFunction:
    fn, in_fmt, out_fmt = _OP_SPECS[name]
    return AcamFunction.compile(name, fn, in_fmt, out_fmt, encode=encode)


# ---- 4-bit multiplication (paper §IV-B, Figures 7 & 9(b)) -----------------

@lru_cache(maxsize=None)
def mult4_programs(encode: bool = True):
    """The three nibble-product tables needed for signed 8-bit multiply:
    ss (signed x signed), su (signed x unsigned), uu (unsigned x unsigned)."""
    mul = lambda x, y: x * y  # noqa: E731
    ss = Acam2VarFunction.compile("mult4_ss", mul, int4s, int4s,
                                  FixedPointFormat(int_bits=7, frac_bits=0),
                                  encode=encode)
    su = Acam2VarFunction.compile("mult4_su", mul, int4s, int4u,
                                  FixedPointFormat(int_bits=7, frac_bits=0),
                                  encode=encode)
    uu = Acam2VarFunction.compile("mult4_uu", mul, int4u, int4u,
                                  FixedPointFormat(int_bits=8, frac_bits=0,
                                                   signed=False),
                                  encode=encode)
    return ss, su, uu


@lru_cache(maxsize=None)
def mult4_paper(encode: bool = False):
    """The exact configuration of paper Figure 7: x, y in 1-1-2; z in 1-2-1."""
    f_in = FixedPointFormat(int_bits=1, frac_bits=2)
    f_out = FixedPointFormat(int_bits=2, frac_bits=1)
    return Acam2VarFunction.compile("mult4_fig7", lambda x, y: x * y, f_in,
                                    f_in, f_out, encode=encode)


def mult8_codes(x: torch.Tensor, y: torch.Tensor, hw: bool = False) -> torch.Tensor:
    """8-bit signed multiply from four 4-bit ACAM products + three adds.

    x, y: int codes in [-128, 127]. Returns x*y exactly (int32): p =
    (xh*yh)<<8 + (xh*yl + yh*xl)<<4 + xl*yl with arithmetic high nibbles
    and unsigned low nibbles.
    """
    ss, su, uu = mult4_programs()
    x = x.to(torch.int32)
    y = y.to(torch.int32)
    xh, xl = x >> 4, x & 0xF
    yh, yl = y >> 4, y & 0xF
    p_hh = ss.apply_codes(xh, yh, hw=hw)
    p_hl = su.apply_codes(xh, yl, hw=hw)
    p_lh = su.apply_codes(yh, xl, hw=hw)
    p_ll = uu.apply_codes(xl, yl, hw=hw)
    return (p_hh << 8) + ((p_hl + p_lh) << 4) + p_ll
