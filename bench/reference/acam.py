"""The RACE-IT number formats and Compute-ACAM tables, written out plainly.

Every table is the function it stands for, evaluated on its input format's
grid and rounded into its output format (RACE-IT, Sections IV and VIII):

* LOGIT, the div-add stage's output: signed fixed point 1-4-3, steps of 1/8;
* the exp stage: LOGIT in, power-of-two codes out (code 0 is 0, code c is
  2^(c - 25), so 2^-24 up);
* the log stage: a power-of-two row sum in, log in 1-5-2 fixed point out
  (log 0 floored at -32);
* the final exp: a LOGIT difference in, a probability in 0-0-8 out;
* the activations: 1-2-5 in and out (GELU in its tanh form, SiLU).

Integer codes are symmetric max-abs quantizations with round half to even.
Nothing here imports the measured program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

LOGIT_SCALE = 1.0 / 8          # 1-4-3
LOGIT_MIN, LOGIT_MAX = -128, 127
ACT_SCALE = 1.0 / 32           # 1-2-5
PROB_SCALE = 1.0 / 256         # 0-0-8, codes 0..255
LOG_SCALE = 1.0 / 4            # 1-5-2
LOG_FLOOR = -32.0
POT_EMIN = -24                 # the power-of-two formats of exp and log
LOG_SHIFT = 1                  # LOGIT has 3 fraction bits, LOG 2

_F32 = np.float32


def _fixed(x, scale, lo, hi):
    return np.clip(np.round(np.asarray(x, np.float64) / scale), lo, hi)


def pot_encode_np(x):
    x = np.asarray(x, np.float64)
    e = np.clip(np.round(np.log2(np.maximum(x, 2.0 ** (POT_EMIN - 1)))
                         - POT_EMIN), 0, 254)
    return np.where(x < 2.0 ** (POT_EMIN - 0.5), 0, e + 1).astype(np.int64)


def pot_decode_np(code):
    code = np.asarray(code, np.int64)
    return np.where(code == 0, 0.0, np.exp2(code - 1.0 + POT_EMIN))


def _gelu(x):
    return 0.5 * x * (1.0 + np.tanh(math.sqrt(2.0 / math.pi)
                                    * (x + 0.044715 * x ** 3)))


def _silu(x):
    return x / (1.0 + np.exp(-x))


class Tables:
    """The tables on one device: ``exp_val`` (the exp stage's decoded
    values), ``log`` (log codes by power-of-two code), ``prob`` (probability
    codes by LOGIT code) and ``act[name]`` (activation codes by code), each
    indexed by code + 128 where the input is signed."""

    def __init__(self, device):
        grid = np.arange(LOGIT_MIN, LOGIT_MAX + 1) * LOGIT_SCALE
        self.exp_val = torch.tensor(
            pot_decode_np(pot_encode_np(np.exp(grid))).astype(_F32),
            device=device)
        sums = pot_decode_np(np.arange(256))
        logs = np.where(sums > 0, np.log(np.maximum(sums, 1e-300)), LOG_FLOOR)
        self.log = torch.tensor(_fixed(logs, LOG_SCALE, -128, 127),
                                dtype=torch.int64, device=device)
        self.prob = torch.tensor(_fixed(np.exp(grid), PROB_SCALE, 0, 255),
                                 dtype=torch.int64, device=device)
        act = np.arange(-128, 128) * ACT_SCALE
        self.act = {name: torch.tensor(_fixed(fn(act), ACT_SCALE, -128, 127)
                                       * ACT_SCALE, dtype=torch.float32,
                                       device=device)
                    for name, fn in (("gelu", _gelu), ("silu", _silu))}


def pot_encode(s: torch.Tensor) -> torch.Tensor:
    """Power-of-two codes of non-negative float32 sums."""
    safe = torch.clamp_min(s, 2.0 ** (POT_EMIN - 1))
    e = torch.clamp(torch.round(torch.log2(safe) - POT_EMIN), 0, 254)
    return torch.where(s < 2.0 ** (POT_EMIN - 0.5), torch.zeros_like(e),
                       e + 1).long()


def logit_codes(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / LOGIT_SCALE), LOGIT_MIN,
                       LOGIT_MAX).long()


def activation(t: Tables, x: torch.Tensor, name: str) -> torch.Tensor:
    """The Compute-ACAM activation: x on the 1-2-5 grid, then its table."""
    codes = torch.clamp(torch.round(x.float() / ACT_SCALE), -128, 127).long()
    return t.act[name][codes + 128]


def softmax(t: Tables, x: torch.Tensor) -> torch.Tensor:
    """The Fig.-8 softmax over the last axis: LOGIT codes, exp, row sum,
    log of its power-of-two code, and the final exp of the difference."""
    xc = logit_codes(x.float())
    s = t.exp_val[xc + 128].sum(-1, keepdim=True)
    lg = t.log[pot_encode(s)]
    d = torch.clamp(xc - (lg << LOG_SHIFT), LOGIT_MIN, LOGIT_MAX)
    return t.prob[d + 128].float() * PROB_SCALE


def qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def inv(bits: int) -> float:
    """float32(1 / qmax)."""
    return float(_F32(1) / _F32(qmax(bits)))


def quantize(x: torch.Tensor, bits: int, valid=None):
    """(codes as float64, scale, amax): one max-abs scale over ``x`` (over
    its ``valid`` entries where given, the others coded 0)."""
    a = x.abs() if valid is None else torch.where(valid, x.abs(),
                                                  torch.zeros_like(x))
    amax = torch.clamp_min(a.amax().float(), 1e-12)
    scale = amax * inv(bits)
    q = qmax(bits)
    codes = torch.clamp(torch.round(x / scale), -q - 1, q)
    if valid is not None:
        codes = torch.where(valid, codes, torch.zeros_like(codes))
    return codes.double(), scale, amax


def scales_product(amax_a, amax_b, bits: int) -> torch.Tensor:
    """The product of two max-abs scales, its two constants folded."""
    c = _F32(inv(bits)) * _F32(inv(bits))
    return (amax_a * amax_b) * float(_F32(c))


def weight_codes(w: torch.Tensor, bits: int):
    """A resident weight (K, ...) as (codes (K, N) float64, per-column scale
    (1, N)): each column's max-abs scale, a true division."""
    flat = w.float().reshape(w.shape[0], -1)
    amax = torch.clamp_min(flat.abs().amax(0, keepdim=True), 1e-12)
    scale = amax / float(qmax(bits))
    q = qmax(bits)
    codes = torch.clamp(torch.round(flat / scale), -q - 1, q)
    return codes.double(), scale.float()
