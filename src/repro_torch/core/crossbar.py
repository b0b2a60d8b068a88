"""Bit-sliced ReRAM crossbar MVM with Compute-ACAM ADCs (paper §II-A, §IV-A).

The port of `repro.core.crossbar`. Weights are spatially bit-sliced into
``cell_bits``-wide conductance slices and inputs temporally into
``dac_bits``-wide pulses; every crossbar column's partial sum goes through
the ADC transfer and the planes are consolidated with shift-and-add, on the
ISAAC offset-encoded (unsigned) operands, with the offsets corrected
digitally (the row sum of the inputs, the column sum of the weights).

``adc_mode="exact"`` is a converter with enough resolution (the default:
128 rows x 2-bit cells x 1-bit DAC, 385 levels); ``"quantize"`` applies an
``adc_bits`` uniform transfer. This module is the plain oracle;
`repro_torch.kernels.acam_mvm` is the kernel with the same semantics.
`noisy_crossbar_linear` runs it on a device-varied array.

Integer products run in float64 (exact below 2^53 on any device, and
torch has no integer matmul on CUDA). The ADC follows the reference's
jitted float32 graph: ``p / step`` is a multiply by ``f32(1 / f32(step))``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .quant import QuantizedTensor, quantize_tensor

__all__ = ["CrossbarConfig", "bit_sliced_matmul", "crossbar_linear",
           "noisy_crossbar_linear", "sliced_matmul", "adc_step"]

_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class CrossbarConfig:
    rows: int = 128        # crossbar height (K is chunked to this)
    cell_bits: int = 2     # ReRAM bits per cell
    dac_bits: int = 1      # input bits per pulse
    weight_bits: int = 8
    input_bits: int = 8
    adc_bits: int = 8      # Compute-ACAM ADC resolution
    adc_mode: str = "exact"  # "exact" | "quantize"

    @property
    def num_weight_slices(self) -> int:
        return -(-self.weight_bits // self.cell_bits)

    @property
    def num_input_slices(self) -> int:
        return -(-self.input_bits // self.dac_bits)


def adc_step(cfg: CrossbarConfig, rows: int) -> Optional[float]:
    """The ADC's step ``p_max / levels`` for ``rows`` crossbar rows, or None
    when the transfer is the identity (exact mode, or enough levels)."""
    p_max = rows * ((1 << cfg.cell_bits) - 1) * ((1 << cfg.dac_bits) - 1)
    levels = (1 << cfg.adc_bits) - 1
    if cfg.adc_mode == "exact" or p_max <= levels:
        return None
    return p_max / levels


def _adc(p: torch.Tensor, step: float) -> torch.Tensor:
    """round(round(p / step) * step) on a non-negative integer partial sum."""
    inv = float(_F32(1) / _F32(step))
    return torch.round(torch.round(p.float() * inv) * float(_F32(step))
                       ).to(torch.int64)


def sliced_matmul(x_codes: torch.Tensor, w_codes: torch.Tensor,
                  cfg: CrossbarConfig, chunk: int) -> torch.Tensor:
    """The bit-sliced product with K cut into tiles of ``chunk`` rows, the
    ADC applied per tile with the step of ``cfg.rows`` rows: the core
    oracle at ``chunk == cfg.rows``, the kernel's function at any ``bk``."""
    M, K = x_codes.shape
    K2, N = w_codes.shape
    if K != K2:
        raise ValueError(f"shapes {tuple(x_codes.shape)} x "
                         f"{tuple(w_codes.shape)} do not chain")
    ox = 1 << (cfg.input_bits - 1)
    ow = 1 << (cfg.weight_bits - 1)
    xu = x_codes.to(torch.int64) + ox
    wu = w_codes.to(torch.int64) + ow
    # pad K to whole tiles; the unsigned padding adds nothing anywhere
    pad = (-K) % chunk
    if pad:
        xu = torch.nn.functional.pad(xu, (0, pad))
        wu = torch.nn.functional.pad(wu, (0, 0, 0, pad))
    n_chunks = (K + pad) // chunk
    xc = xu.reshape(M, n_chunks, chunk)
    wc = wu.reshape(n_chunks, chunk, N)
    step = adc_step(cfg, cfg.rows)
    if step is None:  # the shift-and-add over planes telescopes
        acc = torch.einsum("mck,ckn->mn", xc.double(), wc.double()
                           ).to(torch.int64)
    else:
        dac_mask = (1 << cfg.dac_bits) - 1
        cell_mask = (1 << cfg.cell_bits) - 1
        acc = torch.zeros((M, N), dtype=torch.int64, device=x_codes.device)
        for t in range(cfg.num_input_slices):      # temporal input slices
            x_t = ((xc >> (t * cfg.dac_bits)) & dac_mask).double()
            for s in range(cfg.num_weight_slices):  # spatial weight slices
                w_s = ((wc >> (s * cfg.cell_bits)) & cell_mask).double()
                p = torch.einsum("mck,ckn->mcn", x_t, w_s)
                q = _adc(p, step).sum(dim=1)
                acc = acc + (q << (t * cfg.dac_bits + s * cfg.cell_bits))
    rowsum_x = xu.sum(dim=1, keepdim=True)   # the ones column
    colsum_w = wu.sum(dim=0, keepdim=True)   # precomputed
    out = acc - ow * rowsum_x - ox * colsum_w + K * ox * ow
    # the reference's int32 arithmetic wraps; its result is this one mod 2^32
    return ((out + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def bit_sliced_matmul(x_codes: torch.Tensor, w_codes: torch.Tensor,
                      cfg: CrossbarConfig = CrossbarConfig()) -> torch.Tensor:
    """Integer matmul via crossbar bit-slicing. x (M, K) int; w (K, N) int.

    Exactly equals x @ w (int32) when the ADC has sufficient resolution.
    """
    return sliced_matmul(x_codes, w_codes, cfg, cfg.rows)


def crossbar_linear(x: torch.Tensor, wq: QuantizedTensor,
                    bias: Optional[torch.Tensor] = None,
                    cfg: CrossbarConfig = CrossbarConfig()) -> torch.Tensor:
    """Float-in/float-out linear layer on the crossbar DPE lane.

    x: (..., K) float. wq: per-out-channel int8 weights (K, N). The input is
    uniformly quantized per-tensor (the DAC path), multiplied bit-sliced, and
    rescaled.
    """
    xq = quantize_tensor(x, bits=cfg.input_bits)
    lead = x.shape[:-1]
    x2 = xq.codes.reshape(-1, x.shape[-1])
    y = bit_sliced_matmul(x2, wq.codes, cfg)
    yf = y.float() * (xq.scale * wq.scale)
    yf = yf.reshape(*lead, -1)
    if bias is not None:
        yf = yf + bias
    return yf


def noisy_crossbar_linear(x: torch.Tensor, wq: QuantizedTensor, noise,
                          key, bias: Optional[torch.Tensor] = None,
                          cfg: CrossbarConfig = CrossbarConfig()
                          ) -> torch.Tensor:
    """`crossbar_linear` on a device-varied array: the stored weight codes
    are perturbed by conductance spread and stuck-at cells in the ISAAC
    unsigned domain the array programs
    (`repro_torch.hw.noise.perturb_weight_codes`), then the bit-sliced MVM
    runs unchanged. Bit-identical to `crossbar_linear` when the noise knobs
    are zero."""
    from ..hw.noise import perturb_weight_codes
    codes = perturb_weight_codes(wq.codes, noise, key, bits=cfg.weight_bits)
    return crossbar_linear(x, dataclasses.replace(wq, codes=codes), bias,
                           cfg)
