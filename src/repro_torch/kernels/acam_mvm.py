"""Bit-sliced crossbar MVM with Compute-ACAM ADCs on int8 codes.

The port of `repro.kernels.acam_mvm`: x (M, K) int8 times w (K, N) int8 ->
(M, N) int32 on offset-encoded operands, K cut into tiles of ``bk`` rows
(one crossbar when ``bk == cfg.rows``), with the exact or the quantizing
ADC per tile and the offset corrections. The TPU function `_mvm_kernel`
becomes ``csrc/acam_mvm.cu``; the plain PyTorch version is
`acam_mvm_plain`. A CUDA tensor launches the kernel or raises, a CPU tensor
runs the plain version.

The ADC's step comes from ``cfg.rows`` while it is applied per ``bk``-row
tile, as in the Pallas kernel: in quantize mode a call with ``bk !=
cfg.rows`` follows the kernel, not the `repro_torch.core.crossbar` oracle.
``bm``/``bn`` are the reference's output tile sizes and change nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.crossbar import CrossbarConfig, adc_step, sliced_matmul

__all__ = ["acam_mvm", "acam_mvm_plain", "launches"]

# kernel launches, one per launch of csrc/acam_mvm.cu
launches = {"acam_mvm": 0}

_F32 = np.float32


def acam_mvm_plain(x: torch.Tensor, w: torch.Tensor,
                   cfg: CrossbarConfig = CrossbarConfig(),
                   bk: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (K tiles of ``bk`` rows)."""
    return sliced_matmul(x, w, cfg, bk or cfg.rows)


def _launch(x: torch.Tensor, w: torch.Tensor, cfg: CrossbarConfig, bk: int
            ) -> torch.Tensor:
    import ctypes

    from .build import bind  # built at first launch, never at import
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = bind("acam_mvm", "acam_mvm_launch",
              [P, P, P, I, I, I, I, I, I, I, I, I, F, F, P])
    M, K = x.shape
    N = w.shape[1]
    step = adc_step(cfg, cfg.rows)
    quantize = step is not None
    step32 = _F32(step if quantize else 1.0)
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty((M, N), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, bk,
             cfg.input_bits, cfg.weight_bits, cfg.dac_bits, cfg.cell_bits,
             int(quantize), float(step32), float(_F32(1) / step32), stream)
    if err != 0:
        raise RuntimeError(f"acam_mvm launch failed: cudaError {err}")
    launches["acam_mvm"] += 1
    return out


def acam_mvm(x: torch.Tensor, w: torch.Tensor,
             cfg: CrossbarConfig = CrossbarConfig(), bm: int = 256,
             bn: int = 256, bk: int | None = None) -> torch.Tensor:
    """Bit-sliced crossbar matmul: x (M, K) int8 codes, w (K, N) int8 codes
    -> (M, N) int32, equal to x @ w under an ideal ADC."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} x {tuple(w.shape)} do "
                         f"not chain")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    bk = bk or cfg.rows
    if x.device.type == "cuda":
        if x.dtype != torch.int8 or w.dtype != torch.int8:
            raise TypeError(f"the CUDA kernel takes int8 codes, got "
                            f"{x.dtype} x {w.dtype}")
        if bk % 4 or not 4 <= bk <= 256 or cfg.input_bits > 8 \
                or cfg.weight_bits > 8:
            raise ValueError(f"the CUDA kernel takes bk a multiple of 4 up "
                             f"to 256 and operands of at most 8 bits, got "
                             f"bk={bk}, {cfg}")
        return _launch(x, w, cfg, bk)
    if x.device.type == "cpu":
        return acam_mvm_plain(x, w, cfg, bk)
    raise ValueError(f"no implementation for device {x.device}")
