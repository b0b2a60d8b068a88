"""Compute-ACAM 1-variable op as a 2^n-entry table gather over int codes.

The port of `repro.kernels.acam_lut`: an ACAM array's OR-of-ranges per
output bit is equivalent to a 2^n-entry table, so an n-bit op is ``lut[x +
bias]`` elementwise, with ``bias`` moving two's-complement codes to table
positions. The TPU function `_lut_kernel` becomes ``csrc/acam_lut.cu``; the
plain PyTorch version is `acam_lut_plain`. The wrapper picks by the device
of its input: a CUDA tensor launches the kernel or raises, a CPU tensor
runs the plain version, a ``meta`` tensor gets the output's shape and its
work is reported to an active op counter (`cost`). Codes outside the table
are clamped to it (they are outside the op's input format, so the
reference never meets them).
"""
from __future__ import annotations

import torch

from . import cost

__all__ = ["acam_lut_2d", "acam_lut", "acam_lut_plain", "launches",
           "DEFAULT_BLOCK_ROWS"]

# the reference's tile height; the function does not depend on it
DEFAULT_BLOCK_ROWS = 256

# kernel launches, one per launch of csrc/acam_lut.cu
launches = {"acam_lut": 0}

_CODE_DTYPES = (torch.int8, torch.int32)


def acam_lut_plain(x: torch.Tensor, lut: torch.Tensor, bias: int = 128
                   ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: int32 ``lut[x + bias]``."""
    idx = torch.clamp(x.long() + bias, 0, lut.shape[0] - 1)
    return lut.to(device=x.device, dtype=torch.int32)[idx]


def _launch(x: torch.Tensor, lut: torch.Tensor, bias: int) -> torch.Tensor:
    import ctypes

    from .build import bind  # built at first launch, never at import
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = bind("acam_lut", "acam_lut_launch", [P, I, P, I, I, P, LL, P])
    x = x.contiguous()
    table = lut.to(device=x.device, dtype=torch.int32).contiguous()
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), int(x.dtype == torch.int8), table.data_ptr(),
             table.numel(), int(bias), out.data_ptr(), x.numel(), stream)
    if err != 0:
        raise RuntimeError(f"acam_lut launch failed: cudaError {err}")
    launches["acam_lut"] += 1
    return out


def acam_lut_2d(x: torch.Tensor, lut: torch.Tensor, bias: int = 128,
                block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """Apply an ACAM LUT to a 2-D int tensor of shape (R, C).

    x: int8/int32 codes in [-bias, 2^n - bias); lut: (2^n,) output codes.
    ``block_rows`` is the reference's tile height and changes nothing here.
    Returns (R, C) int32.
    """
    if x.ndim != 2:
        raise ValueError(f"acam_lut_2d takes (R, C) codes, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _CODE_DTYPES:
        raise TypeError(f"codes must be int8 or int32, got {x.dtype}")
    if lut.ndim != 1:
        raise ValueError(f"lut must be 1-D, got {tuple(lut.shape)}")
    if x.device.type == "cpu":
        return acam_lut_plain(x, lut, bias)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no implementation for device {x.device}")
    with cost.counted(lambda: cost.lut(x.numel(), x.element_size(),
                                       lut.numel())):
        if x.device.type == "meta":  # shapes only: nothing is computed
            return torch.empty(x.shape, dtype=torch.int32, device=x.device)
        return _launch(x, lut, bias)


def acam_lut(x: torch.Tensor, lut: torch.Tensor, bias: int = 128
             ) -> torch.Tensor:
    """N-D wrapper: flatten leading dims to rows."""
    shape = x.shape
    flat = x.reshape(-1, shape[-1]) if x.ndim >= 2 else x.reshape(1, -1)
    return acam_lut_2d(flat, lut, bias=bias).reshape(shape)
