"""The fused Compute-ACAM softmax (paper Fig. 8) on LOGIT codes.

The port of `repro.kernels.acam_softmax`: per row, exp LUT -> PoT decode ->
row sum -> PoT encode -> log LUT -> subtract -> exp_prob LUT, from LOGIT
(1-4-3) codes to PROB (0-0-8) codes. The TPU function `_softmax_kernel`
becomes ``csrc/acam_softmax.cu``; the plain PyTorch version is
`acam_softmax_codes_plain`. A CUDA tensor launches the kernel or raises, a
CPU tensor runs the plain version, a ``meta`` tensor gets the output's
shape and its work is reported to an active op counter (`cost`).

As in the reference, any ``mode`` other than ``"pot"`` takes the pot_fine
tables, so ``"uniform"`` runs as ``"pot_fine"`` here (the staged
`repro_torch.core.softmax.acam_softmax` is the one with a uniform mode).
The row sum runs over the row padded to a multiple of 128 columns: the
padded columns add exact zeros but shape the runs of the sum's order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import ops as acam_ops
from ..core.ops import LOGIT_FMT
from ..core.quant import pot_decode_runtime, pot_encode, ref_sum
from . import cost
from .acam_attention import pot_consts

__all__ = ["acam_softmax_codes", "acam_softmax_kernel",
           "acam_softmax_codes_plain", "softmax_kernel_tables", "launches",
           "LANES"]

LANES = 128

# kernel launches, one per launch of csrc/acam_softmax.cu
launches = {"acam_softmax": 0}

_CODE_DTYPES = (torch.int8, torch.int32)


def softmax_kernel_tables(mode: str):
    """(exp_lut, pot_vals, log_lut, prob_lut, e_min, octave_step,
    frac_shift) of the kernel for ``mode``, numpy.

    ``pot_vals`` holds the float32 value of each of the 256 PoT codes as the
    reference's kernel decodes them at run time (`pot_decode_runtime`).
    """
    exp_op = acam_ops.get_op("exp_pot" if mode == "pot" else "exp_pot_fine")
    log_op = acam_ops.get_op("log" if mode == "pot" else "log_fine")
    prob_op = acam_ops.get_op("exp_prob")
    pot = exp_op.out_fmt
    frac_shift = LOGIT_FMT.frac_bits - log_op.out_fmt.frac_bits
    pot_vals = pot_decode_runtime(np.arange(pot.num_codes), pot.e_min,
                                  pot.octave_step)
    return (exp_op._lut.astype(np.int32), pot_vals,
            log_op._lut.astype(np.int32), prob_op._lut.astype(np.int32),
            float(pot.e_min), float(pot.octave_step), frac_shift)


_DEVICE_TABLES: dict = {}


def _device_tables(mode: str, device):
    key = (mode == "pot", str(device))
    if key not in _DEVICE_TABLES:
        *tabs, e_min, step, fs = softmax_kernel_tables(mode)
        _DEVICE_TABLES[key] = (*(torch.from_numpy(t).to(device) for t in tabs),
                               e_min, step, fs)
    return _DEVICE_TABLES[key]


def _padded(L: int) -> int:
    return L + (-L) % LANES


def acam_softmax_codes_plain(x_codes: torch.Tensor, mode: str = "pot"
                             ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, step by step."""
    exp_lut, pot_vals, log_lut, prob_lut, e_min, step, fs = _device_tables(
        mode, x_codes.device)
    L = x_codes.shape[1]
    xc = x_codes.to(torch.int32)
    e = pot_vals[exp_lut[torch.clamp(xc + 128, 0, 255).long()].long()]
    # padded columns are masked out of the sum: exact zeros
    S = ref_sum(torch.nn.functional.pad(e, (0, _padded(L) - L)))
    log_s = log_lut[pot_encode(S, e_min, step).long()]
    d = torch.clamp(xc - (log_s * (1 << fs))[:, None], LOGIT_FMT.code_min,
                    LOGIT_FMT.code_max)
    return prob_lut[(d + 128).long()]


def _launch(x_codes: torch.Tensor, mode: str) -> torch.Tensor:
    import ctypes

    from .build import bind  # built at first launch, never at import
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = bind("acam_softmax", "acam_softmax_launch",
              [P, I, P, P, P, P, P, I, I, I, F, F, F, F, I, P])
    dev = x_codes.device
    exp_lut, pot_vals, log_lut, prob_lut, e_min, step, fs = _device_tables(
        mode, dev)
    x = x_codes.contiguous()
    R, L = x.shape
    out = torch.empty((R, L), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x.data_ptr(), int(x.dtype == torch.int8), exp_lut.data_ptr(),
             pot_vals.data_ptr(), log_lut.data_ptr(), prob_lut.data_ptr(),
             out.data_ptr(), R, L, _padded(L), *pot_consts(e_min, step), fs,
             stream)
    if err != 0:
        raise RuntimeError(f"acam_softmax launch failed: cudaError {err}")
    launches["acam_softmax"] += 1
    return out


def acam_softmax_codes(x_codes: torch.Tensor, mode: str = "pot",
                       block_rows: int = 128) -> torch.Tensor:
    """x_codes: (R, L) int8/int32 LOGIT codes -> (R, L) int32 PROB codes.

    Masked positions must already be LOGIT_FMT.code_min (the div-add stage
    writes the mask before softmax, paper Fig. 12). ``block_rows`` is the
    reference's tile height and changes nothing here.
    """
    if x_codes.ndim != 2:
        raise ValueError(f"acam_softmax_codes takes (R, L) codes, got "
                         f"{tuple(x_codes.shape)}")
    if x_codes.dtype not in _CODE_DTYPES:
        raise TypeError(f"codes must be int8 or int32, got {x_codes.dtype}")
    if x_codes.numel() == 0:
        return torch.zeros(x_codes.shape, dtype=torch.int32,
                           device=x_codes.device)
    if x_codes.device.type == "cpu":
        return acam_softmax_codes_plain(x_codes, mode)
    if x_codes.device.type not in ("cuda", "meta"):
        raise ValueError(f"no implementation for device {x_codes.device}")
    with cost.counted(lambda: cost.softmax(x_codes.numel(),
                                           x_codes.element_size())):
        if x_codes.device.type == "meta":  # shapes only: nothing computed
            return torch.empty(x_codes.shape, dtype=torch.int32,
                               device=x_codes.device)
        return _launch(x_codes, mode)


def acam_softmax_kernel(x: torch.Tensor, mode: str = "pot") -> torch.Tensor:
    """Float logits -> float probs through the fused kernel (N-D wrapper)."""
    prob_op = acam_ops.get_op("exp_prob")
    shape = x.shape
    codes = LOGIT_FMT.encode(x.float()).reshape(-1, shape[-1])
    p = acam_softmax_codes(codes, mode=mode)
    return prob_op.out_fmt.decode(p).reshape(shape)
