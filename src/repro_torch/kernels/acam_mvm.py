"""Bit-sliced crossbar MVM with Compute-ACAM ADCs on int8 codes.

The port of `repro.kernels.acam_mvm`: x (M, K) int8 times w (K, N) int8 ->
(M, N) int32 on offset-encoded operands, K cut into tiles of ``bk`` rows
(one crossbar when ``bk == cfg.rows``), with the exact or the quantizing
ADC per tile and the offset corrections. The TPU function `_mvm_kernel`
becomes ``csrc/acam_mvm.cu``; the plain PyTorch version is
`acam_mvm_plain`. A CUDA tensor launches the kernel or raises, a CPU tensor
runs the plain version, a ``meta`` tensor gets the output's shape and its
work is reported to an active op counter (`cost`).

The ADC's step comes from ``cfg.rows`` while it is applied per ``bk``-row
tile, as in the Pallas kernel: in quantize mode a call with ``bk !=
cfg.rows`` follows the kernel, not the `repro_torch.core.crossbar` oracle.
``bm``/``bn`` are the reference's output tile sizes and change nothing.

What the host computes for a launch lives here, where the CPU tests reach
it: `mvm_plan` (block tile, K stages, split of K over blocks) and
`mvm_operands` (the padded layouts the kernel takes).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.crossbar import CrossbarConfig, adc_step, sliced_matmul
from . import cost

__all__ = ["acam_mvm", "acam_mvm_plain", "launches", "MvmPlan", "mvm_plan",
           "mvm_operands", "MVM_TILES"]

# kernel launches, one per launch of csrc/acam_mvm.cu
launches = {"acam_mvm": 0}

_F32 = np.float32

# csrc/acam_mvm.cu's block tiles (rows, columns) by (quantize, M <= 16),
# in the order of its `config` argument
MVM_TILES = {(False, False): (128, 128), (False, True): (16, 128),
             (True, False): (64, 32), (True, True): (16, 64)}
_EXACT_STAGE = 64        # K bytes per pipeline stage of the exact mode
_SMS = 132               # the H100's SMs


@dataclasses.dataclass(frozen=True)
class MvmPlan:
    """How one call is laid out and split over blocks of the kernel."""
    quantize: bool
    config: int            # index into MVM_TILES' order
    kstage: int            # K bytes per stage (a multiple of 32)
    rows: int              # real K rows per stage (bk; kstage when exact)
    n_stages: int
    kp: int                # staged K: n_stages * kstage
    ldw: int               # w's row stride: N rounded up to 16
    splits: int            # K splits over blocks (partials added)
    stages_per_split: int


def mvm_plan(M: int, N: int, K: int, bk: int, quantize: bool) -> MvmPlan:
    """The kernel's block tile and the split of K: a quantizing stage is one
    ``bk``-row tile (rounded up to 32 bytes), an exact stage 64 rows. K is
    split (on stage boundaries) until there are 32 blocks per SM in
    quantize mode, whose blocks are bound by their ADC steps; in exact mode
    only when the tiles do not fill the SMs once (then to two blocks per
    SM), as split partials cost a zeroed output and atomic adds. Both rules
    are heuristics: the split sweep at the end of chip_smoke.py's phase 3
    times every split beside the one they pick (PERF.md gives its
    readings)."""
    small = M <= 16
    config = list(MVM_TILES).index((quantize, small))
    bm, bn = MVM_TILES[(quantize, small)]
    kstage = -(-bk // 32) * 32 if quantize else _EXACT_STAGE
    rows = bk if quantize else kstage
    n_stages = -(-K // rows)
    tiles = -(-M // bm) * -(-N // bn)
    if quantize:
        target = 32 * _SMS
    else:
        target = 1 if tiles >= _SMS else 2 * _SMS
    want = max(1, min(n_stages, -(-target // tiles)))
    per = -(-n_stages // want)
    return MvmPlan(quantize=quantize, config=config, kstage=kstage,
                   rows=rows, n_stages=n_stages, kp=n_stages * kstage,
                   ldw=-(-N // 16) * 16, splits=-(-n_stages // per),
                   stages_per_split=per)


def mvm_operands(x: torch.Tensor, w: torch.Tensor, cfg: CrossbarConfig,
                 plan: MvmPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """x (M, kp) and w (kp, ldw) as the kernel takes them: each stage's
    ``plan.rows`` K rows padded to ``plan.kstage``, the padding the code
    whose offset-encoded value is 0 (-2^(bits-1); 0 in exact mode, where
    codes are not offset); w's columns padded to ``ldw``. Returns the
    inputs themselves (no copy) when nothing is padded."""
    M, K = x.shape
    N = w.shape[1]
    T, rows, ks = plan.n_stages, plan.rows, plan.kstage
    if plan.quantize:
        px, pw = -(1 << (cfg.input_bits - 1)), -(1 << (cfg.weight_bits - 1))
    else:
        px = pw = 0
    if T * rows != K or ks != rows:
        flat = x.new_full((M, T * rows), px)
        flat[:, :K] = x
        x = x.new_full((M, T, ks), px)
        x[:, :, :rows] = flat.view(M, T, rows)
        x = x.view(M, T * ks)
        flat = w.new_full((T * rows, N), pw)
        flat[:K] = w
        w = w.new_full((T, ks, N), pw)
        w[:, :rows] = flat.view(T, rows, N)
        w = w.view(T * ks, N)
    if plan.ldw != N:
        w = torch.nn.functional.pad(w, (0, plan.ldw - N))
    return x.contiguous(), w.contiguous()


def acam_mvm_plain(x: torch.Tensor, w: torch.Tensor,
                   cfg: CrossbarConfig = CrossbarConfig(),
                   bk: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (K tiles of ``bk`` rows)."""
    return sliced_matmul(x, w, cfg, bk or cfg.rows)


def _launch(x: torch.Tensor, w: torch.Tensor, cfg: CrossbarConfig, bk: int,
            plan: MvmPlan | None = None) -> torch.Tensor:
    """One launch on the current stream; ``plan`` defaults to the call's
    own (`mvm_plan`)."""
    import ctypes

    from .build import bind  # built at first launch, never at import
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = bind("acam_mvm", "acam_mvm_launch",
              [P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, I, I, F, F, P])
    M, K = x.shape
    N = w.shape[1]
    step = adc_step(cfg, cfg.rows)
    quantize = step is not None
    step32 = _F32(step if quantize else 1.0)
    plan = plan or mvm_plan(M, N, K, bk, quantize)
    xp, wp = mvm_operands(x, w, cfg, plan)
    alloc = torch.zeros if plan.splits > 1 else torch.empty
    out = alloc((M, N), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(xp.data_ptr(), wp.data_ptr(), out.data_ptr(), M, N, plan.ldw,
             plan.kp, plan.kstage, plan.config, plan.splits,
             plan.stages_per_split, K, cfg.input_bits, cfg.weight_bits,
             cfg.dac_bits, cfg.cell_bits, int(quantize), float(step32),
             float(_F32(1) / step32), stream)
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
    if x.device.type == "cpu":
        return acam_mvm_plain(x, w, cfg, bk)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no implementation for device {x.device}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"the CUDA kernel takes int8 codes, got "
                        f"{x.dtype} x {w.dtype}")
    if bk % 4 or not 4 <= bk <= 256 or cfg.input_bits > 8 \
            or cfg.weight_bits > 8:
        raise ValueError(f"the CUDA kernel takes bk a multiple of 4 up "
                         f"to 256 and operands of at most 8 bits, got "
                         f"bk={bk}, {cfg}")
    planes = (1 if adc_step(cfg, cfg.rows) is None
              else cfg.num_input_slices * cfg.num_weight_slices)
    with cost.counted(lambda: cost.mvm(x.shape[0], x.shape[1], w.shape[1],
                                       planes)):
        if x.device.type == "meta":  # shapes only: nothing is computed
            return torch.empty((x.shape[0], w.shape[1]), dtype=torch.int32,
                               device=x.device)
        return _launch(x, w, cfg, bk)
