"""The fused Fig.-12 RACE-IT attention on int8 codes over a block-paged pool.

The port of `repro.kernels.acam_attention` for the paged layout (the one
serving runs). `acam_attention_codes` returns what the reference returns:
``out`` (G, Sq, D) int32, the PROB-code . V accumulator, and ``cmax``, the
call-wide max PROB code the caller rebuilds the probability scale from.

Two implementations of one function live here:

* the CUDA kernel ``csrc/acam_attention.cu`` (two launches: pass A row sums
  and the global cmax, pass B PROB codes . V), taken for CUDA tensors;
* `acam_attention_codes_plain`, plain PyTorch in the reference's op order,
  taken for CPU tensors. The CPU tests hold it bit for bit against the JAX
  kernel, and the chip check holds the CUDA kernel against it.

The wrapper picks by the device of its inputs alone: a CUDA tensor launches
the kernel or raises, a CPU tensor runs the plain version.

Row coupling is part of the function, as in the reference: the call-wide
cmax requantizes every row of the call, including the pad rows of slots that
do not take part in a chunk call (zero-length groups excepted).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import ops as acam_ops
from ..core.ops import LOGIT_FMT, PROB_FMT
from ..core.quant import PoTFormat, pot_decode_f32, pot_encode, recip_scale

__all__ = ["acam_attention_codes", "acam_attention_codes_plain",
           "acam_attention_decode_codes", "acam_attention_decode_gqa_codes",
           "softmax_tables", "requant_scale", "requant_code_table",
           "FUSED_SOFTMAX_MODES", "launches"]

FUSED_SOFTMAX_MODES = ("pot", "pot_fine", "uniform")

_EXP_OPS = {"pot": "exp_pot", "pot_fine": "exp_pot_fine",
            "uniform": "exp_uniform"}
_LOG_OPS = {"pot": "log", "pot_fine": "log_fine", "uniform": "log"}

# kernel launches, one count per launch (a call launches pass A and pass B);
# a run resets it and reads it back to prove the path went through the kernel
launches = {"acam_attention": 0}

_F32 = np.float32


def softmax_tables(mode: str):
    """(exp_val, log_lut, prob_lut, e_min, octave_step, frac_shift) for a mode.

    numpy tables equal to the reference's: ``exp_val`` is the exp LUT
    composed with its output decode (float32, as the reference's jitted
    graph folds it), ``log_lut``/``prob_lut`` int32. ``e_min``/
    ``octave_step`` describe the LOG stage's PoT input format; "uniform"
    still takes a PoT-encoded row sum.
    """
    if mode not in FUSED_SOFTMAX_MODES:
        raise ValueError(
            f"fused attention softmax_mode must be one of {FUSED_SOFTMAX_MODES},"
            f" got {mode!r}")
    exp_op = acam_ops.get_op(_EXP_OPS[mode])
    log_op = acam_ops.get_op(_LOG_OPS[mode])
    prob_op = acam_ops.get_op("exp_prob")
    ec = exp_op._lut.astype(np.int64)
    if isinstance(exp_op.out_fmt, PoTFormat):
        exp_val = pot_decode_f32(ec, exp_op.out_fmt.e_min,
                                 exp_op.out_fmt.octave_step)
    else:  # uniform ScaledFormat: decode is a plain scale multiply
        exp_val = (ec.astype(_F32) * _F32(exp_op.out_fmt.scale)).astype(_F32)
    pot_in = log_op.in_fmt
    frac_shift = LOGIT_FMT.frac_bits - log_op.out_fmt.frac_bits
    return (exp_val, log_op._lut.astype(np.int32),
            prob_op._lut.astype(np.int32), float(pot_in.e_min),
            float(pot_in.octave_step), frac_shift)


_DEVICE_TABLES: dict = {}


def _device_tables(mode: str, device):
    key = (mode, str(device))
    if key not in _DEVICE_TABLES:
        ev, ll, pl, e_min, step, fs = softmax_tables(mode)
        _DEVICE_TABLES[key] = (torch.from_numpy(ev).to(device),
                               torch.from_numpy(ll).to(device),
                               torch.from_numpy(pl).to(device), e_min, step, fs)
    return _DEVICE_TABLES[key]


def requant_scale(cmax: torch.Tensor) -> torch.Tensor:
    """`quantize_tensor(probs, bits=8).scale` from the max PROB code."""
    amax = cmax.float() * PROB_FMT.scale
    return recip_scale(amax, 127)


def requant_code_table(cmax: torch.Tensor, prob_lut: torch.Tensor) -> torch.Tensor:
    """PROB-code -> re-quantized int8 code (256 entries, int32)."""
    p_tab = prob_lut.float() * PROB_FMT.scale
    return torch.clamp(torch.round(p_tab / requant_scale(cmax)),
                       -128, 127).to(torch.int32)


def _check_page_size(page_size: int) -> None:
    # the row sum adds each page's keys in the reference's reduction order,
    # which is known for runs of <= 32 keys and for multiples of 32
    if not (page_size <= 32 or page_size % 32 == 0):
        raise ValueError(f"page_size must be <= 32 or a multiple of 32 "
                         f"(the row-sum order), got {page_size}")


def _block_sum(e: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in XLA's CPU order: runs of 32 keys added one
    by one, then the runs in order."""
    n = e.shape[-1]
    total = None
    for t0 in range(0, n, 32):
        s = e[..., t0]
        for t in range(t0 + 1, min(t0 + 32, n)):
            s = s + e[..., t]
        total = s if total is None else total + s
    return total


def acam_attention_codes_plain(q_codes, k_codes, v_codes, logit_scale,
                               mask, kv_len, mode, block_table, page_size,
                               groups_per_slot, cmax_floor=None):
    """Plain PyTorch version of the paged kernel, in the reference's op order.

    Arguments as in `acam_attention_codes` (already checked). The integer
    products run in float64, exact for these ranges on any device.
    """
    exp_val, log_lut, prob_lut, e_min, step, fs = _device_tables(
        mode, q_codes.device)
    G, Sq, D = q_codes.shape
    dev = q_codes.device
    ps, gps = page_size, groups_per_slot
    max_pages = block_table.shape[1]
    Sk = max_pages * ps
    g = torch.arange(G, device=dev)
    rows = (block_table.long()[g // gps] * gps + (g % gps)[:, None])  # (G, mp)
    kg = k_codes[rows].reshape(G, Sk, D)
    vg = v_codes[rows].reshape(G, Sk, D)
    r = torch.bmm(q_codes.double(), kg.double().transpose(1, 2))
    logits = r.float() * logit_scale.float()
    xc = torch.clamp(torch.round(logits / LOGIT_FMT.scale), LOGIT_FMT.code_min,
                     LOGIT_FMT.code_max).to(torch.int32)
    if mask is not None:
        m = mask[g // (G // mask.shape[0])] != 0
        xc = torch.where(m, xc, torch.full_like(xc, LOGIT_FMT.code_min))
    lens = kv_len.to(torch.int32)[:, None, None]
    valid = torch.arange(Sk, device=dev)[None, None, :] < lens
    e = torch.where(valid, exp_val[(xc + 128).long()], torch.zeros((), device=dev))
    S = torch.zeros((G, Sq), dtype=torch.float32, device=dev)
    for j in range(max_pages):
        S = S + _block_sum(e[..., j * ps:(j + 1) * ps])
    xmax = torch.where(valid, xc, torch.full_like(xc, LOGIT_FMT.code_min)).amax(-1)
    L = log_lut[pot_encode(S, e_min, step).long()]
    dmax = torch.clamp(xmax - L * (1 << fs), LOGIT_FMT.code_min, LOGIT_FMT.code_max)
    c_row = prob_lut[(dmax + 128).long()]
    c_row = torch.where(lens[:, :, 0] > 0, c_row, torch.zeros_like(c_row))
    floor = (torch.zeros((), dtype=torch.int32, device=dev) if cmax_floor is None
             else torch.as_tensor(cmax_floor, dtype=torch.int32, device=dev))
    cmax = torch.maximum(c_row.amax(), floor)
    d = torch.clamp(xc - (L * (1 << fs))[..., None], LOGIT_FMT.code_min,
                    LOGIT_FMT.code_max)
    pc = requant_code_table(cmax, prob_lut)[(d + 128).long()]
    pc = torch.where(valid, pc, torch.zeros_like(pc))
    out = torch.bmm(pc.double(), vg.double()).to(torch.int32)
    return out, cmax.to(torch.int32)


def _launch_kernel(q_codes, k_codes, v_codes, logit_scale, mask, kv_len, mode,
                   block_table, page_size, groups_per_slot, cmax_floor):
    import ctypes

    from .build import library  # built at first launch, never at import
    lib = library("acam_attention")
    fn = lib.acam_attention_paged_launch
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [I, P, P, P, P, P, P, I, P, P, P, P, P, P, P,
                       I, I, I, I, I, I, F, F, F, F, I, P]
        fn.restype = ctypes.c_int
    dev = q_codes.device
    exp_val, log_lut, prob_lut, e_min, step, fs = _device_tables(mode, dev)
    G, Sq, D = q_codes.shape
    max_pages = block_table.shape[1]
    out = torch.empty((G, Sq, D), dtype=torch.int32, device=dev)
    row_sum = torch.empty((G * Sq,), dtype=torch.float32, device=dev)
    if cmax_floor is None:
        cmax = torch.zeros((1,), dtype=torch.int32, device=dev)
    else:
        cmax = torch.as_tensor(cmax_floor, dtype=torch.int32,
                               device=dev).reshape(1).clone()
    s1 = logit_scale.to(torch.float32).reshape(1).contiguous()
    mask_ptr, mask_div = None, 1
    if mask is not None:
        mask_ptr, mask_div = mask.data_ptr(), G // mask.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    consts = (float(_F32(e_min)), float(_F32(1.0 / step)),
              float(_F32(2.0 ** (e_min - 1))),
              float(_F32(2.0 ** (e_min - step / 2))))
    for pass_id in (0, 1):
        err = fn(pass_id, q_codes.data_ptr(), k_codes.data_ptr(),
                 v_codes.data_ptr(), block_table.data_ptr(), kv_len.data_ptr(),
                 mask_ptr, mask_div, s1.data_ptr(), exp_val.data_ptr(),
                 log_lut.data_ptr(), prob_lut.data_ptr(), out.data_ptr(),
                 row_sum.data_ptr(), cmax.data_ptr(), G, Sq, D, page_size,
                 max_pages, groups_per_slot, *consts, fs, stream)
        if err != 0:
            raise RuntimeError(f"acam_attention pass {'AB'[pass_id]} launch "
                               f"failed: cudaError {err}")
        launches["acam_attention"] += 1
    return out, cmax.reshape(())


def acam_attention_codes(
    q_codes: torch.Tensor,   # (G, Sq, D) int8 — G folds slots x groups
    k_codes: torch.Tensor,   # (n_pages * groups_per_slot, page_size, D) int8
    v_codes: torch.Tensor,   # (n_pages * groups_per_slot, page_size, D) int8
    logit_scale: torch.Tensor,           # () f32: s_q * s_k (1/sqrt(d) folded)
    mask: Optional[torch.Tensor] = None,  # (Gm, Sq, Sk) bool/int8, 0 = masked
    kv_len: Optional[torch.Tensor] = None,  # (G,) int32 valid keys per group
    mode: str = "pot",
    block_table: Optional[torch.Tensor] = None,  # (n_slots, max_pages) int32
    page_size: Optional[int] = None,
    groups_per_slot: Optional[int] = None,
    cmax_floor=None,                     # () int32: external PROB-max seed
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Fig.-12 attention on int8 codes over a block-paged KV pool.

    Physical page ``p`` of the pool holds the ``groups_per_slot`` group
    stripes of one logical page at rows ``[p*gps, (p+1)*gps)``, and
    ``block_table[slot, j]`` names the page backing slot ``slot``'s logical
    page ``j`` (page 0 is the trash page; every entry must lie in the pool).
    Keys past ``kv_len[g]`` do not exist for group ``g``; zero-length
    groups give zero rows and leave cmax alone. A masked key stays in the
    row sum at the LOGIT minimum. ``mask`` may carry one row per
    ``G // Gm`` consecutive groups: ``Gm == G`` is the reference's form,
    and both float wrappers pass one mask per slot (``Gm == n_slots``)
    rather than copy it to every group.
    Returns (out (G, Sq, D) int32, cmax () int32).
    """
    if block_table is None:
        raise NotImplementedError(
            "only the block-paged layout is ported; the contiguous and "
            "one-tile variants come with the solo generate path")
    if page_size is None or groups_per_slot is None:
        raise ValueError("paged attention needs page_size and groups_per_slot")
    if kv_len is None or kv_len.ndim != 1:
        raise ValueError("paged attention requires a per-group (G,) kv_len")
    if mode not in FUSED_SOFTMAX_MODES:
        raise ValueError(f"mode must be one of {FUSED_SOFTMAX_MODES}, got {mode!r}")
    _check_page_size(page_size)
    G, Sq, D = q_codes.shape
    gps = groups_per_slot
    n_slots, max_pages = block_table.shape
    dev = q_codes.device
    if G != n_slots * gps:
        raise ValueError(f"paged G={G} != n_slots*groups_per_slot = "
                         f"{n_slots}*{gps}")
    for name, t in (("k", k_codes), ("v", v_codes)):
        if t.ndim != 3 or t.shape[1] != page_size or t.shape[2] != D \
                or t.shape[0] % gps:
            raise ValueError(f"paged {name} pool must be (n_pages*{gps}, "
                             f"{page_size}, {D}), got {tuple(t.shape)}")
    for name, t, dt in (("q", q_codes, torch.int8), ("k", k_codes, torch.int8),
                        ("v", v_codes, torch.int8),
                        ("block_table", block_table, torch.int32),
                        ("kv_len", kv_len, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if kv_len.shape[0] != G:
        raise ValueError(f"kv_len must have one entry per group: "
                         f"{tuple(kv_len.shape)} for G={G}")
    Sk = max_pages * page_size
    kv_len = torch.clamp(kv_len, max=Sk)
    if mask is not None:
        if mask.ndim != 3 or mask.shape[1:] != (Sq, Sk) or G % mask.shape[0]:
            raise ValueError(f"mask must be (Gm, {Sq}, {Sk}) with Gm | {G}, "
                             f"got {tuple(mask.shape)}")
        mask = mask.to(torch.int8).contiguous()
    if dev.type == "cuda":
        if D % 4 or D > 128:
            raise ValueError(f"the CUDA kernel takes head dims that are a "
                             f"multiple of 4 up to 128, got {D}")
        return _launch_kernel(q_codes, k_codes, v_codes, logit_scale, mask,
                              kv_len, mode, block_table, page_size, gps,
                              cmax_floor)
    if dev.type != "cpu":
        raise ValueError(f"no implementation for device {dev}")
    return acam_attention_codes_plain(q_codes, k_codes, v_codes, logit_scale,
                                      mask, kv_len, mode, block_table,
                                      page_size, gps, cmax_floor)


def acam_attention_decode_codes(q_codes, k_codes, v_codes, logit_scale, kv_len,
                                mask=None, mode="pot", block_table=None,
                                page_size=None, groups_per_slot=None,
                                cmax_floor=None):
    """Decode-mode entry (Sq = 1); the flat layout folds every query head of a
    slot into its group stripe (``groups_per_slot`` defaults to G/n_slots)."""
    if q_codes.shape[1] != 1:
        raise ValueError(f"decode path expects Sq=1, got {q_codes.shape[1]}")
    if block_table is not None and groups_per_slot is None:
        groups_per_slot = q_codes.shape[0] // block_table.shape[0]
    return acam_attention_codes(q_codes, k_codes, v_codes, logit_scale, mask,
                                kv_len=kv_len, mode=mode,
                                block_table=block_table, page_size=page_size,
                                groups_per_slot=groups_per_slot,
                                cmax_floor=cmax_floor)


def acam_attention_decode_gqa_codes(q_codes, k_codes, v_codes, logit_scale,
                                    kv_len, mask=None, mode="pot",
                                    block_table=None, page_size=None,
                                    groups_per_slot=None, cmax_floor=None):
    """GQA-native decode: one group per KV head, its ``rep`` sharing queries
    on the row dimension (``groups_per_slot`` = KV)."""
    if block_table is not None and groups_per_slot is None:
        raise ValueError("GQA paged decode needs groups_per_slot (=KV)")
    return acam_attention_codes(q_codes, k_codes, v_codes, logit_scale, mask,
                                kv_len=kv_len, mode=mode,
                                block_table=block_table, page_size=page_size,
                                groups_per_slot=groups_per_slot,
                                cmax_floor=cmax_floor)
