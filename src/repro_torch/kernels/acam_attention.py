"""The fused Fig.-12 RACE-IT attention on int8 codes.

The port of `repro.kernels.acam_attention`. `acam_attention_codes` returns
what the reference returns: ``out`` (G, Sq, D) int32, the PROB-code . V
accumulator, and ``cmax``, the call-wide max PROB code the caller rebuilds
the probability scale from. Three layouts of the one TPU function
(`_attn_kernel` and its one-tile twin `_attn_kernel_single`), each with a
CUDA kernel and a plain PyTorch version in the reference's op order:

* block-paged k/v (``block_table`` given): ``csrc/acam_attention.cu``
  ``paged_sums``/``paged_probv`` (its pages split over blocks by
  `paged_plan`), plain `acam_attention_codes_plain`;
* contiguous k/v (G, Sk, D), two passes over key blocks of ``bk`` keys:
  ``csrc/acam_attention.cu`` ``contiguous_sums``/``contiguous_probv`` (each
  group's keys split over blocks by `contiguous_plan`), plain
  `acam_attention_contiguous_plain`;
* contiguous k/v that fit one tile (the reference's ``ng == nq == nk == 1``:
  G <= 8, Sq <= 256, Sk <= 512): ``csrc/acam_attention_single.cu``, one
  cooperative launch split by `single_plan`, plain
  `acam_attention_single_plain`.

The shape rule alone picks between the last two, as in the reference. The
wrapper picks by the device of its inputs alone: a CUDA tensor launches the
kernel or raises, a CPU tensor runs the plain version, and a ``meta``
tensor (the dry-run) gets the kernel's outputs with nothing computed; its
work is reported to an active op counter (`repro_torch.kernels.cost`). The
CPU tests hold the plain versions bit for bit against the Pallas kernels,
and the chip check holds each CUDA kernel against its plain version.
``scale_by_sqrt_d`` divides the logits by sqrt(d) in every layout as the
reference does (`sqrt_d_rule`); the CUDA kernels take head dims up to 320
(gemma3-4b's), padded to a multiple of 4 with zero codes.

Row coupling is part of the function, as in the reference: the call-wide
cmax requantizes every row of the call, including the pad rows of slots that
do not take part in a chunk call and the fully masked rows of a left-padded
prompt (zero-length groups excepted).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import ops as acam_ops
from ..core.ops import LOGIT_FMT, PROB_FMT
from ..core.quant import (PoTFormat, pot_decode_f32, pot_encode, recip_scale,
                          ref_sum, sum_chunks)
from . import cost

__all__ = ["acam_attention_codes", "acam_attention_codes_plain",
           "acam_attention_contiguous_plain", "acam_attention_single_plain",
           "acam_attention_decode_codes", "acam_attention_decode_gqa_codes",
           "softmax_tables", "requant_scale", "requant_code_table",
           "sum_chunks", "key_block", "one_tile", "FUSED_SOFTMAX_MODES",
           "DEFAULT_BLOCK_Q", "DEFAULT_BLOCK_K", "DEFAULT_BLOCK_G", "launches",
           "pot_consts", "PagedPlan", "paged_plan", "PAGED_ROWS",
           "ContiguousPlan", "contiguous_plan", "single_plan",
           "CONTIGUOUS_ROWS", "sqrt_d_rule", "CUDA_MAX_HEAD_DIM"]

FUSED_SOFTMAX_MODES = ("pot", "pot_fine", "uniform")

_EXP_OPS = {"pot": "exp_pot", "pot_fine": "exp_pot_fine",
            "uniform": "exp_uniform"}
_LOG_OPS = {"pot": "log", "pot_fine": "log_fine", "uniform": "log"}

# the reference's tile sizes (its serving path never overrides them)
DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 512
DEFAULT_BLOCK_G = 8
_LANES = 128

# kernel launches, one count per launch (a two-pass call launches twice, a
# one-tile call once); a run resets them and reads them back to prove the
# path went through the kernels
launches = {"acam_attention_paged": 0, "acam_attention": 0,
            "acam_attention_single": 0}

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
    # the paged kernel adds each page's keys in runs of 32 (`sum_chunks`
    # of a page), which is the reference's order for these sizes
    if not (page_size <= 32 or page_size % 32 == 0):
        raise ValueError(f"page_size must be <= 32 or a multiple of 32 "
                         f"(the row-sum order), got {page_size}")


def key_block(Sk: int) -> int:
    """Keys per block of the contiguous layout (the reference's ``bk``)."""
    return min(DEFAULT_BLOCK_K, max(_LANES, Sk))


def one_tile(G: int, Sq: int, Sk: int) -> bool:
    """The reference's one-tile rule (``ng == nq == nk == 1``, not paged)."""
    bg = min(DEFAULT_BLOCK_G, G)
    bq = min(DEFAULT_BLOCK_Q, max(8, Sq))
    return -(-G // bg) == 1 and -(-Sq // bq) == 1 and -(-Sk // key_block(Sk)) == 1


def sqrt_d_rule(logit_scale: torch.Tensor, scale_by_sqrt_d):
    """The reference's ``scale_by_sqrt_d`` rule: (logit scale, rsd).

    Where sqrt(d) (rounded to float32) is a power of two the division
    commutes with rounding and folds into the scalar; otherwise the kernels
    take ``rsd = f32(1 / sqrt(d))`` and multiply every logit by it after
    ``* s1``: the reference divides by a trace-time constant inside a jitted
    graph, which XLA rewrites into that reciprocal multiply
    (`repro_torch.core.quant`). ``rsd`` is None when nothing is left to do.
    """
    if scale_by_sqrt_d is None:
        return logit_scale, None
    sqrt_d = np.sqrt(_F32(scale_by_sqrt_d), dtype=_F32)
    if float(np.log2(sqrt_d)) % 1.0 == 0.0:
        return logit_scale / float(sqrt_d), None
    return logit_scale, float(_F32(1) / sqrt_d)


def _logit_codes(q, k, s1, mask, causal, q_offset, rsd=None):
    """matmul-1 + div-add: (G, Sq, Sk) LOGIT codes, masked keys at the LOGIT
    minimum. ``mask`` (Gm, Sq, Sk) serves G // Gm consecutive groups per row;
    else ``causal`` masks key kpos of row i when kpos > i + q_offset. The
    integer products run in float64, exact for these ranges on any device;
    ``rsd`` (`sqrt_d_rule`) multiplies the float32 logits after ``* s1``."""
    G, Sq, _ = q.shape
    dev = q.device
    r = torch.bmm(q.double(), k.double().transpose(1, 2))
    logits = r.float() * s1.float()
    if rsd is not None:
        logits = logits * rsd
    xc = torch.clamp(torch.round(logits / LOGIT_FMT.scale), LOGIT_FMT.code_min,
                     LOGIT_FMT.code_max).to(torch.int32)
    if mask is not None:
        g = torch.arange(G, device=dev)
        m = mask[g // (G // mask.shape[0])] != 0
    elif causal:
        kpos = torch.arange(k.shape[1], device=dev)
        qpos = torch.arange(Sq, device=dev)
        # a Python offset stays a Python number: a host-to-device copy
        # would wait for the stream
        off = (q_offset.to(device=dev, dtype=torch.int32)
               if isinstance(q_offset, torch.Tensor) else int(q_offset))
        m = (kpos[None, :] <= qpos[:, None] + off)[None]
    else:
        return xc
    return torch.where(m, xc, torch.full_like(xc, LOGIT_FMT.code_min))


def _row_finish(S, xmax, lens, per_row, log_lut, prob_lut, e_min, step, fs,
                cmax_floor):
    """LOG(S), the rows' max PROB codes and the call-wide cmax."""
    L = log_lut[pot_encode(S, e_min, step).long()]
    dmax = torch.clamp(xmax - L * (1 << fs), LOGIT_FMT.code_min,
                       LOGIT_FMT.code_max)
    c_row = prob_lut[(dmax + 128).long()]
    if per_row:  # zero-length groups: all-zero rows, no cmax contribution
        c_row = torch.where(lens[:, None] > 0, c_row, torch.zeros_like(c_row))
    dev = S.device
    floor = (torch.zeros((), dtype=torch.int32, device=dev) if cmax_floor is None
             else torch.as_tensor(cmax_floor, dtype=torch.int32, device=dev))
    return L, torch.maximum(c_row.amax(), floor)


def _prob_v(xc, valid, L, fs, cmax, prob_lut, v):
    """d = x - LOG(S)<<fs -> requantized PROB codes -> int32 product with V."""
    d = torch.clamp(xc - (L * (1 << fs))[..., None], LOGIT_FMT.code_min,
                    LOGIT_FMT.code_max)
    pc = requant_code_table(cmax, prob_lut)[(d + 128).long()]
    pc = torch.where(valid, pc, torch.zeros_like(pc))
    return torch.bmm(pc.double(), v.double()).to(torch.int32)


def _two_pass_plain(q, k, v, s1, mask, lens, per_row, mode, cmax_floor,
                    q_offset, causal, bk, rsd):
    """The streaming kernel's function on logical (G, Sk, D) keys: the row
    sum adds per-block sums of ``bk`` keys in block order."""
    exp_val, log_lut, prob_lut, e_min, step, fs = _device_tables(mode, q.device)
    Sk = k.shape[1]
    xc = _logit_codes(q, k, s1, mask, causal, q_offset, rsd)
    valid = torch.arange(Sk, device=q.device)[None, None, :] < lens[:, None, None]
    e = torch.where(valid, exp_val[(xc + 128).long()],
                    torch.zeros((), device=q.device))
    pad = (-Sk) % bk  # the last block's missing keys add exact zeros
    if pad:
        e = torch.nn.functional.pad(e, (0, pad))
    S = torch.zeros(xc.shape[:2], dtype=torch.float32, device=q.device)
    for j in range(e.shape[-1] // bk):
        S = S + ref_sum(e[..., j * bk:(j + 1) * bk])
    xmax = torch.where(valid, xc, torch.full_like(xc, LOGIT_FMT.code_min)
                       ).amax(-1)
    L, cmax = _row_finish(S, xmax, lens, per_row, log_lut, prob_lut, e_min,
                          step, fs, cmax_floor)
    return _prob_v(xc, valid, L, fs, cmax, prob_lut, v), cmax.to(torch.int32)


def acam_attention_codes_plain(q_codes, k_codes, v_codes, logit_scale,
                               mask, kv_len, mode, block_table, page_size,
                               groups_per_slot, cmax_floor=None, rsd=None):
    """Plain PyTorch version of the paged kernel, in the reference's op order.

    Arguments as in `acam_attention_codes` (already checked). Pages are
    gathered into logical order; each page is one key block.
    """
    G = q_codes.shape[0]
    gps = groups_per_slot
    max_pages = block_table.shape[1]
    g = torch.arange(G, device=q_codes.device)
    rows = (block_table.long()[g // gps] * gps + (g % gps)[:, None])  # (G, mp)
    kg = k_codes[rows].reshape(G, max_pages * page_size, -1)
    vg = v_codes[rows].reshape(G, max_pages * page_size, -1)
    return _two_pass_plain(q_codes, kg, vg, logit_scale, mask,
                           kv_len.to(torch.int32), True, mode, cmax_floor, 0,
                           False, page_size, rsd)


# the paged kernels' split (csrc/acam_attention.cu paged_sums/paged_probv)
PAGED_ROWS = 64                # query rows per block
_PAGED_TARGET_BLOCKS = 4 * 132  # blocks that fill the H100's 132 SMs 4 times


@dataclasses.dataclass(frozen=True)
class PagedPlan:
    """How a paged call is split over blocks: ``units`` row tiles of up to
    64 query rows per group, each group's pages cut into ``splits`` runs of
    ``pages_per_split``, every page staged in tiles of ``key_tile`` keys;
    the LOGIT codes kept for pass B with a page pitch of ``psp`` bytes."""
    row_tiles: int
    units: int
    splits: int
    pages_per_split: int
    key_tile: int
    psp: int


def paged_plan(G: int, Sq: int, max_pages: int, page_size: int) -> PagedPlan:
    """Pages split until the blocks fill the card 4 times over (a
    heuristic; chip_smoke.py's phase 3 times every split beside it)."""
    row_tiles = -(-Sq // PAGED_ROWS)
    units = G * row_tiles
    want = max(1, min(max_pages, -(-_PAGED_TARGET_BLOCKS // units)))
    per = -(-max_pages // want)
    if page_size <= 64:
        key_tile = page_size
    else:
        key_tile = 64 if page_size % 64 == 0 else 32
    return PagedPlan(row_tiles=row_tiles, units=units,
                     splits=-(-max_pages // per), pages_per_split=per,
                     key_tile=key_tile, psp=-(-page_size // 16) * 16)


# the contiguous kernels' split (csrc/acam_contiguous.cuh)
CONTIGUOUS_ROWS = 64             # query rows per block
_CONTIGUOUS_TARGET_BLOCKS = 4 * 132  # blocks that fill the 132 SMs 4 times
_PREFILL_SPAN_RUNS = 8           # runs a span takes past 16 rows a unit
_SINGLE_BLOCKS = 64              # one-tile CTAs, all co-resident


@dataclasses.dataclass(frozen=True)
class ContiguousPlan:
    """How a contiguous call is split over blocks: ``units`` row tiles of
    up to 64 query rows per group; each group's keys cut into ``splits``
    spans of ``per`` runs of its one key block of ``bk`` keys (the runs of
    `sum_chunks(bk)`), or of ``per`` whole key blocks when it has
    ``blocks`` > 1; the LOGIT codes kept for pass B with a row pitch of
    ``psp`` bytes."""
    row_tiles: int
    units: int
    blocks: int
    runs: int
    splits: int
    per: int
    psp: int


def _plan(Sk: int, bk: int, row_tiles: int, units: int, want: int,
          per: int | None = None) -> ContiguousPlan:
    """``want`` spans per unit, as near as whole runs or blocks allow, or
    spans of ``per`` runs of the one key block."""
    blocks = -(-Sk // bk)
    runs = len(sum_chunks(bk))
    n = runs if blocks == 1 else blocks
    if not per or blocks > 1:
        per = -(-n // max(1, min(n, want)))
    per = min(n, per)
    return ContiguousPlan(row_tiles=row_tiles, units=units, blocks=blocks,
                          runs=runs, splits=-(-n // per), per=per,
                          psp=-(-(blocks * bk) // 16) * 16)


def contiguous_plan(G: int, Sq: int, Sk: int, bk: int) -> ContiguousPlan:
    """Up to 16 rows a unit (decode), spans cut until the blocks fill the
    card 4 times over; past 16 rows (prefill), spans of 8 runs (256 keys),
    since pass B's atomic adds grow with rows x D x spans. A heuristic, not
    the fastest split: chip_smoke.py's phase 3 times every split beside
    it. A span starts and ends on a run boundary of its key block, or is
    whole key blocks when a group has several."""
    row_tiles = -(-Sq // CONTIGUOUS_ROWS)
    units = G * row_tiles
    return _plan(Sk, bk, row_tiles, units,
                 -(-_CONTIGUOUS_TARGET_BLOCKS // units),
                 _PREFILL_SPAN_RUNS if Sq > 16 else None)


def single_plan(G: int, Sq: int, Sk: int) -> ContiguousPlan:
    """The one-tile kernel's split: spans of runs of the ``Skp`` keys cut
    until the CTAs reach 64, at most (the cooperative launch needs every
    CTA resident, and fewer CTAs meet at the grid barrier sooner). A
    heuristic: at the solo GQA decode, 64 CTAs beat 128 on the card, and
    chip_smoke.py's phase 3 times every split beside it."""
    row_tiles = -(-Sq // CONTIGUOUS_ROWS)
    units = G * row_tiles
    return _plan(Sk, key_block(Sk), row_tiles, units,
                 _SINGLE_BLOCKS // units)


def acam_attention_contiguous_plain(q_codes, k_codes, v_codes, logit_scale,
                                    mask, lens, per_row, mode, cmax_floor,
                                    q_offset, causal, rsd=None):
    """Plain PyTorch version of the contiguous two-pass kernel.

    ``lens`` (G,) int32 valid keys per group (<= Sk); ``per_row`` says they
    came as a per-group vector, whose zero entries give zero rows."""
    return _two_pass_plain(q_codes, k_codes, v_codes, logit_scale, mask, lens,
                           per_row, mode, cmax_floor, q_offset, causal,
                           key_block(k_codes.shape[1]), rsd)


def acam_attention_single_plain(q_codes, k_codes, v_codes, logit_scale,
                                mask, lens, per_row, mode, cmax_floor,
                                q_offset, causal, rsd=None):
    """Plain PyTorch version of the one-tile kernel, `_attn_kernel_single`
    step by step: the logit codes of the whole tile, one row-sum reduction
    over all ``Skp`` keys (the padded tile), the call-wide cmax, then
    PROB . V; no scratch, no second key sweep."""
    exp_val, log_lut, prob_lut, e_min, step, fs = _device_tables(
        mode, q_codes.device)
    Sk = k_codes.shape[1]
    skp = key_block(Sk)
    xc = _logit_codes(q_codes, k_codes, logit_scale, mask, causal, q_offset,
                      rsd)
    valid = (torch.arange(Sk, device=q_codes.device)[None, None, :]
             < lens[:, None, None])
    e = torch.where(valid, exp_val[(xc + 128).long()],
                    torch.zeros((), device=q_codes.device))
    S = ref_sum(torch.nn.functional.pad(e, (0, skp - Sk)))
    xmax = torch.where(valid, xc, torch.full_like(xc, LOGIT_FMT.code_min)
                       ).amax(-1)
    L, cmax = _row_finish(S, xmax, lens, per_row, log_lut, prob_lut, e_min,
                          step, fs, cmax_floor)
    return (_prob_v(xc, valid, L, fs, cmax, prob_lut, v_codes),
            cmax.to(torch.int32))


def _bind(lib_name: str, fn_name: str, argtypes):
    from .build import bind  # built at first launch, never at import
    return bind(lib_name, fn_name, argtypes)


def pot_consts(e_min: float, step: float):
    """The PoT encoder's float32 constants as the kernels take them (e_min,
    1/step, 2^(e_min-1), the zero threshold 2^(e_min-step/2))."""
    return (float(_F32(e_min)), float(_F32(1.0 / step)),
            float(_F32(2.0 ** (e_min - 1))),
            float(_F32(2.0 ** (e_min - step / 2))))


def _launch_paged(q_codes, k_codes, v_codes, logit_scale, mask, kv_len, mode,
                  block_table, page_size, groups_per_slot, cmax_floor,
                  plan: PagedPlan | None = None, rsd=None):
    """Both passes on the current stream; ``plan`` defaults to the call's
    own (`paged_plan`), ``rsd`` is `sqrt_d_rule`'s (None: folded)."""
    import ctypes
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _bind("acam_attention", "acam_attention_paged_launch",
               [I, P, P, P, P, P, P, I, P, F, P, P, P, P, P, P, P, P, P,
                I, I, I, I, I, I, I, I, I, I, F, F, F, F, I, P])
    dev = q_codes.device
    exp_val, log_lut, prob_lut, e_min, step, fs = _device_tables(mode, dev)
    G, Sq, D = q_codes.shape
    max_pages = block_table.shape[1]
    plan = plan or paged_plan(G, Sq, max_pages, page_size)
    rows = G * Sq
    # split calls add into rows that pass A zeroes
    out = torch.empty((G, Sq, D), dtype=torch.int32, device=dev)
    page_sum = torch.empty((rows * max_pages,), dtype=torch.float32,
                           device=dev)
    page_max = torch.empty((rows * max_pages,), dtype=torch.int32, device=dev)
    codes = torch.empty((rows * max_pages * plan.psp,), dtype=torch.int8,
                        device=dev)
    lsh = torch.empty((rows,), dtype=torch.int32, device=dev)
    cells = torch.zeros((1 + plan.units,), dtype=torch.int32, device=dev)
    if cmax_floor is not None:
        cells[:1].copy_(torch.as_tensor(cmax_floor, dtype=torch.int32,
                                        device=dev).reshape(1))
    s1 = logit_scale.to(torch.float32).reshape(1).contiguous()
    mask_ptr, mask_div = None, 1
    if mask is not None:
        mask_ptr, mask_div = mask.data_ptr(), G // mask.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for pass_id in (0, 1):
        err = fn(pass_id, q_codes.data_ptr(), k_codes.data_ptr(),
                 v_codes.data_ptr(), block_table.data_ptr(), kv_len.data_ptr(),
                 mask_ptr, mask_div, s1.data_ptr(), rsd or 0.0,
                 exp_val.data_ptr(),
                 log_lut.data_ptr(), prob_lut.data_ptr(), out.data_ptr(),
                 page_sum.data_ptr(), page_max.data_ptr(), codes.data_ptr(),
                 lsh.data_ptr(), cells.data_ptr(), G, Sq, D, page_size,
                 max_pages, groups_per_slot, plan.splits,
                 plan.pages_per_split, plan.key_tile, plan.psp,
                 *pot_consts(e_min, step), fs, stream)
        if err != 0:
            raise RuntimeError(f"acam_attention pass {'AB'[pass_id]} launch "
                               f"failed: cudaError {err}")
        launches["acam_attention_paged"] += 1
    return out, cells[0]


def _contiguous_args(q_codes, logit_scale, mask, q_offset, mode, rsd):
    """The pointer and constant arguments both contiguous launches share,
    and the small tensors behind them (kept alive by the caller). A Python
    offset goes by value; a tensor offset by pointer (never copied to the
    host, which would wait for the stream); ``rsd`` 0.0 means folded."""
    dev = q_codes.device
    exp_val, log_lut, prob_lut, e_min, step, fs = _device_tables(mode, dev)
    s1 = logit_scale.to(torch.float32).reshape(1).contiguous()
    qoff, qoff_ptr, qoff_val = None, None, 0
    if isinstance(q_offset, torch.Tensor):
        qoff = q_offset.to(device=dev, dtype=torch.int32).reshape(1)
        qoff_ptr = qoff.data_ptr()
    else:
        qoff_val = int(q_offset)
    mask_ptr, mask_div = None, 1
    if mask is not None:
        mask_ptr, mask_div = mask.data_ptr(), q_codes.shape[0] // mask.shape[0]
    args = (mask_ptr, mask_div, s1.data_ptr(), rsd or 0.0, qoff_ptr, qoff_val,
            exp_val.data_ptr(), log_lut.data_ptr(), prob_lut.data_ptr())
    return (s1, qoff), args, (*pot_consts(e_min, step), fs)


def _contiguous_scratch(G, Sq, D, plan: ContiguousPlan, cmax_floor, dev,
                        extra_cells=0):
    """The output (rows pass B adds into are zeroed by pass A) and the
    scratch both contiguous kernels take: run totals, span maxima, LOG(S)
    shifts, and the cells (cmax seeded with the floor, arrival counters)."""
    rows = G * Sq
    out = torch.empty((G, Sq, D), dtype=torch.int32, device=dev)
    run_tot = torch.empty((rows * plan.blocks * plan.runs,),
                          dtype=torch.float32, device=dev)
    span_max = torch.empty((rows * plan.splits,), dtype=torch.int32,
                           device=dev)
    lsh = torch.empty((rows,), dtype=torch.int32, device=dev)
    cells = torch.zeros((1 + plan.units + extra_cells,), dtype=torch.int32,
                        device=dev)
    if cmax_floor is not None:
        cells[:1].copy_(torch.as_tensor(cmax_floor, dtype=torch.int32,
                                        device=dev).reshape(1))
    return out, run_tot, span_max, lsh, cells


def _launch_contiguous(q_codes, k_codes, v_codes, logit_scale, mask, lens,
                       per_row, mode, cmax_floor, q_offset, causal,
                       plan: ContiguousPlan | None = None, rsd=None):
    """Both passes on the current stream; ``plan`` defaults to the call's
    own (`contiguous_plan`), ``rsd`` is `sqrt_d_rule`'s (None: folded)."""
    import ctypes
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _bind("acam_attention", "acam_attention_contiguous_launch",
               [I, P, P, P, P, P, I, P, F, P, I, P, P, P, P, P, P, P, P, P,
                I, I, I, I, I, I, I, I, I, I, F, F, F, F, I, P])
    dev = q_codes.device
    G, Sq, D = q_codes.shape
    Sk = k_codes.shape[1]
    bk = key_block(Sk)
    plan = plan or contiguous_plan(G, Sq, Sk, bk)
    _alive, args, consts = _contiguous_args(q_codes, logit_scale, mask,
                                            q_offset, mode, rsd)
    out, run_tot, span_max, lsh, cells = _contiguous_scratch(
        G, Sq, D, plan, cmax_floor, dev)
    codes = torch.empty((G * Sq * plan.psp,), dtype=torch.int8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for pass_id in (0, 1):
        err = fn(pass_id, q_codes.data_ptr(), k_codes.data_ptr(),
                 v_codes.data_ptr(), lens.data_ptr(), *args, out.data_ptr(),
                 run_tot.data_ptr(), span_max.data_ptr(), codes.data_ptr(),
                 lsh.data_ptr(), cells.data_ptr(), G, Sq, Sk, D, bk,
                 int(causal), int(per_row), plan.splits, plan.per, plan.psp,
                 *consts, stream)
        if err != 0:
            raise RuntimeError(f"acam_attention contiguous pass "
                               f"{'AB'[pass_id]} launch failed: cudaError "
                               f"{err}")
        launches["acam_attention"] += 1
    return out, cells[0]


def _launch_single(q_codes, k_codes, v_codes, logit_scale, mask, lens,
                   per_row, mode, cmax_floor, q_offset, causal,
                   plan: ContiguousPlan | None = None, rsd=None):
    """One cooperative launch on the current stream; ``plan`` defaults to
    the call's own (`single_plan`), ``rsd`` is `sqrt_d_rule`'s."""
    import ctypes
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _bind("acam_attention_single", "acam_attention_single_launch",
               [P, P, P, P, P, I, P, F, P, I, P, P, P, P, P, P, P, P,
                I, I, I, I, I, I, I, I, I, F, F, F, F, I, P])
    dev = q_codes.device
    G, Sq, D = q_codes.shape
    Sk = k_codes.shape[1]
    plan = plan or single_plan(G, Sq, Sk)
    _alive, args, consts = _contiguous_args(q_codes, logit_scale, mask,
                                            q_offset, mode, rsd)
    # one more cell: the grid-wide barrier
    out, run_tot, span_max, lsh, cells = _contiguous_scratch(
        G, Sq, D, plan, cmax_floor, dev, extra_cells=1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(q_codes.data_ptr(), k_codes.data_ptr(), v_codes.data_ptr(),
             lens.data_ptr(), *args, out.data_ptr(), run_tot.data_ptr(),
             span_max.data_ptr(), lsh.data_ptr(), cells.data_ptr(), G, Sq,
             Sk, D, key_block(Sk), int(causal), int(per_row), plan.splits,
             plan.per, *consts, stream)
    if err != 0:
        raise RuntimeError(f"acam_attention_single launch failed: cudaError "
                           f"{err}")
    launches["acam_attention_single"] += 1
    return out, cells[0]


def _launch_meta(q_codes, *args, **kw):
    """A launch on ``meta`` tensors: the kernel's outputs, (G, Sq, D) int32
    and a () int32 cmax, with nothing computed (shapes only, for the
    dry-run; the op counter takes the launch's work from `cost`)."""
    return (torch.empty(q_codes.shape, dtype=torch.int32,
                        device=q_codes.device),
            torch.empty((), dtype=torch.int32, device=q_codes.device))


def _check_operands(named, dev):
    for name, t, dt in named:
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# the CUDA kernels' widest head dim (a multiple of 4; narrower dims that
# are not pad with zero codes, `_padded_to_4`)
CUDA_MAX_HEAD_DIM = 320


def _padded_to_4(impl, n_int8: int):
    """``impl`` with its first ``n_int8`` int8 operands (q, k, v: the head
    dim last) padded with zero codes to a multiple of 4, and the output's
    pad columns sliced off. Exact: a zero code adds nothing to q . K, and a
    zero V column only makes an output column that is dropped."""
    def call(*args, **kw):
        D = args[0].shape[-1]
        if D > CUDA_MAX_HEAD_DIM:
            raise ValueError(f"the CUDA kernels take head dims up to "
                             f"{CUDA_MAX_HEAD_DIM}, got {D}")
        pad = (-D) % 4
        if not pad:
            return impl(*args, **kw)
        padded = [torch.nn.functional.pad(a, (0, pad)).contiguous()
                  for a in args[:n_int8]]
        out, cmax = impl(*padded, *args[n_int8:], **kw)
        return out[..., :D].contiguous(), cmax
    return call


def acam_attention_codes(
    q_codes: torch.Tensor,   # (G, Sq, D) int8 — G folds batch x heads
    k_codes: torch.Tensor,   # (G, Sk, D) int8, or the paged pool
    v_codes: torch.Tensor,   # like k_codes
    logit_scale: torch.Tensor,           # () f32: s_q * s_k
    mask: Optional[torch.Tensor] = None,  # (Gm, Sq, Sk) bool/int8, 0 = masked
    kv_len=None,             # None, () or (G,) int32 valid keys
    mode: str = "pot",
    block_table: Optional[torch.Tensor] = None,  # (n_slots, max_pages) int32
    page_size: Optional[int] = None,
    groups_per_slot: Optional[int] = None,
    cmax_floor=None,                     # () int32: external PROB-max seed
    q_offset=0,              # () int: causal offset of row 0 (cache index)
    causal: bool = False,    # in-kernel causal mask (no mask array)
    scale_by_sqrt_d: Optional[int] = None,  # d to divide by sqrt(d); None = folded
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Fig.-12 attention on int8 codes, contiguous or block-paged k/v.

    ``scale_by_sqrt_d`` follows the reference's rule (`sqrt_d_rule`): the
    logits are divided by sqrt(d) inside the kernel, folded into the scalar
    when sqrt(d) is a power of two.

    Keys past ``kv_len`` (a scalar, or one length per group) do not exist:
    no exp weight, no PROB max, no product with V; zero-length groups of a
    (G,) vector give zero rows and leave cmax alone. A masked key stays in
    the row sum at the LOGIT minimum. ``mask`` may carry one row per
    ``G // Gm`` consecutive groups: ``Gm == G`` is the reference's form,
    and the float wrappers pass one mask per batch row rather than copy it
    to every group. Without a mask, ``causal`` lets row i attend keys
    ``<= i + q_offset``.

    **Paged** (``block_table`` given): physical page ``p`` of the pool holds
    the ``groups_per_slot`` group stripes of one logical page at rows
    ``[p*gps, (p+1)*gps)``, and ``block_table[slot, j]`` names the page
    backing slot ``slot``'s logical page ``j`` (page 0 is the trash page);
    ``kv_len`` must be a (G,) vector.

    Returns (out (G, Sq, D) int32, cmax () int32).
    """
    if mode not in FUSED_SOFTMAX_MODES:
        raise ValueError(f"mode must be one of {FUSED_SOFTMAX_MODES}, got {mode!r}")
    G, Sq, D = q_codes.shape
    dev = q_codes.device
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no implementation for device {dev}")
    logit_scale, rsd = sqrt_d_rule(
        torch.as_tensor(logit_scale, dtype=torch.float32, device=dev),
        scale_by_sqrt_d)
    if block_table is not None:
        return _paged_codes(q_codes, k_codes, v_codes, logit_scale, mask,
                            kv_len, mode, block_table, page_size,
                            groups_per_slot, cmax_floor, rsd)
    if k_codes.ndim != 3 or k_codes.shape[0] != G or k_codes.shape[2] != D \
            or v_codes.shape != k_codes.shape:
        raise ValueError(f"contiguous k/v must be ({G}, Sk, {D}), got "
                         f"{tuple(k_codes.shape)} / {tuple(v_codes.shape)}")
    _check_operands((("q", q_codes, torch.int8), ("k", k_codes, torch.int8),
                     ("v", v_codes, torch.int8)), dev)
    Sk = k_codes.shape[1]
    per_row = isinstance(kv_len, torch.Tensor) and kv_len.ndim == 1
    if not isinstance(kv_len, torch.Tensor):  # None or a Python length
        lens = torch.full((G,), Sk if kv_len is None else min(int(kv_len), Sk),
                          dtype=torch.int32, device=dev)
    else:
        kvl = kv_len.to(device=dev, dtype=torch.int32)
        if per_row and kvl.shape[0] != G:
            raise ValueError(f"per-group kv_len must have one entry per "
                             f"group: got {tuple(kvl.shape)} for G={G}")
        lens = torch.clamp(kvl, max=Sk).expand(G).contiguous()
    if mask is not None:
        if mask.ndim != 3 or mask.shape[1:] != (Sq, Sk) or G % mask.shape[0]:
            raise ValueError(f"mask must be (Gm, {Sq}, {Sk}) with Gm | {G}, "
                             f"got {tuple(mask.shape)}")
        mask = mask.to(device=dev, dtype=torch.int8).contiguous()
    single = one_tile(G, Sq, Sk)
    args = (q_codes, k_codes, v_codes, logit_scale, mask, lens, per_row,
            mode, cmax_floor, q_offset, causal)
    if dev.type == "cpu":
        impl = (acam_attention_single_plain if single
                else acam_attention_contiguous_plain)
        return impl(*args, rsd=rsd)
    if dev.type == "cuda":
        impl = _launch_single if single else _launch_contiguous
    else:
        impl = _launch_meta
    live = cost.static_live(G, Sk, kv_len)
    with cost.counted(lambda: cost.contiguous_attention(
            G, Sq, D, live, cost.static_pairs(G, Sq, Sk, live, causal,
                                              q_offset),
            0 if mask is None else mask.numel(), single)):
        return _padded_to_4(impl, 3)(*args, rsd=rsd)


def _paged_codes(q_codes, k_codes, v_codes, logit_scale, mask, kv_len, mode,
                 block_table, page_size, groups_per_slot, cmax_floor, rsd):
    if page_size is None or groups_per_slot is None:
        raise ValueError("paged attention needs page_size and groups_per_slot")
    if kv_len is None or kv_len.ndim != 1:
        raise ValueError("paged attention requires a per-group (G,) kv_len")
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
    _check_operands((("q", q_codes, torch.int8), ("k", k_codes, torch.int8),
                     ("v", v_codes, torch.int8),
                     ("block_table", block_table, torch.int32),
                     ("kv_len", kv_len, torch.int32)), dev)
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
    args = (q_codes, k_codes, v_codes, logit_scale, mask, kv_len, mode,
            block_table, page_size, gps, cmax_floor)
    if dev.type == "cpu":
        return acam_attention_codes_plain(*args, rsd=rsd)
    impl = _launch_paged if dev.type == "cuda" else _launch_meta
    with cost.counted(lambda: cost.paged_attention(
            G, Sq, D, cost.static_live(G, Sk), block_table.numel(),
            kv_len.numel(), 0 if mask is None else mask.numel())):
        return _padded_to_4(impl, 3)(*args, rsd=rsd)


def acam_attention_decode_codes(q_codes, k_codes, v_codes, logit_scale, kv_len,
                                mask=None, mode="pot", block_table=None,
                                page_size=None, groups_per_slot=None,
                                cmax_floor=None, scale_by_sqrt_d=None):
    """Decode-mode entry (Sq = 1) against a fixed-shape cache valid to
    ``kv_len`` (scalar, or one length per group). Paged, the flat layout
    folds every query head of a slot into its group stripe
    (``groups_per_slot`` defaults to G / n_slots)."""
    if q_codes.shape[1] != 1:
        raise ValueError(f"decode path expects Sq=1, got {q_codes.shape[1]}")
    if block_table is not None and groups_per_slot is None:
        groups_per_slot = q_codes.shape[0] // block_table.shape[0]
    return acam_attention_codes(q_codes, k_codes, v_codes, logit_scale, mask,
                                kv_len=kv_len, mode=mode,
                                block_table=block_table, page_size=page_size,
                                groups_per_slot=groups_per_slot,
                                cmax_floor=cmax_floor,
                                scale_by_sqrt_d=scale_by_sqrt_d)


def acam_attention_decode_gqa_codes(q_codes, k_codes, v_codes, logit_scale,
                                    kv_len, mask=None, mode="pot",
                                    block_table=None, page_size=None,
                                    groups_per_slot=None, cmax_floor=None,
                                    scale_by_sqrt_d=None):
    """GQA-native decode: one group per KV head, its ``rep`` sharing queries
    on the row dimension (paged: ``groups_per_slot`` = KV)."""
    if block_table is not None:
        if groups_per_slot is None:
            raise ValueError("GQA paged decode needs groups_per_slot (=KV)")
    elif k_codes.shape[0] != q_codes.shape[0]:
        raise ValueError(
            f"GQA decode expects q and k/v to share the group dim (B*KV): "
            f"got q {tuple(q_codes.shape)} vs k {tuple(k_codes.shape)}")
    return acam_attention_codes(q_codes, k_codes, v_codes, logit_scale, mask,
                                kv_len=kv_len, mode=mode,
                                block_table=block_table, page_size=page_size,
                                groups_per_slot=groups_per_slot,
                                cmax_floor=cmax_floor,
                                scale_by_sqrt_d=scale_by_sqrt_d)
