"""Float wrappers over the attention kernel, and their quantizer helpers.

The port of the paged part of `repro.kernels.ops`. The wrappers quantize
float q (whole tensor) and the float KV page pool (per page, with one scale
over the union of live page entries), run `acam_attention_codes`, and
descale with the oracle's PROB requant scale. Every quantizer step follows
the f32 op sequence of the reference's jitted graph.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.quant import quantize_tensor, recip_scale
from .acam_attention import (  # noqa: F401
    FUSED_SOFTMAX_MODES, acam_attention_codes, acam_attention_decode_codes,
    acam_attention_decode_gqa_codes, requant_scale)

__all__ = ["prob_requant_scale", "page_valid_lengths", "masked_page_quantize",
           "expand_row_lens", "raceit_attention_decode_paged",
           "raceit_attention_decode_gqa_paged"]


def prob_requant_scale(cmax: torch.Tensor) -> torch.Tensor:
    """The oracle's PROB re-quantization scale (see `requant_scale`)."""
    return requant_scale(cmax).float()


def page_valid_lengths(block_table: torch.Tensor, kv_len: torch.Tensor,
                       n_pages: int, page_size: int) -> torch.Tensor:
    """Per-physical-page valid entry counts for a paged KV pool.

    Slot ``b``'s logical page ``j`` holds ``clip(kv_len[b] - j*page_size, 0,
    page_size)`` live entries; scatter-maxing those through the block table
    gives every physical page's live rows. Page 0, the trash page, is 0.
    """
    bt = block_table.long()
    kvl = kv_len.to(torch.int32)
    j = torch.arange(bt.shape[1], dtype=torch.int32, device=bt.device)
    live = torch.clamp(kvl[:, None] - j * page_size, 0, page_size)
    pv = torch.zeros((n_pages,), dtype=torch.int32, device=bt.device)
    pv = pv.scatter_reduce(0, bt.reshape(-1), live.reshape(-1), reduce="amax")
    pv[0] = 0
    return pv


def masked_page_quantize(x: torch.Tensor, page_valid: torch.Tensor):
    """Quantize a page pool (n_pages, page_size, ...) over its live entries.

    One scale, max |x| over the valid rows (padded with zeros, so the max
    over the union of live prefixes), and round(x / scale) elementwise;
    invalid rows (stale pages, tails, the trash page) get code 0.
    """
    shape = (1, -1) + (1,) * (x.ndim - 2)
    idx = torch.arange(x.shape[1], device=x.device).reshape(shape)
    valid = idx < page_valid.reshape((-1,) + (1,) * (x.ndim - 1))
    amax = torch.where(valid, x.abs(), torch.zeros((), device=x.device)).amax()
    scale = recip_scale(amax, 127).float()
    codes = torch.clamp(torch.round(x / scale), -128, 127).to(torch.int8)
    return torch.where(valid, codes, torch.zeros_like(codes)), scale


def expand_row_lens(kv_len: torch.Tensor, rep: int) -> torch.Tensor:
    """Per-request lengths (B,) -> per-group lengths (B*rep,), b-major."""
    kvl = kv_len.to(torch.int32)
    return torch.repeat_interleave(kvl, rep) if kvl.ndim == 1 else kvl


def _paged_quantize_operands(q, k_pool, v_pool, block_table, kv_len):
    """q whole-tensor int8; pooled k/v per-page int8 over live entries."""
    pv = page_valid_lengths(block_table, kv_len, k_pool.shape[0],
                            k_pool.shape[1])
    return (quantize_tensor(q, bits=8), masked_page_quantize(k_pool, pv),
            masked_page_quantize(v_pool, pv))


def raceit_attention_decode_paged(
    q: torch.Tensor,       # (B, H, Sq, D) float — Sq=1 decode or Sq=C chunk
    k_pool: torch.Tensor,  # (n_pages, page_size, KV, D) float
    v_pool: torch.Tensor,  # (n_pages, page_size, KV, D) float
    kv_len: torch.Tensor,  # (B,) int32 per-slot fill levels
    block_table: torch.Tensor,  # (B, max_pages) int32; 0 = trash page
    mask: Optional[torch.Tensor] = None,  # (B, Sq, max_pages*page_size) bool
    softmax_mode: str = "pot",
) -> torch.Tensor:
    """Fused attention over a block-paged KV pool, float in/out.

    ``q`` comes with 1/sqrt(d) folded in (the reference's
    ``fold_scale=True``, which is how the serving path calls it).

    The flat layout: groups are query heads, so physical page ``p``'s stripe
    row ``p*H + h`` holds KV head ``h // rep`` (int8 codes repeated, as the
    reference does). ``Sq > 1`` is the chunked-prefill call, whose ``mask``
    carries the intra-chunk causal rule; each mask row serves the H groups
    of its slot.
    """
    B, H, Sq, D = q.shape
    n_pages, ps, KV, hd = k_pool.shape
    rep = H // KV
    qq, (k_codes, k_scale), (v_codes, v_scale) = \
        _paged_quantize_operands(q, k_pool, v_pool, block_table, kv_len)

    def to_rows(c):
        if rep > 1:
            c = torch.repeat_interleave(c, rep, dim=2)
        return c.transpose(1, 2).reshape(n_pages * H, ps, hd).contiguous()

    out32, cmax = acam_attention_codes(
        qq.codes.reshape(B * H, Sq, D).contiguous(), to_rows(k_codes),
        to_rows(v_codes), qq.scale * k_scale, mask,
        kv_len=expand_row_lens(kv_len, H), mode=softmax_mode,
        block_table=block_table.to(torch.int32).contiguous(), page_size=ps,
        groups_per_slot=H)
    p_scale = prob_requant_scale(cmax)
    return (out32.float() * (p_scale * v_scale)).reshape(B, H, Sq, D)


def raceit_attention_decode_gqa_paged(
    q: torch.Tensor,       # (B, H, 1, D) float
    k_pool: torch.Tensor,  # (n_pages, page_size, KV, D) float
    v_pool: torch.Tensor,
    kv_len: torch.Tensor,  # (B,) int32
    block_table: torch.Tensor,  # (B, max_pages) int32
    mask: Optional[torch.Tensor] = None,  # (B, 1, max_pages*page_size) bool
    softmax_mode: str = "pot",
) -> torch.Tensor:
    """GQA-native fused decode over a block-paged pool, float in/out
    (``q`` with 1/sqrt(d) folded in).

    KV heads stay native in the pool (stripe row ``page*KV + kvh``), one
    group per KV head with its ``rep`` sharing queries on the row dimension.
    Same numbers as the flat entry on the same pool.
    """
    B, H, Sq, D = q.shape
    n_pages, ps, KV, hd = k_pool.shape
    if Sq != 1:
        raise ValueError(f"decode path expects Sq=1, got {Sq}")
    if H % KV:
        raise ValueError(f"n_heads={H} not a multiple of n_kv_heads={KV}")
    rep = H // KV
    qq, (k_codes, k_scale), (v_codes, v_scale) = \
        _paged_quantize_operands(q, k_pool, v_pool, block_table, kv_len)
    to_rows = lambda c: c.transpose(1, 2).reshape(n_pages * KV, ps, hd
                                                  ).contiguous()
    if mask is not None:  # (B, 1, Sk) -> (B, rep, Sk): one per slot, as flat
        mask = mask.expand(B, rep, mask.shape[-1])
    out32, cmax = acam_attention_decode_gqa_codes(
        qq.codes.reshape(B * KV, rep, D).contiguous(), to_rows(k_codes),
        to_rows(v_codes), qq.scale * k_scale, expand_row_lens(kv_len, KV),
        mask=mask, mode=softmax_mode,
        block_table=block_table.to(torch.int32).contiguous(), page_size=ps,
        groups_per_slot=KV)
    p_scale = prob_requant_scale(cmax)
    return (out32.float() * (p_scale * v_scale)).reshape(B, H, Sq, D)
