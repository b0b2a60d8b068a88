"""The public kernel API: float wrappers over the kernels, and the
quantizer helpers of the attention wrappers.

The port of `repro.kernels.ops`. `acam_activation` runs a named
Compute-ACAM activation through the LUT kernel, `raceit_linear` a float
linear layer through the crossbar MVM kernel, and `acam_softmax_kernel`
(re-exported) float logits through the softmax kernel; like the
reference, they run eagerly. The attention wrappers quantize float q
(whole tensor) and k/v (whole tensor; the cache's valid prefix,
`masked_prefix_quantize`, at decode; per page, with one scale over the
union of live page entries, on a paged pool), run `acam_attention_codes`,
and descale with the oracle's PROB requant scale. Every quantizer step
follows the f32 op sequence of the reference's jitted graph. As in the
reference, ``fold_scale=False`` (the default) divides the logits by
sqrt(d) inside the kernel, and ``fold_scale=True`` takes q with 1/sqrt(d)
folded in (the serving layers' call).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import ops as acam_ops
from ..core.crossbar import CrossbarConfig
from ..core.quant import (QuantizedTensor, quantize_tensor, recip_scale,
                          scale_product)
from .acam_attention import (  # noqa: F401
    FUSED_SOFTMAX_MODES, acam_attention_codes, acam_attention_decode_codes,
    acam_attention_decode_gqa_codes, requant_scale)
from .acam_lut import acam_lut, acam_lut_2d  # noqa: F401
from .acam_mvm import acam_mvm  # noqa: F401
from .acam_softmax import acam_softmax_codes, acam_softmax_kernel  # noqa: F401

__all__ = ["acam_activation", "raceit_linear", "acam_lut", "acam_lut_2d",
           "acam_mvm", "acam_softmax_codes", "acam_softmax_kernel",
           "raceit_attention_fused", "raceit_attention_decode_fused",
           "raceit_attention_decode_gqa", "prob_requant_scale", "prob_descale",
           "masked_prefix_quantize", "prefix_quantize_tensor",
           "page_valid_lengths", "masked_page_quantize",
           "page_quantize_tensor", "expand_row_lens",
           "raceit_attention_decode_paged",
           "raceit_attention_decode_gqa_paged", "tp_quantize_tensor",
           "tp_masked_prefix_quantize", "tp_masked_page_quantize",
           "tp_exact_call"]


def acam_activation(x: torch.Tensor, name: str = "gelu") -> torch.Tensor:
    """Float tensor through a named Compute-ACAM activation (kernelized)."""
    op = acam_ops.get_op(name)
    codes = op.in_fmt.encode(x.float())
    out = acam_lut(codes, op.lut(x.device), bias=1 << (op.in_fmt.bits - 1))
    return op.out_fmt.decode(out)


def raceit_linear(x: torch.Tensor, w: torch.Tensor,
                  cfg: CrossbarConfig = CrossbarConfig()) -> torch.Tensor:
    """Float linear layer on the kernelized crossbar DPE lane."""
    xq = quantize_tensor(x.float(), bits=cfg.input_bits)
    wq = quantize_tensor(w.float(), bits=cfg.weight_bits, axis=1)
    lead = x.shape[:-1]
    y = acam_mvm(xq.codes.reshape(-1, x.shape[-1]), wq.codes, cfg)
    return (y.float() * (xq.scale * wq.scale)).reshape(*lead, -1)


def _sqrt_d(D: int, fold_scale: bool) -> Optional[int]:
    """``scale_by_sqrt_d`` of a float wrapper (None: folded into q)."""
    return None if fold_scale else D


def raceit_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           softmax_mode: str = "pot", q_offset=0,
                           fold_scale: bool = False,
                           causal: bool = False) -> torch.Tensor:
    """Fused Fig.-12 attention, float in/out: q/k/v (B, H, S, D), ``mask``
    broadcastable to (B, H, Sq, Sk). The drop-in for the staged
    `repro_torch.core.attention.raceit_attention`; ``fold_scale=True``
    takes q with 1/sqrt(D) already folded in."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    qq = quantize_tensor(q, bits=8)
    kq = quantize_tensor(k, bits=8)
    vq = quantize_tensor(v, bits=8)
    if mask is not None:
        mask = mask.expand(B, H, Sq, Sk).reshape(B * H, Sq, Sk)
    rows = lambda c, n: c.reshape(B * H, n, D).contiguous()
    out32, cmax = acam_attention_codes(
        rows(qq.codes, Sq), rows(kq.codes, Sk), rows(vq.codes, Sk),
        scale_product(qq, kq), mask, q_offset=q_offset, mode=softmax_mode,
        causal=causal, scale_by_sqrt_d=_sqrt_d(D, fold_scale))
    return (out32.float() * prob_descale(cmax, vq)).reshape(B, H, Sq, D)


def prob_requant_scale(cmax: torch.Tensor) -> torch.Tensor:
    """The oracle's PROB re-quantization scale (see `requant_scale`)."""
    return requant_scale(cmax).float()


def prob_descale(cmax: torch.Tensor, vq: QuantizedTensor) -> torch.Tensor:
    """``prob_requant_scale(cmax) * vq.scale`` as the reference's jitted
    graph multiplies the two quantizer scales (`scale_product`); the PROB
    requantization's amax is the max PROB value, cmax / 256."""
    pq = QuantizedTensor(None, prob_requant_scale(cmax), 8, torch.clamp_min(
        cmax.float() * 2.0 ** -8, float(np.float32(1e-12))))
    return scale_product(pq, vq)


def _masked_amax(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """max |x| over the ``valid`` entries (padded with zeros, so the max
    over their union)."""
    return torch.where(valid, x.abs(), torch.zeros((), device=x.device)).amax()


def _quantize_at(x: torch.Tensor, amax: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> QuantizedTensor:
    """int8 codes of ``x`` at the scale of ``amax`` (divide, round half to
    even); entries outside ``valid`` get code 0."""
    scale = recip_scale(amax, 127).float()
    codes = torch.clamp(torch.round(x / scale), -128, 127).to(torch.int8)
    if valid is not None:
        codes = torch.where(valid, codes, torch.zeros_like(codes))
    return QuantizedTensor(codes, scale, 8, torch.clamp_min(
        amax, float(np.float32(1e-12))).float())


def _masked_quantize(x: torch.Tensor, valid: torch.Tensor) -> QuantizedTensor:
    """One int8 scale over the ``valid`` entries of ``x``; other entries
    get code 0."""
    return _quantize_at(x, _masked_amax(x, valid), valid)


def prefix_quantize_tensor(x: torch.Tensor, kv_len, axis: int = 2
                           ) -> QuantizedTensor:
    """`masked_prefix_quantize` as a `QuantizedTensor` (with its amax)."""
    return _masked_quantize(x, _prefix_valid(x, kv_len, axis))


def _prefix_valid(x: torch.Tensor, kv_len, axis: int) -> torch.Tensor:
    """Entries of ``x`` inside the valid prefix along ``axis`` (``kv_len`` a
    scalar or one length per leading batch row)."""
    shape = tuple(x.shape[axis] if d == axis else 1 for d in range(x.ndim))
    idx = torch.arange(x.shape[axis], device=x.device).reshape(shape)
    kvl = torch.as_tensor(kv_len, device=x.device).to(torch.int32)
    if kvl.ndim == 1:  # per-row prefixes along the leading batch dim
        kvl = kvl.reshape((-1,) + (1,) * (x.ndim - 1))
    return idx < kvl


def masked_prefix_quantize(x: torch.Tensor, kv_len, axis: int = 2):
    """`quantize_tensor(x_sliced_to_kv_len, bits=8)` without slicing.

    ``kv_len`` is a scalar (one prefix for the whole tensor) or a (B,)
    vector of per-row prefixes along the leading batch dim; the scale
    reduces over the union of the rows' valid prefixes, and entries past
    each row's prefix get code 0. Returns (codes int8, scale f32).
    """
    q = prefix_quantize_tensor(x, kv_len, axis)
    return q.codes, q.scale


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


def page_quantize_tensor(x: torch.Tensor, page_valid: torch.Tensor
                         ) -> QuantizedTensor:
    """`masked_page_quantize` as a `QuantizedTensor` (with its amax)."""
    return _masked_quantize(x, _page_valid(x, page_valid))


def _page_valid(x: torch.Tensor, page_valid: torch.Tensor) -> torch.Tensor:
    """Entries of a pool (n_pages, page_size, ...) inside each page's live
    rows."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    idx = torch.arange(x.shape[1], device=x.device).reshape(shape)
    return idx < page_valid.to(x.device).reshape((-1,) + (1,) * (x.ndim - 1))


def masked_page_quantize(x: torch.Tensor, page_valid: torch.Tensor):
    """Quantize a page pool (n_pages, page_size, ...) over its live entries.

    One scale, max |x| over the valid rows (padded with zeros, so the max
    over the union of live prefixes), and round(x / scale) elementwise;
    invalid rows (stale pages, tails, the trash page) get code 0.
    """
    q = page_quantize_tensor(x, page_valid)
    return q.codes, q.scale


def expand_row_lens(kv_len: torch.Tensor, rep: int) -> torch.Tensor:
    """Per-request lengths (B,) -> per-group lengths (B*rep,), b-major."""
    kvl = kv_len.to(torch.int32)
    return torch.repeat_interleave(kvl, rep) if kvl.ndim == 1 else kvl


def _decode_quantize_operands(q, k, v, kv_len):
    """q whole-tensor int8; the k/v cache buffers (B, heads, Smax, D) int8
    over their valid prefixes (one scale over the union of the rows')."""
    return (quantize_tensor(q, bits=8), prefix_quantize_tensor(k, kv_len),
            prefix_quantize_tensor(v, kv_len))


def raceit_attention_decode_fused(
    q: torch.Tensor,       # (B, H, 1, D) float: the new token's query
    k: torch.Tensor,       # (B, H, Smax, D) float: the KV cache buffer
    v: torch.Tensor,       # (B, H, Smax, D) float
    kv_len,                # () int32 (>= 1) or (B,) per-request lengths
    softmax_mode: str = "pot",
    fold_scale: bool = False,
) -> torch.Tensor:
    """Fused decode-step attention over a KV cache, float in/out.

    The staged oracle on the cache slice ``k[:, :, :kv_len]``, to the fused
    kernel's contract: k/v are quantized over the valid prefix only
    (`masked_prefix_quantize`), keys past ``kv_len`` do not exist for the
    kernel. A (B,) ``kv_len`` gives every row its own prefix (all H head
    groups of a row share it); zero-length rows output zeros. The one-tile
    kernel takes the call when the reference's rule picks it.
    """
    B, H, Sq, D = q.shape
    Smax = k.shape[2]
    qq, kq, vq = _decode_quantize_operands(q, k, v, kv_len)
    rows = lambda c, n: c.reshape(B * H, n, D).contiguous()
    out32, cmax = acam_attention_decode_codes(
        rows(qq.codes, Sq), rows(kq.codes, Smax), rows(vq.codes, Smax),
        scale_product(qq, kq), expand_row_lens(torch.as_tensor(kv_len), H),
        mode=softmax_mode, scale_by_sqrt_d=_sqrt_d(D, fold_scale))
    return (out32.float() * prob_descale(cmax, vq)).reshape(B, H, Sq, D)


def raceit_attention_decode_gqa(
    q: torch.Tensor,       # (B, H, 1, D) float: all heads' queries
    k: torch.Tensor,       # (B, KV, Smax, D) float: the native cache
    v: torch.Tensor,       # (B, KV, Smax, D) float
    kv_len,                # () int32 (>= 1) or (B,)
    softmax_mode: str = "pot",
    fold_scale: bool = False,
) -> torch.Tensor:
    """GQA-native fused decode attention, float in/out: one group per KV
    head, its ``rep = H / KV`` sharing queries on the row dimension, the
    cache never repeated. The same numbers as `raceit_attention_decode_fused`
    on the cache repeated to H heads."""
    B, H, Sq, D = q.shape
    KV, Smax = k.shape[1], k.shape[2]
    if Sq != 1:
        raise ValueError(f"decode path expects Sq=1, got {Sq}")
    if H % KV:
        raise ValueError(f"n_heads={H} not a multiple of n_kv_heads={KV}")
    rep = H // KV
    qq, kq, vq = _decode_quantize_operands(q, k, v, kv_len)
    rows = lambda c: c.reshape(B * KV, Smax, D).contiguous()
    out32, cmax = acam_attention_decode_gqa_codes(
        qq.codes.reshape(B * KV, rep, D).contiguous(), rows(kq.codes),
        rows(vq.codes), scale_product(qq, kq),
        expand_row_lens(torch.as_tensor(kv_len), KV), mode=softmax_mode,
        scale_by_sqrt_d=_sqrt_d(D, fold_scale))
    return (out32.float() * prob_descale(cmax, vq)).reshape(B, H, Sq, D)


def _paged_quantize_operands(q, k_pool, v_pool, block_table, kv_len):
    """q whole-tensor int8; pooled k/v per-page int8 over live entries."""
    pv = page_valid_lengths(block_table, kv_len, k_pool.shape[0],
                            k_pool.shape[1])
    return (quantize_tensor(q, bits=8), page_quantize_tensor(k_pool, pv),
            page_quantize_tensor(v_pool, pv))


def raceit_attention_decode_paged(
    q: torch.Tensor,       # (B, H, Sq, D) float — Sq=1 decode or Sq=C chunk
    k_pool: torch.Tensor,  # (n_pages, page_size, KV, D) float
    v_pool: torch.Tensor,  # (n_pages, page_size, KV, D) float
    kv_len: torch.Tensor,  # (B,) int32 per-slot fill levels
    block_table: torch.Tensor,  # (B, max_pages) int32; 0 = trash page
    mask: Optional[torch.Tensor] = None,  # (B, Sq, max_pages*page_size) bool
    softmax_mode: str = "pot",
    fold_scale: bool = False,  # True: 1/sqrt(d) already folded into q
) -> torch.Tensor:
    """Fused attention over a block-paged KV pool, float in/out.

    The flat layout: groups are query heads, so physical page ``p``'s stripe
    row ``p*H + h`` holds KV head ``h // rep`` (int8 codes repeated, as the
    reference does). ``Sq > 1`` is the chunked-prefill call, whose ``mask``
    carries the intra-chunk causal rule; each mask row serves the H groups
    of its slot.
    """
    B, H, Sq, D = q.shape
    n_pages, ps, KV, hd = k_pool.shape
    rep = H // KV
    qq, kq, vq = _paged_quantize_operands(q, k_pool, v_pool, block_table,
                                          kv_len)

    def to_rows(c):
        if rep > 1:
            c = torch.repeat_interleave(c, rep, dim=2)
        return c.transpose(1, 2).reshape(n_pages * H, ps, hd).contiguous()

    out32, cmax = acam_attention_codes(
        qq.codes.reshape(B * H, Sq, D).contiguous(), to_rows(kq.codes),
        to_rows(vq.codes), scale_product(qq, kq), mask,
        kv_len=expand_row_lens(kv_len, H), mode=softmax_mode,
        block_table=block_table.to(torch.int32).contiguous(), page_size=ps,
        groups_per_slot=H, scale_by_sqrt_d=_sqrt_d(D, fold_scale))
    return (out32.float() * prob_descale(cmax, vq)).reshape(B, H, Sq, D)


def raceit_attention_decode_gqa_paged(
    q: torch.Tensor,       # (B, H, 1, D) float
    k_pool: torch.Tensor,  # (n_pages, page_size, KV, D) float
    v_pool: torch.Tensor,
    kv_len: torch.Tensor,  # (B,) int32
    block_table: torch.Tensor,  # (B, max_pages) int32
    mask: Optional[torch.Tensor] = None,  # (B, 1, max_pages*page_size) bool
    softmax_mode: str = "pot",
    fold_scale: bool = False,  # True: 1/sqrt(d) already folded into q
) -> torch.Tensor:
    """GQA-native fused decode over a block-paged pool, float in/out.

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
    qq, kq, vq = _paged_quantize_operands(q, k_pool, v_pool, block_table,
                                          kv_len)
    to_rows = lambda c: c.transpose(1, 2).reshape(n_pages * KV, ps, hd
                                                  ).contiguous()
    if mask is not None:  # (B, 1, Sk) -> (B, rep, Sk): one per slot, as flat
        mask = mask.expand(B, rep, mask.shape[-1])
    out32, cmax = acam_attention_decode_gqa_codes(
        qq.codes.reshape(B * KV, rep, D).contiguous(), to_rows(kq.codes),
        to_rows(vq.codes), scale_product(qq, kq), expand_row_lens(kv_len, KV),
        mask=mask, mode=softmax_mode,
        block_table=block_table.to(torch.int32).contiguous(), page_size=ps,
        groups_per_slot=KV, scale_by_sqrt_d=_sqrt_d(D, fold_scale))
    return (out32.float() * prob_descale(cmax, vq)).reshape(B, H, Sq, D)


# ---------------------------------------------------------------------------
# tensor-parallel twins of the quantizers, over a list of shards (the
# `repro_torch.exec.sharded` backends' stages)
# ---------------------------------------------------------------------------
# Each is its single-device twin's f32 op sequence with one change: the
# shards' local max |x| are reduced to one global max (the reference's
# `jax.lax.pmax`) before the shared scale formula. A float32 max does not
# depend on the order, so the scale and every code equal the single-device
# quantizer's on the concatenated tensor, bit for bit.

def _global_max(values: list) -> torch.Tensor:
    """The max over the shards' values, on the first shard's device."""
    dev = values[0].device
    return torch.stack([v.to(dev) for v in values]).amax()


def tp_quantize_tensor(xs: list) -> list:
    """`quantize_tensor(x, bits=8)` of each shard, the scale global."""
    g = _global_max([x.abs().amax() for x in xs])
    return [_quantize_at(x, g.to(x.device)) for x in xs]


def tp_masked_prefix_quantize(xs: list, kv_len, axis: int = 2) -> list:
    """`prefix_quantize_tensor` of each shard, the amax global."""
    valid = [_prefix_valid(x, kv_len, axis) for x in xs]
    g = _global_max([_masked_amax(x, m) for x, m in zip(xs, valid)])
    return [_quantize_at(x, g.to(x.device), m) for x, m in zip(xs, valid)]


def tp_masked_page_quantize(xs: list, page_valid: torch.Tensor) -> list:
    """`page_quantize_tensor` of each shard of a pool, the amax global."""
    valid = [_page_valid(x, page_valid) for x in xs]
    g = _global_max([_masked_amax(x, m) for x, m in zip(xs, valid)])
    return [_quantize_at(x, g.to(x.device), m) for x, m in zip(xs, valid)]


def tp_exact_call(calls: list) -> list:
    """The probe -> global max -> exact protocol of a tensor-parallel call.

    ``calls[i](cmax_floor)`` runs one of the ``acam_attention*_codes``
    entries on shard i's groups and returns its (out32, cmax). The probe
    calls (floor 0) give each shard's local max PROB code; their max (an
    integer max, order-free) is the global one; the exact calls re-run
    every shard with that floor, so each re-quantizes PROB with the table
    the single-device call uses on the gathered operands. Returns each
    shard's (out32, cmax); every cmax is the global one.
    """
    probes = [call(0) for call in calls]
    floor = _global_max([cmax for _, cmax in probes])
    return [call(floor.to(cmax.device))
            for call, (_, cmax) in zip(calls, probes)]
