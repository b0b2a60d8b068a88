"""Transformer building blocks: norms, positions, attention, FFN.

The port of `repro.models.layers`: global and sliding-window (local)
self-attention, causal or bidirectional (encoders), and cross attention
over an encoder's keys; learned, sinusoidal, RoPE and M-RoPE positions.
Parameters are plain dicts of tensors, one dict per layer, and every layer
call dispatches through the resolved `repro_torch.exec.ExecPlan` exactly
as the reference does. Self-attention covers both KV caches of the
reference:

* the contiguous cache (B, L, KV, hd) with a scalar (or per-slot) write
  index: whole-prompt prefill, with left-padded buckets masked per row, and
  the Sq=1 decode step against the valid prefix. Global layers keep L =
  max_len columns; local layers keep a ring of L = min(max_len, window)
  columns, written at ``idx % L``;
* the block-paged pool (global layers only): the Sq=1 decode step and the
  chunked-prefill step, with the page-table kernels for paged backends and
  the gather degrade for every other backend.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..configs.base import ExecConfig, ModelConfig
from ..core.quant import quantize_tensor, scale_product
from ..exec.plan import ExecPlan, as_plan

Params = dict
NEG_INF = -1e9


@dataclasses.dataclass
class QuantizedWeight:
    """Resident crossbar weight: int8 codes + per-column scale."""

    codes: torch.Tensor   # (K, N) int8
    scale: torch.Tensor   # (1, N) f32
    shape: tuple          # out-shape after the contraction dim

    def to(self, device):
        return QuantizedWeight(self.codes.to(device), self.scale.to(device),
                               self.shape)


def _probs_dtype(cfg: ModelConfig):
    """dtype of the p matrix fed to the digital PV product."""
    if cfg.attn_probs_dtype == "float32" or cfg.compute_dtype == "float32":
        return torch.float32
    return torch.bfloat16


# --------------------------------------------------------------------------
# initializers (same distributions as the reference, torch generators)
# --------------------------------------------------------------------------

def _normal(gen, shape, std, device, dtype):
    t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (t * std).to(dtype)


def _dense_init(gen, shape, device, dtype, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    return _normal(gen, shape, 1.0 / math.sqrt(fan_in), device, dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device, dtype) -> Params:
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones((cfg.d_model,), device=device, dtype=dtype)}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((cfg.d_model,), device=device, dtype=dtype),
                "bias": torch.zeros((cfg.d_model,), device=device, dtype=dtype)}
    return {}  # np_layernorm: non-parametric


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + cfg.norm_eps)
        return (y * p["scale"].float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
    if cfg.norm == "layernorm":
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# rotary positions
# --------------------------------------------------------------------------

def _rope_angles(positions: torch.Tensor, head_dim: int,
                 theta: float) -> tuple:
    """positions (..., S) -> cos/sin (..., S, head_dim/2)."""
    dev = positions.device
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=dev) / head_dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=dev), exps)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_sections(cfg: ModelConfig, head_dim: int) -> np.ndarray:
    """M-RoPE's half-dim band widths, the reference's rescale for reduced
    configs included: when the sections do not cover head_dim / 2, each
    becomes max(1, sec * (hd/2) // sum) and the last takes the rest."""
    secs = np.array(cfg.mrope_sections, np.int64)
    if secs.sum() != head_dim // 2:
        secs = np.maximum(1, secs * (head_dim // 2) // secs.sum())
        secs[-1] = head_dim // 2 - secs[:-1].sum()
    return secs


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, H, hd). positions: (B, S), or (3, B, S) for M-RoPE."""
    hd = x.shape[-1]
    if cfg.pos_emb == "mrope":
        # M-RoPE (qwen2-vl): the half-dim bands split into (t, h, w)
        # sections, band i taking its angles from position channel i; (B, S)
        # positions are one channel broadcast to three (text tokens)
        if positions.ndim == 2:
            positions = positions[None].expand(3, *positions.shape)
        # (3, B, S, hd/2)
        cos, sin = _rope_angles(positions, hd, cfg.rope_theta)
        cuts = np.cumsum(mrope_sections(cfg, hd))[:-1].tolist()
        cos, sin = (torch.cat([torch.tensor_split(t, cuts, dim=-1)[i][i]
                               for i in range(3)], -1) for t in (cos, sin))
    elif cfg.pos_emb == "rope":
        cos, sin = _rope_angles(positions, hd, cfg.rope_theta)  # (B, S, hd/2)
    else:
        raise NotImplementedError(f"apply_rope: pos_emb={cfg.pos_emb!r}")
    cos = cos[:, :, None, :]  # (B, S, 1, hd/2)
    sin = sin[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# linear projections (dispatched through the plan's matmul slot)
# --------------------------------------------------------------------------

def _linear(x, w, plan: ExecPlan, bias=None):
    """x (..., K) @ w (K, ...) on the plan's matmul backend; ``w`` may be a
    resident `QuantizedWeight`."""
    return plan.matmul(x, w, bias=bias)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def init_attention(gen, cfg: ModelConfig, device, dtype) -> Params:
    hd = cfg.resolved_head_dim
    heff = cfg.head_pad_to or cfg.n_heads
    p = {
        "wq": _dense_init(gen, (cfg.d_model, heff, hd), device, dtype),
        "wk": _dense_init(gen, (cfg.d_model, cfg.n_kv_heads, hd), device, dtype),
        "wv": _dense_init(gen, (cfg.d_model, cfg.n_kv_heads, hd), device, dtype),
        "wo": _dense_init(gen, (heff, hd, cfg.d_model), device, dtype,
                          fan_in=cfg.n_heads * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((heff, hd), device=device, dtype=dtype)
        p["bk"] = torch.zeros((cfg.n_kv_heads, hd), device=device, dtype=dtype)
        p["bv"] = torch.zeros((cfg.n_kv_heads, hd), device=device, dtype=dtype)
    return p


def _split_gqa(q, n_kv):
    """(B, S, H, hd) -> (B, S, KV, H//KV, hd)."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, hd)


def _chunked_attention(q, k, v, mask_fn, chunk: int, scale: float,
                       probs_dtype, pad_lens=None):
    """Online-softmax attention over KV chunks, flat-head layout.

    q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd), KV heads repeated to H inside
    each chunk. mask_fn(q_idx, k_idx) -> bool; ``pad_lens`` (B,) int32 also
    masks each row's first ``pad_lens[b]`` keys (left-padded buckets). A
    query row with no valid key outputs zeros.
    """
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    rep = h // kv
    sk_real = k.shape[1]
    pad = (-sk_real) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    q32 = q.float().transpose(1, 2) * scale  # (B, H, Sq, hd)
    qpos = torch.arange(sq, device=dev)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    for c0 in range(0, k.shape[1], chunk):
        kr = k[:, c0:c0 + chunk].float().repeat_interleave(rep, dim=2)
        s = torch.einsum("bhqd,bchd->bhqc", q32, kr)
        kpos = c0 + torch.arange(chunk, device=dev)
        msk = mask_fn(qpos[:, None], kpos[None, :]) & (kpos < sk_real)[None, :]
        if pad_lens is not None:  # per-row: left-pad keys do not exist
            msk = msk[None] & (kpos[None, :] >= pad_lens[:, None])[:, None, :]
            s = torch.where(msk[:, None], s, neg)
        else:
            s = torch.where(msk[None, None], s, neg)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = p.to(probs_dtype)
        vr = v[:, c0:c0 + chunk].to(pv.dtype).repeat_interleave(rep, dim=2)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqc,bchd->bhqd", pv, vr).float()
        m = m_new
    out = torch.where(m[..., None] > NEG_INF * 0.5,
                      acc / torch.clamp_min(l, 1e-30)[..., None],
                      torch.zeros((), device=dev))
    return out.transpose(1, 2)  # (B, Sq, H, hd)


def _local_block_attention(q, k, v, window: int, scale: float, probs_dtype):
    """Sliding-window attention in q-blocks: each W-token block attends only
    its own and the previous KV block (2W keys instead of S), the
    reference's digital path for local layers.

    q: (B, S, H, hd); k/v: (B, S, KV, hd); requires S % window == 0.
    """
    B, S, H, hd = q.shape
    kv = k.shape[2]
    rep = H // kv
    W = window
    nb = S // W
    dev = q.device
    qb = (q.float() * scale).reshape(B, nb, W, H, hd)
    kb = k.reshape(B, nb, W, kv, hd)
    vb = v.reshape(B, nb, W, kv, hd)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 0, 1, 0))[:, :nb]
    kcat = torch.cat([pad(kb), kb], dim=2).repeat_interleave(rep, dim=3)
    vcat = torch.cat([pad(vb), vb], dim=2).repeat_interleave(rep, dim=3)
    s = torch.einsum("bnwhd,bnchd->bnhwc", qb, kcat.float())
    # causal + window; block 0 has no previous block
    qpos = torch.arange(W, device=dev)[:, None]
    kpos = (torch.arange(2 * W, device=dev) - W)[None, :]
    base = (kpos <= qpos) & (kpos > qpos - W)  # (W, 2W)
    blk0 = base & (kpos >= 0)
    mask = torch.where((torch.arange(nb, device=dev) == 0)[:, None, None],
                       blk0[None], base[None])
    s = torch.where(mask[None, :, None], s,
                    torch.full((), NEG_INF, dtype=s.dtype, device=dev))
    p = torch.softmax(s, dim=-1).to(probs_dtype)
    o = torch.einsum("bnhwc,bnchd->bnwhd", p, vcat.to(p.dtype)).float()
    return o.reshape(B, S, H, hd)


def _decode_quantize(q, k, v, kv_len, scale):
    """Fused-decode prolog shared by both decode backends: q (B, 1, H, hd)
    with 1/sqrt(d) folded, whole-tensor int8; the k/v cache buffers
    (B, Smax, KV, hd) int8 once, unrepeated, scales over the valid prefix."""
    from ..kernels.ops import prefix_quantize_tensor
    qq = quantize_tensor(q.float() * scale, bits=8)
    kq = prefix_quantize_tensor(k.float(), kv_len, axis=1)
    vq = prefix_quantize_tensor(v.float(), kv_len, axis=1)
    return qq, kq, vq


def _decode_descale(out32, cmax, vq, shape):
    """Fused-decode epilog: the oracle's PROB requant + V scales."""
    from ..kernels.ops import prob_descale
    return (out32.float() * prob_descale(cmax, vq)).reshape(shape)


def _raceit_fused_decode(q, k, v, kv_len, scale, plan: ExecPlan,
                         pad_valid=None):
    """Decode-step (Sq=1) attention on the fused kernel, flat heads.

    q: (B, Sq, H, hd); k/v: (B, Smax, KV, hd) fixed-shape cache buffers of
    which the first ``kv_len`` rows are valid (scalar or (B,)). GQA heads
    are repeated to H after quantization, as int8 codes. ``pad_valid``
    (B, Smax) or (B, Sq, Smax) bool marks attendable slots (masked slots sit
    at the LOGIT minimum); it reaches the kernel as one mask row per batch
    row. ``Sq > 1`` is the chunked-prefill step, on the general entry.
    Returns (B, Sq, H, hd).
    """
    from ..kernels.ops import (acam_attention_codes,
                               acam_attention_decode_codes, expand_row_lens)
    b, sq, h, hd = q.shape
    smax, kv = k.shape[1], k.shape[2]
    rep = h // kv
    qq, kq, vq = _decode_quantize(q, k, v, kv_len, scale)

    def fold(c):
        if rep > 1:
            c = c.repeat_interleave(rep, dim=2)
        return c.transpose(1, 2).reshape(b * h, smax, hd).contiguous()

    mask = None
    if pad_valid is not None:  # (B, Smax) -> (B, Sq, Smax), one row per b
        mask = (pad_valid[:, None, :] if pad_valid.ndim == 2
                else pad_valid).expand(b, sq, smax)
    kvl = expand_row_lens(kv_len, h)
    qc = qq.codes.transpose(1, 2).reshape(b * h, sq, hd).contiguous()
    mode = plan.exec_cfg.softmax_mode
    if sq == 1:
        out32, cmax = acam_attention_decode_codes(
            qc, fold(kq.codes), fold(vq.codes), scale_product(qq, kq), kvl,
            mask=mask, mode=mode)
    else:
        out32, cmax = acam_attention_codes(
            qc, fold(kq.codes), fold(vq.codes), scale_product(qq, kq), mask,
            kv_len=kvl, mode=mode)
    return _decode_descale(out32, cmax, vq, (b, h, sq, hd)).transpose(1, 2)


def _raceit_gqa_decode(q, k, v, kv_len, scale, plan: ExecPlan,
                       pad_valid=None):
    """GQA-native decode-step attention: the KV cache is never repeated.

    Same numbers as `_raceit_fused_decode`; k/v stay (B*KV, Smax, hd)
    groups whose ``rep = H/KV`` sharing queries ride the row dimension.
    ``Sq > 1`` (chunked prefill) takes the flat entry.
    """
    from ..kernels.ops import acam_attention_decode_gqa_codes, expand_row_lens
    b, sq, h, hd = q.shape
    smax, kv = k.shape[1], k.shape[2]
    rep = h // kv
    if sq > 1:
        return _raceit_fused_decode(q, k, v, kv_len, scale, plan,
                                    pad_valid=pad_valid)
    qq, kq, vq = _decode_quantize(q, k, v, kv_len, scale)
    to_groups = lambda c: c.transpose(1, 2).reshape(b * kv, smax, hd
                                                    ).contiguous()
    mask = None
    if pad_valid is not None:  # (B, Smax) -> (B, rep, Smax), one row per b
        mask = pad_valid[:, None, :].expand(b, rep, smax)
    out32, cmax = acam_attention_decode_gqa_codes(
        qq.codes.reshape(b * kv, rep, hd).contiguous(), to_groups(kq.codes),
        to_groups(vq.codes), scale_product(qq, kq),
        expand_row_lens(kv_len, kv), mask=mask,
        mode=plan.exec_cfg.softmax_mode)
    return _decode_descale(out32, cmax, vq, (b, sq, h, hd))


def _raceit_paged_decode(q, k_pool, v_pool, kv_len, scale, plan: ExecPlan,
                         pad_valid=None, block_table=None, gqa=False):
    """Decode / chunk attention over a block-paged KV pool on the kernel.

    q: (B, Sq, H, hd); k/v: the (n_pages, page_size, KV, hd) pool;
    ``block_table`` (B, max_pages) names each slot's pages (0 = trash).
    ``pad_valid`` (B, Sq, Smax) is the chunk path's intra-chunk causal mask.
    """
    from ..kernels.ops import (raceit_attention_decode_gqa_paged,
                               raceit_attention_decode_paged)
    b, sq, h, hd = q.shape
    qh = (q.float() * scale).transpose(1, 2)  # (B, H, Sq, hd)
    mask = pad_valid
    if mask is not None and mask.ndim == 2:  # (B, Smax) -> (B, Sq, Smax)
        mask = mask[:, None, :]
    fn = (raceit_attention_decode_gqa_paged if gqa and sq == 1
          else raceit_attention_decode_paged)
    # the entries read the pool as float32 (a bfloat16 pool widens in the
    # prolog's kernels, not in a pass over the whole pool here)
    out = fn(qh, k_pool, v_pool, kv_len, block_table, mask=mask,
             softmax_mode=plan.exec_cfg.softmax_mode, fold_scale=True)
    return out.transpose(1, 2)  # (B, Sq, H, hd)


def paged_write_targets_chunk(block_table, lens, chunk_offs, sq: int,
                              page_size: int):
    """Physical (pages, slots), each (B, sq), for a chunked-prefill write.

    Row b streams its chunk into logical columns [chunk_offs[b], lens[b]);
    any column that is not live — past the row's feed, or beyond the block
    table's capacity — routes to the trash page 0.
    """
    ps = int(page_size)
    bt = block_table.long()
    lens = lens.long()
    offs = chunk_offs.long()
    rows = torch.arange(bt.shape[0], device=bt.device)
    capacity = bt.shape[1] * ps
    cols = offs[:, None] + torch.arange(sq, device=bt.device)[None, :]
    live = (cols < lens[:, None]) & (cols < capacity)
    page_of = bt[rows[:, None], torch.clamp(cols // ps, max=bt.shape[1] - 1)]
    pages = torch.where(live, page_of, torch.zeros_like(page_of))
    slots = torch.where(live, cols % ps, torch.zeros_like(cols))
    return pages, slots


def paged_write_targets_decode(block_table, lens, page_size: int):
    """Physical (pages, slots), each (B,), for a decode-step write.

    The new token is logical column lens[b] - 1; empty slots and slots
    filled past capacity write to the trash page 0.
    """
    ps = int(page_size)
    bt = block_table.long()
    lens = lens.long()
    rows = torch.arange(bt.shape[0], device=bt.device)
    capacity = bt.shape[1] * ps
    pos = torch.clamp(torch.clamp(lens - 1, min=0), max=capacity - 1)
    live = (lens > 0) & (lens <= capacity)
    page_of = bt[rows, pos // ps]
    pages = torch.where(live, page_of, torch.zeros_like(page_of))
    return pages, pos % ps


def _attn_quantize(q, k, v, scale):
    """Fig.-12 prolog: repeat KV heads to H, quantize to int8 codes."""
    rep = q.shape[2] // k.shape[2]
    kf = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    vf = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    qq = quantize_tensor(q.float() * scale, bits=8)
    kq = quantize_tensor(kf.float(), bits=8)
    vq = quantize_tensor(vf.float(), bits=8)
    return qq, kq, vq


def _raceit_staged_attention(q, k, v, mask, scale, plan: ExecPlan):
    """Analog-faithful attention, stage by stage (the bit-accurate oracle
    formulation): quantized matmul-1, div-add mask, ACAM softmax, PROB
    re-quantization, matmul-2, the data-dependent matmuls through the plan's
    ``dd_matmul`` slot. Plain PyTorch: the reference runs this path in jnp.

    q: (B, Sq, H, hd) flat heads; k/v: (B, Sk, KV, hd); mask (B, Sq, Sk).
    """
    from ..core.ops import LOGIT_FMT
    from ..core.softmax import acam_softmax
    qq, kq, vq = _attn_quantize(q, k, v, scale)
    s32 = plan.dd_matmul(qq.codes.permute(0, 2, 1, 3),      # (B,H,Sq,hd)
                         kq.codes.permute(0, 2, 3, 1))      # (B,H,hd,Sk)
    logits = s32.float() * scale_product(qq, kq)
    logits = torch.where(mask[:, None], logits,
                         torch.full((), LOGIT_FMT.min_value,
                                    device=logits.device))
    probs = acam_softmax(logits, axis=-1, mode=plan.exec_cfg.softmax_mode)
    pq = quantize_tensor(probs, bits=8)
    o32 = plan.dd_matmul(pq.codes,                          # (B,H,Sq,Sk)
                         vq.codes.permute(0, 2, 1, 3))      # (B,H,Sk,hd)
    out = o32.float() * scale_product(pq, vq)
    return out.permute(0, 2, 1, 3)  # (B, Sq, H, hd)


def _raceit_fused_attention(q, k, v, mask, scale, plan: ExecPlan,
                            causal_offset=None):
    """Prefill attention on the fused kernel: the whole Fig.-12 pipeline,
    no (Sq, Sk) intermediates. ``causal_offset`` selects the kernel's
    in-kernel causal mask; otherwise ``mask`` (B, Sq, Sk) reaches the kernel
    as one mask row per batch row (the reference broadcasts it over heads).
    """
    from ..kernels.ops import acam_attention_codes, prob_descale
    qq, kq, vq = _attn_quantize(q, k, v, scale)
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    rows = lambda c, n: c.transpose(1, 2).reshape(b * h, n, hd).contiguous()
    out32, cmax = acam_attention_codes(
        rows(qq.codes, sq), rows(kq.codes, sk), rows(vq.codes, sk),
        scale_product(qq, kq), None if causal_offset is not None else mask,
        q_offset=causal_offset if causal_offset is not None else 0,
        causal=causal_offset is not None, mode=plan.exec_cfg.softmax_mode)
    out = out32.float() * prob_descale(cmax, vq)
    return out.reshape(b, h, sq, hd).transpose(1, 2)


def _write_contiguous(cache, k, v, sq: int, local: bool = False):
    """Write this call's k/v into a contiguous cache, in place.

    The write column is ``idx``, or ``idx % L`` in a local layer's ring of
    L columns. A scalar index writes columns [pos, pos + sq), the start
    clamped to the buffer as `dynamic_update_slice` clamps it; a (B,)
    per-slot index takes Sq=1 steps, each row at its own column, and a
    global layer's row whose index is past the buffer (an empty slot that
    kept counting) writes nothing, as the reference's scatter drops it; a
    prompt past the buffer keeps its last L columns. The reference builds a
    new buffer; the port writes the one it was given.
    """
    ck, cv = cache["k"], cache["v"]
    idx = cache["idx"]
    L = ck.shape[1]
    pos = idx.long() % L if local else idx.long()
    if sq >= L:
        ck.copy_(k[:, -L:].to(ck.dtype))
        cv.copy_(v[:, -L:].to(cv.dtype))
    elif idx.ndim == 1:
        if sq != 1:
            raise ValueError("per-slot caches only take Sq=1 decode steps")
        rows = torch.arange(ck.shape[0], device=ck.device)
        live = (pos < L)[:, None, None]
        pos = torch.clamp(pos, max=L - 1)
        # a dropped row writes back what its column held
        ck.index_put_((rows, pos), torch.where(live, k[:, 0].to(ck.dtype),
                                               ck[rows, pos]))
        cv.index_put_((rows, pos), torch.where(live, v[:, 0].to(cv.dtype),
                                               cv[rows, pos]))
    else:
        pos = torch.clamp(pos, 0, L - sq)
        cols = pos + torch.arange(sq, device=ck.device)
        ck.index_copy_(1, cols, k.to(ck.dtype))
        cv.index_copy_(1, cols, v.to(cv.dtype))
    return {"k": ck, "v": cv, "idx": idx + sq}


def attention(p: Params, x: torch.Tensor, *, cfg: ModelConfig,
              plan: ExecPlan | ExecConfig, positions: torch.Tensor,
              local: bool = False, cache: Optional[Params] = None,
              cross_kv: Optional[tuple] = None,
              chunk: int = 1024, pad_lens: Optional[torch.Tensor] = None,
              pad_prompt_len=None, slot_lens: Optional[torch.Tensor] = None,
              block_table: Optional[torch.Tensor] = None,
              page_size: Optional[int] = None,
              chunk_offs: Optional[torch.Tensor] = None):
    """Self- (or cross-) attention with an optional KV cache, contiguous or
    block-paged.

    Contiguous: ``cache = {"k": (B, L, KV, hd), "v": ..., "idx": ()
    int32 or (B,)}``. A call with Sq > 1 is the prefill (through
    ``plan.attention_prefill``, causal from column ``idx``, and with
    ``local`` inside the last ``cfg.window`` keys); an Sq=1 call is a
    decode step against the cache's valid prefix (through
    ``plan.attention_decode``), whose length is ``slot_lens`` when given,
    else the post-write ``idx``, capped at L. A local layer's cache is a
    ring of L = min(max_len, window) columns: every column it holds is
    inside the window. ``pad_lens`` (B,) marks left-pad prefixes
    of a bucket: prefill masks those keys per row, decode masks those
    cache slots; ``pad_prompt_len`` drops the decode pad mask of a layer
    whose buffer the prompt overflowed.

    Paged (``block_table``/``page_size``): ``cache["k"]``/``"v"`` are the
    (n_pages, page_size, KV, hd) pool shared by every slot; row b's logical
    column c lives at pool position (block_table[b, c // page_size],
    c % page_size). Two step shapes: the Sq=1 decode step (the new k/v land
    at column ``slot_lens[b] - 1``) and the chunked-prefill step
    (``chunk_offs`` given: row b streams into columns [chunk_offs[b],
    slot_lens[b])). Paged backends get the pool and table; any other
    backend is served by gathering the table's pages back to contiguous
    rows, a degrade, never an error.

    ``cross_kv`` (k, v), each (B, Sk, KV, hd): an encoder's precomputed
    keys and values. No RoPE, no cache write; every query length, Sq = 1
    included, goes through ``plan.attention_prefill`` with mask kind
    ``cross`` (all keys) and no pad mask. The mask kind is the call site's
    config's: ``cross``, then ``bidir`` when ``cfg.causal`` is off (encoder
    stacks pass a replaced config), then ``local``, then ``causal``.
    """
    plan = as_plan(cfg, plan)
    b, sq, _ = x.shape
    hd = cfg.resolved_head_dim
    q = _linear(x, p["wq"], plan, p.get("bq"))
    if cross_kv is None:
        k = _linear(x, p["wk"], plan, p.get("bk"))
        v = _linear(x, p["wv"], plan, p.get("bv"))
        if cfg.pos_emb in ("rope", "mrope"):
            q = apply_rope(q, positions, cfg)
            k = apply_rope(k, positions, cfg)
    else:
        k, v = cross_kv  # encoder keys/values, precomputed
    scale = 1.0 / math.sqrt(hd)
    if cfg.attention_multiplier is not None:
        # the logits' scale folded into q before its whole-tensor
        # quantization; the backends' 1/sqrt(d) then leaves the multiplier
        q = q * (cfg.attention_multiplier * math.sqrt(hd))

    paged = block_table is not None
    if chunk_offs is not None and not paged:
        raise ValueError("chunk_offs is the chunked-prefill surface of "
                         "block-paged caches; pass block_table/page_size")
    if paged:
        if page_size is None:
            raise ValueError("paged caches need a static page_size")
        if local:
            raise NotImplementedError(
                "block-paged KV does not cover local/ring layers (a ring "
                "overwrite would need page recycling inside a slot)")
        if cache is None or cross_kv is not None:
            raise ValueError("block_table requires a self-attention KV cache")
        if slot_lens is None:
            raise ValueError("paged caches take their per-slot lengths from "
                             "slot_lens")
        if pad_lens is not None:
            raise ValueError("paged slots are never left-padded; pad_lens "
                             "does not apply")
        o, new_cache = _paged_attention(q, k, v, cache, slot_lens,
                                        block_table, page_size, chunk_offs,
                                        scale, plan)
    else:
        new_cache = None
        if cache is not None and cross_kv is None:
            new_cache = _write_contiguous(cache, k, v, sq, local)
            if sq == 1:  # decode attends through the cache
                k, v = new_cache["k"], new_cache["v"]
        if sq == 1 and new_cache is not None:
            L = k.shape[1]
            lens = (slot_lens.to(torch.int32) if slot_lens is not None
                    else new_cache["idx"])
            kv_len = torch.clamp(lens, max=L)
            pad_valid = None
            if pad_lens is not None:
                # slot s of row b holds a pad token until the ring write for
                # token s + L reclaims it (inert for L = max_len)
                slots = torch.arange(L, device=x.device)
                pad_valid = ((slots[None, :] >= pad_lens[:, None])
                             | (lens.reshape(-1, 1) > L + slots[None, :]))
                if pad_prompt_len is not None:
                    pad_valid = pad_valid | (torch.as_tensor(
                        pad_prompt_len, device=x.device).reshape(-1, 1) > L)
            o = plan.attention_decode(q, k, v, kv_len=kv_len, scale=scale,
                                      pad_valid=pad_valid)
        else:
            q_off = cache["idx"] if cache is not None else 0
            kind = ("cross" if cross_kv is not None
                    else "bidir" if not cfg.causal
                    else "local" if local else "causal")
            o = plan.attention_prefill(q, k, v, scale=scale, q_offset=q_off,
                                       kind=kind, window=cfg.window,
                                       chunk=chunk,
                                       probs_dtype=_probs_dtype(cfg),
                                       pad_lens=(pad_lens if cross_kv is None
                                                 else None))

    wq = p["wq"]
    heff = wq.shape[0] if isinstance(wq, QuantizedWeight) else wq.shape[1]
    o = o.reshape(b, sq, heff, hd).to(x.dtype)
    if heff > cfg.n_heads:  # hard-mask padded heads
        o = o * (torch.arange(heff, device=x.device) < cfg.n_heads
                 )[None, None, :, None].to(o.dtype)
    wo = p["wo"]
    if isinstance(wo, QuantizedWeight):  # codes already (H*hd, D)
        out = _linear(o.reshape(b, sq, heff * hd), wo, plan)
    else:
        out = torch.einsum("bshd,hdm->bsm", o, wo.to(x.dtype))
    return out, new_cache


def _paged_attention(q, k, v, cache, slot_lens, block_table, page_size,
                     chunk_offs, scale, plan):
    """The block-paged branch of `attention`: pool writes, then the decode
    or chunk step through ``plan.attention_decode``."""
    b, sq = q.shape[:2]
    dev = q.device
    ps = int(page_size)
    lens = slot_lens.to(torch.int32)
    bt = block_table.to(torch.int32)
    ck, cv = cache["k"], cache["v"]
    # the reference donates the pool to a functional scatter; here the pool
    # is written in place (index_put_), so no copy of it is ever made
    if chunk_offs is not None:
        pages, slot = paged_write_targets_chunk(bt, lens, chunk_offs, sq, ps)
        ck.index_put_((pages, slot), k.to(ck.dtype))
        cv.index_put_((pages, slot), v.to(cv.dtype))
    else:
        if sq != 1:
            raise ValueError("paged caches take Sq=1 decode steps or "
                             "chunked prefill (chunk_offs)")
        pages, slot = paged_write_targets_decode(bt, lens, ps)
        ck.index_put_((pages, slot), k[:, 0].to(ck.dtype))
        cv.index_put_((pages, slot), v[:, 0].to(cv.dtype))
    new_cache = {"k": ck, "v": cv, "idx": lens}

    lk = bt.shape[1] * ps
    kv_len = torch.clamp(lens, max=lk)
    pad_valid = None
    if chunk_offs is not None:
        # query j of row b sits at chunk_offs[b] + j and attends columns <= it
        qpos = (chunk_offs.to(torch.int32)[:, None]
                + torch.arange(sq, dtype=torch.int32, device=dev)[None, :])
        pad_valid = (torch.arange(lk, dtype=torch.int32, device=dev
                                  )[None, None, :] <= qpos[..., None])
    if plan.op("attention_decode").spec.paged:
        o = plan.attention_decode(q, ck, cv, kv_len=kv_len, scale=scale,
                                  pad_valid=pad_valid, block_table=bt,
                                  page_size=ps)
    else:
        # gather the table's pages back to contiguous rows; columns past
        # each row's kv_len are zeroed, as a contiguous cache's unwritten
        # tail would be (the trash page holds other rows' fenced garbage)
        kvh, hdim = ck.shape[2], ck.shape[3]
        live = (torch.arange(lk, device=dev)[None, :]
                < kv_len[:, None])[:, :, None, None]
        btl = bt.long()
        zero = torch.zeros((), dtype=ck.dtype, device=dev)
        o = plan.attention_decode(
            q, torch.where(live, ck[btl].reshape(b, lk, kvh, hdim), zero),
            torch.where(live, cv[btl].reshape(b, lk, kvh, hdim), zero),
            kv_len=kv_len, scale=scale, pad_valid=pad_valid)
    return o, new_cache


# --------------------------------------------------------------------------
# dense FFN
# --------------------------------------------------------------------------

def init_ffn(gen, cfg: ModelConfig, device, dtype) -> Params:
    p = {"w1": _dense_init(gen, (cfg.d_model, cfg.d_ff), device, dtype),
         "w2": _dense_init(gen, (cfg.d_ff, cfg.d_model), device, dtype,
                           fan_in=cfg.d_ff)}
    if cfg.glu:
        p["w3"] = _dense_init(gen, (cfg.d_model, cfg.d_ff), device, dtype)
    return p


def ffn(p: Params, x: torch.Tensor, cfg: ModelConfig,
        plan: ExecPlan | ExecConfig) -> torch.Tensor:
    plan = as_plan(cfg, plan)
    h = _linear(x, p["w1"], plan)
    h = plan.activation(h, cfg.activation)
    if cfg.glu:
        h = h * _linear(x, p["w3"], plan)
    return _linear(h, p["w2"], plan)


# --------------------------------------------------------------------------
# embeddings / unembedding
# --------------------------------------------------------------------------

def max_positions(cfg: ModelConfig) -> int:
    """Rows of the learned position table (the reference's sizing rule):
    8192 for an encoder, else max_seq_len clipped to [8192, 65536]."""
    return min(max(cfg.max_seq_len if cfg.family != "encoder" else 8192,
                   8192), 65_536)


def init_embeddings(gen, cfg: ModelConfig, device, dtype) -> Params:
    p = {"tok_emb": _normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, device,
                            dtype)}
    if cfg.pos_emb == "learned":
        p["pos_emb"] = _normal(gen, (max_positions(cfg), cfg.d_model), 0.02,
                               device, dtype)
    if not cfg.tie_embeddings:
        p["unembed"] = _dense_init(gen, (cfg.d_model, cfg.vocab_size), device,
                                   dtype)
    return p


def embed(p: Params, tokens: torch.Tensor, positions: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings (times ``cfg.embedding_multiplier``) plus learned or
    sinusoidal positions; RoPE and M-RoPE positions act in attention
    instead."""
    x = p["tok_emb"][tokens.long()]
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    return _add_positions(p, x, positions, cfg)


def _add_positions(p: Params, x: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings ``x`` plus learned or sinusoidal positions."""
    if cfg.pos_emb == "learned":
        x = x + p["pos_emb"][positions.long()]
    elif cfg.pos_emb == "sinusoidal":
        hd = cfg.d_model
        exps = torch.arange(0, hd, 2, dtype=torch.float32,
                            device=x.device) / hd
        freqs = 1.0 / torch.pow(torch.tensor(10_000.0, device=x.device), exps)
        ang = positions[..., None].float() * freqs
        x = x + torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(x.dtype)
    return x


def unembed(p: Params, x: torch.Tensor, cfg: ModelConfig,
            plan: ExecPlan | ExecConfig) -> torch.Tensor:
    """Logits through the plan's ``lm_head`` slot, divided by
    ``cfg.logits_scaling``."""
    plan = as_plan(cfg, plan)
    w = p["tok_emb"].T if cfg.tie_embeddings else p["unembed"]
    logits = plan.lm_head(x, w)
    return logits if cfg.logits_scaling == 1.0 else logits / cfg.logits_scaling


# --------------------------------------------------------------------------
# the model axis: each position's heads, FFN columns and vocab rows
# (the reference's `constraint` partitioning; see `repro_torch.dist.tp`)
# --------------------------------------------------------------------------

def attention_tp(p: Params, hs: list, *, cfg: ModelConfig, plan: ExecPlan,
                 positions: list, group, local: bool = False,
                 cross: Optional[list] = None, chunk: int = 1024):
    """Cache-free self- (or, given each position's encoder output
    ``cross``, cross-) attention over a data replica's model positions.

    ``hs``: each position's whole normed input (B, S, D). Returns
    (outputs, kind): with the heads split (``heads`` divides), position m
    projects q, k, v from its ``wq``/``wk``/``wv`` stripes, attends over
    its heads and multiplies by its ``wo`` rows: ``"partial"`` products
    to be summed. Where ``n_kv_heads`` does not divide, k and v are
    projected whole and each position takes the KV groups its q heads use
    (``jnp.repeat`` order). Where the heads do not divide, every position
    computes the layer whole: ``"full"``.
    """
    b, s, _ = hs[0].shape
    hd = cfg.resolved_head_dim
    heff = p["wq"].shape[1]
    kvh = p["wk"].shape[1]
    names = ("batch", None, "heads", None)
    if not group.split((b, s, heff, hd), names, 2):
        outs = []
        for m, (h, pos) in enumerate(zip(hs, positions)):
            pw = {k: group.read(w, m) for k, w in p.items()}
            outs.append(attention(
                pw, h, cfg=cfg, plan=plan, positions=pos, local=local,
                cross_kv=None if cross is None else _cross_kv(pw, cross[m],
                                                              plan),
                chunk=chunk)[0])
        return outs, "full"
    kv_split = group.split((b, s, kvh, hd), names, 2)
    rep = heff // kvh
    kind = ("cross" if cross is not None else "bidir" if not cfg.causal
            else "local" if local else "causal")
    outs = []
    for m, (h, pos) in enumerate(zip(hs, positions)):
        h0, h1 = group.bounds(heff, m)
        q = _linear(h, group.read(p["wq"], m, 1, "wq"), plan,
                    group.read(p.get("bq"), m, 0))
        src = h if cross is None else cross[m]
        if kv_split:
            k, v = (_linear(src, group.read(p[w], m, 1, w), plan,
                            group.read(p.get(bias), m, 0))
                    for w, bias in (("wk", "bk"), ("wv", "bv")))
        else:
            k, v = (_linear(src, group.read(p[w], m, name=w), plan,
                            group.read(p.get(bias), m))
                    for w, bias in (("wk", "bk"), ("wv", "bv")))
        if cfg.pos_emb in ("rope", "mrope") and cross is None:
            q = apply_rope(q, pos, cfg)
            k = apply_rope(k, pos, cfg)
        if not kv_split:  # the KV groups of this position's q heads
            k, v = (t.repeat_interleave(rep, dim=2)[:, :, h0:h1]
                    for t in (k, v))
        o = plan.attention_prefill(q, k, v, scale=1.0 / math.sqrt(hd),
                                   q_offset=0, kind=kind, window=cfg.window,
                                   chunk=chunk, probs_dtype=_probs_dtype(cfg),
                                   pad_lens=None)
        o = o.reshape(b, s, h1 - h0, hd).to(h.dtype)
        if heff > cfg.n_heads:  # hard-mask padded heads
            o = o * (torch.arange(h0, h1, device=h.device) < cfg.n_heads
                     )[None, None, :, None].to(o.dtype)
        wo = group.read(p["wo"], m, 0, "wo")
        outs.append(torch.einsum("bshd,hdm->bsm", o, wo.to(h.dtype)))
    return outs, "partial"


def _cross_kv(p: Params, enc: torch.Tensor, plan: ExecPlan) -> tuple:
    """Cross attention's (k, v) of an encoder output, whole."""
    return (_linear(enc, p["wk"], plan, p.get("bk")),
            _linear(enc, p["wv"], plan, p.get("bv")))


def ffn_tp(p: Params, hs: list, cfg: ModelConfig, plan: ExecPlan, group):
    """The dense FFN over the model positions: with ``mlp`` dividing,
    position m's ``w1``/``w3`` columns and ``w2`` rows, ``"partial"``
    products; else the FFN whole on every position, ``"full"``."""
    b, s, _ = hs[0].shape
    F_ = p["w1"].shape[1]
    if not group.split((b, s, F_), ("batch", None, "mlp"), 2):
        return [ffn({k: group.read(w, m) for k, w in p.items()}, h, cfg,
                    plan) for m, h in enumerate(hs)], "full"
    cols = {"w1": 1, "w2": 0, "w3": 1}  # w2 row-parallel
    return [ffn({k: group.read(w, m, cols[k], k) for k, w in p.items()}, h,
                cfg, plan) for m, h in enumerate(hs)], "partial"


def _vocab_table(p: Params, cfg: ModelConfig) -> tuple:
    """The (V, D) token table and the lm head's weight with its vocab
    dimension: (tok_emb, 0) when tied, else (unembed, 1)."""
    return (p["tok_emb"], 0) if cfg.tie_embeddings else (p["unembed"], 1)


def embed_tp(p: Params, tokens: list, positions: list, cfg: ModelConfig,
             group, sp: bool) -> list:
    """`embed` over the model positions, in the residual stream's layout
    (sequence shards when ``sp``). With ``vocab`` dividing, position m
    looks up the tokens its ``tok_emb`` rows hold (zeros for the rest) and
    the parts are summed (one nonzero term a token: exact); else each
    position looks up its tokens in the whole table."""
    V, D = p["tok_emb"].shape
    if group.split((V, D), ("vocab", None), 0):
        parts = []
        for m, tok in enumerate(tokens):
            lo, hi = group.bounds(V, m)
            rows = group.read(p["tok_emb"], m, 0, "tok_emb")
            t = tok.long()
            hit = ((t >= lo) & (t < hi))[..., None]
            parts.append(torch.where(hit, rows[torch.where(
                hit[..., 0], t - lo, 0)], torch.zeros((), dtype=rows.dtype,
                                                      device=rows.device)))
        xs = group.finish(parts, "partial", sp)
    else:
        xs = group.finish([group.read(p["tok_emb"], m)[tok.long()]
                           for m, tok in enumerate(tokens)], "full", sp)
    if sp:
        positions = group.take(positions, -1)
    return [_add_positions({k: group.read(v, m) for k, v in p.items()
                            if k == "pos_emb"}, x, pos, cfg)
            for m, (x, pos) in enumerate(zip(xs, positions))]
