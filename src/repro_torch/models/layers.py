"""Transformer building blocks: norms, positions, attention, FFN.

The port of `repro.models.layers` for the paged serving path. Parameters
are plain dicts of tensors, one dict per layer, and every layer call
dispatches through the resolved `repro_torch.exec.ExecPlan` exactly as the
reference does. Attention covers the block-paged KV cache only: the Sq=1
decode step and the chunked-prefill step, with the page-table kernels for
paged backends and the gather degrade for every other backend.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..configs.base import ExecConfig, ModelConfig
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
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
        return (y * p["scale"].float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-6)
    if cfg.norm == "layernorm":
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# rotary positions
# --------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, H, hd). positions: (B, S)."""
    if cfg.pos_emb != "rope":
        raise NotImplementedError(f"pos_emb={cfg.pos_emb!r} is not ported yet")
    hd = x.shape[-1]
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    freqs = 1.0 / torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                         device=x.device), exps)
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang)[:, :, None, :]  # (B, S, 1, hd/2)
    sin = torch.sin(ang)[:, :, None, :]
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
    out = fn(qh, k_pool.float(), v_pool.float(), kv_len, block_table,
             mask=mask, softmax_mode=plan.exec_cfg.softmax_mode)
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


def attention(p: Params, x: torch.Tensor, *, cfg: ModelConfig,
              plan: ExecPlan | ExecConfig, positions: torch.Tensor,
              cache: Params, slot_lens: torch.Tensor,
              block_table: torch.Tensor, page_size: int,
              chunk_offs: Optional[torch.Tensor] = None):
    """Self-attention against a block-paged KV cache.

    ``cache["k"]``/``"v"`` are the (n_pages, page_size, KV, hd) pool shared
    by every slot; row b's logical column c lives at pool position
    (block_table[b, c // page_size], c % page_size). Two step shapes: the
    Sq=1 decode step (the new k/v land at column ``slot_lens[b] - 1``) and
    the chunked-prefill step (``chunk_offs`` given: row b streams into
    columns [chunk_offs[b], slot_lens[b])). Paged backends get the pool and
    table; any other backend is served by gathering the table's pages back
    to contiguous rows, a degrade, never an error.
    """
    plan = as_plan(cfg, plan)
    b, sq, _ = x.shape
    hd = cfg.resolved_head_dim
    q = _linear(x, p["wq"], plan, p.get("bq"))
    k = _linear(x, p["wk"], plan, p.get("bk"))
    v = _linear(x, p["wv"], plan, p.get("bv"))
    if cfg.pos_emb in ("rope", "mrope"):
        q = apply_rope(q, positions, cfg)
        k = apply_rope(k, positions, cfg)
    if block_table is None or page_size is None:
        raise NotImplementedError(
            "only the block-paged KV cache is ported; the contiguous cache "
            "comes with the solo generate path")

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

    scale = 1.0 / math.sqrt(hd)
    mp = bt.shape[1]
    lk = mp * ps
    kv_len = torch.clamp(lens, max=lk)
    pad_valid = None
    if chunk_offs is not None:
        # query j of row b sits at chunk_offs[b] + j and attends columns <= it
        qpos = (chunk_offs.to(torch.int32)[:, None]
                + torch.arange(sq, dtype=torch.int32, device=x.device)[None, :])
        pad_valid = (torch.arange(lk, dtype=torch.int32, device=x.device
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
        live = (torch.arange(lk, device=x.device)[None, :]
                < kv_len[:, None])[:, :, None, None]
        btl = bt.long()
        zero = torch.zeros((), dtype=ck.dtype, device=x.device)
        o = plan.attention_decode(
            q, torch.where(live, ck[btl].reshape(b, lk, kvh, hdim), zero),
            torch.where(live, cv[btl].reshape(b, lk, kvh, hdim), zero),
            kv_len=kv_len, scale=scale, pad_valid=pad_valid)

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
    """Rows of the learned position table (the reference's sizing rule)."""
    return min(max(cfg.max_seq_len, 8192), 65_536)


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
    x = p["tok_emb"][tokens.long()]
    if cfg.pos_emb == "learned":
        x = x + p["pos_emb"][positions.long()]
    elif cfg.pos_emb not in ("rope", "none"):
        raise NotImplementedError(f"pos_emb={cfg.pos_emb!r} is not ported yet")
    return x


def unembed(p: Params, x: torch.Tensor, cfg: ModelConfig,
            plan: ExecPlan | ExecConfig) -> torch.Tensor:
    """Logits through the plan's ``lm_head`` slot."""
    plan = as_plan(cfg, plan)
    w = p["tok_emb"].T if cfg.tie_embeddings else p["unembed"]
    return plan.lm_head(x, w)
