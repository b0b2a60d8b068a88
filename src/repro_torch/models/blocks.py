"""The layer stack: one parameter dict per layer, a Python loop over layers.

The port of `repro.models.blocks` for decoder-only all-attention stacks
with dense FFNs. The reference stacks each period position's parameters
along a scan dimension (`blocks.init_stack`); the port keeps a plain list
of per-layer dicts in layer order (`repro_torch.ckpt` unstacks the
reference's layout) and runs the layers in a Python loop in place of
``jax.lax.scan``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ExecConfig, ModelConfig
from ..exec.plan import ExecPlan, as_plan
from ..exec.plan import layer_plan as _mixer_plan
from . import layers

Params = dict


def _check_layer(cfg: ModelConfig, mixer: str, ffn_kind: str) -> None:
    if mixer != "attn" or ffn_kind != "dense":
        raise NotImplementedError(
            f"layer kind ({mixer}, {ffn_kind}) is not ported yet; the port "
            f"serves decoder-only global-attention stacks with dense FFNs")


def init_layer(gen, cfg: ModelConfig, mixer: str, ffn_kind: str, device,
               dtype) -> Params:
    _check_layer(cfg, mixer, ffn_kind)
    return {"norm1": layers.init_norm(cfg, device, dtype),
            "attn": layers.init_attention(gen, cfg, device, dtype),
            "norm2": layers.init_norm(cfg, device, dtype),
            "ffn": layers.init_ffn(gen, cfg, device, dtype)}


def apply_layer(p: Params, x: torch.Tensor, *, cfg: ModelConfig,
                plan: ExecPlan | ExecConfig, mixer: str, ffn_kind: str,
                positions: torch.Tensor, cache: Params,
                slot_lens: torch.Tensor, block_table: torch.Tensor,
                page_size: int, chunk_offs: Optional[torch.Tensor] = None):
    _check_layer(cfg, mixer, ffn_kind)
    plan = _mixer_plan(as_plan(cfg, plan), mixer)
    h = layers.apply_norm(p["norm1"], x, cfg)
    m, new_cache = layers.attention(
        p["attn"], h, cfg=cfg, plan=plan, positions=positions,
        cache=cache["attn"], slot_lens=slot_lens, block_table=block_table,
        page_size=page_size, chunk_offs=chunk_offs)
    x = x + m
    h2 = layers.apply_norm(p["norm2"], x, cfg)
    x = x + layers.ffn(p["ffn"], h2, cfg, plan)
    return x, {"attn": new_cache}


def init_layer_cache(cfg: ModelConfig, mixer: str, batch: int, device, dtype,
                     page_size: int, n_pages: int) -> Params:
    """One layer's block-paged cache: k/v are an (n_pages, page_size, KV, hd)
    pool shared by every slot; ``idx`` is the (batch,) per-slot fill."""
    if mixer != "attn":
        raise NotImplementedError(
            f"block-paged caches cover global attention layers only; mixer "
            f"{mixer!r} keeps its own state layout")
    hd = cfg.resolved_head_dim
    shape = (n_pages, page_size, cfg.n_kv_heads, hd)
    return {"attn": {
        "k": torch.zeros(shape, device=device, dtype=dtype),
        "v": torch.zeros(shape, device=device, dtype=dtype),
        "idx": torch.zeros((batch,), device=device, dtype=torch.int32),
    }}


def init_stack(gen, cfg: ModelConfig, device, dtype) -> list:
    """Per-layer parameter dicts in layer order."""
    return [init_layer(gen, cfg, *cfg.layer_spec(i), device, dtype)
            for i in range(cfg.n_layers)]


def init_stack_cache(cfg: ModelConfig, batch: int, device, dtype,
                     page_size: int, n_pages: int) -> list:
    return [init_layer_cache(cfg, cfg.layer_spec(i)[0], batch, device, dtype,
                             page_size, n_pages)
            for i in range(cfg.n_layers)]


def apply_stack(params: list, x: torch.Tensor, *, cfg: ModelConfig,
                plan: ExecPlan | ExecConfig, positions: torch.Tensor,
                caches: list, slot_lens: torch.Tensor,
                block_table: torch.Tensor, page_size: int,
                chunk_offs: Optional[torch.Tensor] = None):
    """Run the stack over a paged cache (one block table for every layer)."""
    plan = as_plan(cfg, plan)
    new_caches = []
    for i, (p, c) in enumerate(zip(params, caches)):
        mixer, ffn_kind = cfg.layer_spec(i)
        x, nc = apply_layer(p, x, cfg=cfg, plan=plan, mixer=mixer,
                            ffn_kind=ffn_kind, positions=positions, cache=c,
                            slot_lens=slot_lens, block_table=block_table,
                            page_size=page_size, chunk_offs=chunk_offs)
        new_caches.append(nc)
    return x, new_caches
