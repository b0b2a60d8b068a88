"""Top-level decoder LM over a block-paged slot cache.

The port of the serving half of `repro.models.model`:

    model = Model(cfg, exec_cfg, device="cuda")
    params = model.init(torch.Generator(device).manual_seed(0))
    cache = model.init_slot_cache(n_slots, max_len, page_size=64, n_pages=N)
    logits, cache = model.prefill_chunk(params, tokens, cache, offs, lens,
                                        block_table, page_size)
    logits, cache = model.decode_step(params, token, cache, slot_lens=...,
                                      block_table=..., page_size=...)

``params`` is ``{"embed": {...}, "final_norm": {...}, "blocks": [layer
dict, ...]}``; `quantize_model_params` turns weight matrices into resident
`QuantizedWeight` codes bit-identical to the reference's.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_device
from ..configs.base import ExecConfig, ModelConfig
from ..exec.plan import ExecPlan, as_plan
from . import blocks, layers

Params = dict

# weight leaves that live on crossbars as int8 conductance codes when serving
_QUANTIZABLE = {"wq", "wk", "wv", "wo", "w1", "w2", "w3", "unembed",
                "w_z", "w_x", "w_B", "w_C", "w_dt", "out_proj"}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def quantize_model_params(params: Params) -> Params:
    """Weight matrices -> resident int8 codes + per-column scales.

    The reference runs this eagerly, so its ``/ 127.0`` is a true division
    (a jitted graph would multiply by the reciprocal); ``wo`` contracts over
    (heads, head_dim).
    """
    def q2d(leaf, name):
        arr = leaf.float()
        if name == "wo":
            arr = arr.reshape(-1, arr.shape[-1])
        flat = arr.reshape(arr.shape[0], -1)                 # (K, N)
        amax = flat.abs().amax(dim=0, keepdim=True)
        scale = torch.clamp_min(amax, 1e-12) / 127.0
        codes = torch.clamp(torch.round(flat / scale), -128, 127).to(torch.int8)
        return layers.QuantizedWeight(codes, scale.float(), tuple(arr.shape[1:]))

    def walk(tree):
        if isinstance(tree, dict):
            return {name: (q2d(leaf, name) if name in _QUANTIZABLE
                           and isinstance(leaf, torch.Tensor) and leaf.ndim >= 2
                           else walk(leaf)) for name, leaf in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(x) for x in tree)
        return tree

    return walk(params)


def params_to(params, device):
    """Move a parameter tree (tensors and resident weights) to ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(x, device) for x in params)
    if isinstance(params, (torch.Tensor, layers.QuantizedWeight)):
        return params.to(device)
    return params


class Model:
    def __init__(self, cfg: ModelConfig,
                 exec_cfg: "ExecConfig | ExecPlan" = ExecConfig(),
                 device=None):
        self.cfg = cfg
        self.plan = as_plan(cfg, exec_cfg)
        self.exec_cfg = self.plan.exec_cfg
        self.device = resolve_device(device)
        if cfg.is_encoder_decoder:
            raise NotImplementedError("encoder-decoder models are not ported")

    @property
    def param_dtype(self):
        return _DTYPES[self.cfg.param_dtype]

    @property
    def compute_dtype(self):
        return _DTYPES[self.cfg.compute_dtype]

    def init(self, gen: torch.Generator) -> Params:
        """Fresh weights with the reference's distributions, drawn from
        ``gen`` (a generator on this model's device)."""
        cfg, dev, dt = self.cfg, self.device, self.param_dtype
        return {"embed": layers.init_embeddings(gen, cfg, dev, dt),
                "final_norm": layers.init_norm(cfg, dev, dt),
                "blocks": blocks.init_stack(gen, cfg, dev, dt)}

    def init_slot_cache(self, n_slots: int, max_len: int, dtype=None,
                        page_size: Optional[int] = None,
                        n_pages: Optional[int] = None) -> list:
        """A block-paged slot-pool cache: every attention layer gets an
        (n_pages, page_size, KV, hd) pool shared by all slots (page 0 is the
        trash page) and a (n_slots,) fill vector. ``max_len`` documents
        intent; capacity follows the block table the caller threads in."""
        if page_size is None or n_pages is None:
            raise NotImplementedError(
                "only block-paged slot caches are ported (pass page_size "
                "and n_pages)")
        return blocks.init_stack_cache(self.cfg, n_slots, self.device,
                                       dtype or self.compute_dtype,
                                       page_size, n_pages)

    def _trunk(self, params, tokens, positions, cache, slot_lens, block_table,
               page_size, chunk_offs=None):
        cfg = self.cfg
        x = layers.embed(params["embed"], tokens, positions, cfg)
        x = x.to(self.compute_dtype)
        x, new_cache = blocks.apply_stack(
            params["blocks"], x, cfg=cfg, plan=self.plan, positions=positions,
            caches=cache, slot_lens=slot_lens, block_table=block_table,
            page_size=page_size, chunk_offs=chunk_offs)
        return layers.apply_norm(params["final_norm"], x, cfg), new_cache

    def decode_step(self, params: Params, token: torch.Tensor, cache: list,
                    slot_lens: torch.Tensor, block_table: torch.Tensor,
                    page_size: int):
        """token: (B, 1). Returns (logits (B, 1, V), cache).

        ``slot_lens`` (B,) counts row b's valid cache columns including the
        token decoded this step (0 = an empty slot, a dead row).
        """
        lens = slot_lens.to(torch.int32)
        positions = torch.clamp(lens - 1, min=0)[:, None].expand(token.shape)
        x, new_cache = self._trunk(params, token, positions, cache, lens,
                                   block_table, page_size)
        return layers.unembed(params["embed"], x, self.cfg, self.plan), new_cache

    def prefill_chunk(self, params: Params, tokens: torch.Tensor, cache: list,
                      chunk_offs: torch.Tensor, chunk_lens: torch.Tensor,
                      block_table: torch.Tensor, page_size: int):
        """Stream one prompt chunk per slot into the paged cache.

        tokens: (B, C); row b carries ``chunk_lens[b]`` prompt tokens for
        logical columns [chunk_offs[b], chunk_offs[b] + chunk_lens[b]).
        Returns (logits (B, 1, V) at each row's last fed position, cache).
        """
        offs = chunk_offs.to(torch.int32)
        feed = chunk_lens.to(torch.int32)
        positions = offs[:, None] + torch.arange(
            tokens.shape[1], dtype=torch.int32, device=tokens.device)[None, :]
        x, new_cache = self._trunk(params, tokens, positions, cache,
                                   offs + feed, block_table, page_size,
                                   chunk_offs=offs)
        last = torch.clamp(feed - 1, min=0).long()
        x_last = x[torch.arange(x.shape[0], device=x.device), last][:, None]
        return (layers.unembed(params["embed"], x_last, self.cfg, self.plan),
                new_cache)
