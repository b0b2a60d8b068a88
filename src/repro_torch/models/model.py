"""Top-level decoder LM over a contiguous or block-paged KV cache.

The port of the serving half of `repro.models.model`:

    model = Model(cfg, exec_cfg, device="cuda")
    params = model.init(torch.Generator(device).manual_seed(0))
    cache = model.init_cache(batch, max_len)            # solo / buckets
    logits, cache = model.prefill(params, prompts, cache, pad_lens=None)
    logits, cache = model.decode_step(params, token, cache)
    cache = model.init_slot_cache(n_slots, max_len)     # contiguous slots
    logits, cache = model.decode_step(params, token, cache, slot_lens=...,
                                      pad_lens=..., pad_prompt_len=...)
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
    (heads, head_dim). A ``moe`` subtree (router and experts) stays float:
    the same tensor objects come back, as in the reference.
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
                           else leaf if name == "moe"
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

    def init_cache(self, batch: int, max_len: int, dtype=None) -> list:
        """A contiguous KV cache: (batch, L, KV, hd) buffers and a scalar
        write index per layer; L is max_len for a global layer and
        min(max_len, window) for a local layer's ring."""
        return blocks.init_stack_cache(self.cfg, batch, max_len, self.device,
                                       dtype or self.compute_dtype)

    def init_slot_cache(self, n_slots: int, max_len: int, dtype=None,
                        page_size: Optional[int] = None,
                        n_pages: Optional[int] = None) -> list:
        """A slot-pool cache for continuous batching.

        Without pages: `init_cache`'s (n_slots, L, KV, hd) buffers (rings
        for local layers) with a (n_slots,) write index per layer, one per
        slot, so every row fills and retires on its own. With
        ``page_size``/``n_pages`` (global-attention stacks only): every
        attention layer gets an (n_pages, page_size, KV, hd) pool shared by
        all slots (page 0 is the trash page) and a (n_slots,) fill vector;
        ``max_len`` then documents intent, capacity follows the block table
        the caller threads in. Mamba layers keep one state row per slot and
        no write index."""
        if page_size is None:
            cache = self.init_cache(n_slots, max_len, dtype)
            for layer in cache:
                if "attn" in layer:
                    layer["attn"]["idx"] = torch.zeros(
                        (n_slots,), dtype=torch.int32, device=self.device)
            return cache
        return blocks.init_stack_cache(self.cfg, n_slots, max_len,
                                       self.device,
                                       dtype or self.compute_dtype,
                                       page_size, n_pages)

    def _positions(self, tokens: torch.Tensor, offset=0) -> torch.Tensor:
        b, s = tokens.shape[:2]
        pos = torch.arange(s, dtype=torch.int32, device=tokens.device) + offset
        return pos.expand(b, s)

    def _trunk(self, params, tokens, positions, cache, pad_lens=None,
               pad_prompt_len=None, slot_lens=None, block_table=None,
               page_size=None, chunk_offs=None):
        cfg = self.cfg
        x = layers.embed(params["embed"], tokens, positions, cfg)
        x = x.to(self.compute_dtype)
        x, new_cache = blocks.apply_stack(
            params["blocks"], x, cfg=cfg, plan=self.plan, positions=positions,
            caches=cache, pad_lens=pad_lens, pad_prompt_len=pad_prompt_len,
            slot_lens=slot_lens, block_table=block_table,
            page_size=page_size, chunk_offs=chunk_offs)
        return layers.apply_norm(params["final_norm"], x, cfg), new_cache

    def prefill(self, params: Params, tokens: torch.Tensor, cache: list,
                positions=None, pad_lens=None):
        """Process the prompt; returns last-position logits and the cache.

        ``pad_lens`` (B,) int32: per-row left-pad prefix lengths (bucketed
        serving). Real tokens sit at positions shifted down by their row's
        pad count (pad columns clip to 0), and attention masks the pad
        columns per row, so a request's prefill does not depend on its
        bucket-mates.
        """
        if positions is None:
            positions = self._positions(tokens)
            if pad_lens is not None:
                positions = torch.clamp(
                    positions - pad_lens[:, None].to(torch.int32), min=0)
        x, new_cache = self._trunk(params, tokens, positions, cache,
                                   pad_lens=pad_lens)
        return (layers.unembed(params["embed"], x[:, -1:], self.cfg, self.plan),
                new_cache)

    def decode_step(self, params: Params, token: torch.Tensor, cache: list,
                    slot_lens: Optional[torch.Tensor] = None,
                    block_table: Optional[torch.Tensor] = None,
                    page_size: Optional[int] = None, pad_lens=None,
                    pad_prompt_len=None):
        """token: (B, 1). Returns (logits (B, 1, V), cache).

        Contiguous caches (no ``slot_lens``): the new token sits at the
        cache's write index, less the row's pad count under ``pad_lens``.
        ``slot_lens`` (B,) counts row b's valid cache columns including the
        token decoded this step (0 = an empty slot, a dead row);
        ``block_table``/``page_size`` address a block-paged slot cache.
        """
        if slot_lens is not None:
            lens = slot_lens.to(torch.int32)
            positions = torch.clamp(lens - 1, min=0)[:, None].expand(
                token.shape)
        else:
            lens = None
            positions = self._cache_index(cache).to(torch.int32).expand(
                token.shape)
        if pad_lens is not None:
            positions = torch.clamp(
                positions - pad_lens[:, None].to(torch.int32), min=0)
        x, new_cache = self._trunk(params, token, positions, cache,
                                   pad_lens=pad_lens,
                                   pad_prompt_len=pad_prompt_len,
                                   slot_lens=lens, block_table=block_table,
                                   page_size=page_size)
        return layers.unembed(params["embed"], x, self.cfg, self.plan), new_cache

    def _cache_index(self, cache: list) -> torch.Tensor:
        """The write index of the first attention layer's cache (its max,
        per slot); zero for a stack with no attention layer."""
        for layer in cache:
            if "attn" in layer:
                idx = layer["attn"]["idx"]
                return idx.amax() if idx.ndim else idx
        return torch.zeros((), dtype=torch.int32, device=self.device)

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
                                   slot_lens=offs + feed,
                                   block_table=block_table,
                                   page_size=page_size, chunk_offs=offs)
        last = torch.clamp(feed - 1, min=0).long()
        x_last = x[torch.arange(x.shape[0], device=x.device), last][:, None]
        return (layers.unembed(params["embed"], x_last, self.cfg, self.plan),
                new_cache)
