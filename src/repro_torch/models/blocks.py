"""The layer stack: one parameter dict per layer, a Python loop over layers.

The port of `repro.models.blocks` for stacks whose mixers are global
(``attn``) or sliding-window (``attn_local``) attention or Mamba-2
(``mamba``), with dense, Mixture-of-Experts (``moe``) or no (``none``) FFN;
an encoder-decoder's decoder layers (``cross=True``) add a norm and cross
attention over the encoder's keys between the mixer and the FFN.
Attention layers keep contiguous KV caches of two lengths (max_len columns
for global layers, a ring of min(max_len, window) for local ones) or
block-paged pools (global layers only); Mamba layers keep their SSM state
and the last conv_width - 1 conv inputs, and have no paged form. The
reference stacks each period position's parameters along a scan dimension
(`blocks.init_stack`); the port keeps a plain list of per-layer dicts in
layer order (`repro_torch.ckpt` unstacks the reference's layout) and runs
the layers in a Python loop in place of ``jax.lax.scan``. Mamba layers
ignore ``positions`` and ``slot_lens``, and ``pad_lens`` unless
``cfg.ssm_skip_pads`` holds the pads out of their state (`ssm.mamba`); as in
the reference, the SSM otherwise scans through left pads, and a slot's
state is overwritten when the slot is re-admitted.

Beyond the reference, a MoE layer of a config with ``shared_d_ff`` adds a
dense SiLU-GLU shared expert (``p["shared"]``, resident like any dense FFN,
span ``moe.shared``) to the routed experts' output, and
``residual_multiplier`` scales each branch before it joins the residual
stream; their defaults take the reference's path unchanged.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import trace
from ..configs.base import ExecConfig, ModelConfig
from ..dist.sharding import gather_tree, is_placed
from ..dist.tp import all_gather
from ..exec.plan import ExecPlan, as_plan
from ..exec.plan import layer_plan as _mixer_plan
from . import layers, moe as moe_mod, ssm

Params = dict


_ATTN = ("attn", "attn_local")


def _check_layer(cfg: ModelConfig, mixer: str, ffn_kind: str) -> None:
    if mixer not in _ATTN + ("mamba",) or ffn_kind not in ("dense", "moe",
                                                            "none"):
        raise NotImplementedError(
            f"layer kind ({mixer}, {ffn_kind}) is not ported yet; the port "
            f"serves decoder-only stacks of attention (global and local) and "
            f"Mamba-2 layers with dense, MoE or no FFN")


def _shared_cfg(cfg: ModelConfig) -> ModelConfig:
    """The shared expert's dense FFN: the config at its own width."""
    return cfg.replace(d_ff=cfg.shared_d_ff)


def _branch(cfg: ModelConfig, y: torch.Tensor) -> torch.Tensor:
    """A mixer's or FFN's output as it joins the residual stream."""
    r = cfg.residual_multiplier
    return y if r == 1.0 else y * r


def init_layer(gen, cfg: ModelConfig, mixer: str, ffn_kind: str, device,
               dtype, cross: bool = False) -> Params:
    _check_layer(cfg, mixer, ffn_kind)
    p = {"norm1": layers.init_norm(cfg, device, dtype)}
    if mixer == "mamba":
        p["mamba"] = ssm.init_mamba_with_out(gen, cfg, device, dtype)
    else:
        p["attn"] = layers.init_attention(gen, cfg, device, dtype)
    if cross:
        p["norm_x"] = layers.init_norm(cfg, device, dtype)
        p["cross"] = layers.init_attention(gen, cfg, device, dtype)
    if ffn_kind != "none":  # no norm2 without an FFN, as in the reference
        p["norm2"] = layers.init_norm(cfg, device, dtype)
    if ffn_kind == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg, device, dtype)
        if cfg.shared_d_ff:
            p["shared"] = layers.init_ffn(gen, _shared_cfg(cfg), device,
                                          dtype)
    elif ffn_kind == "dense":
        p["ffn"] = layers.init_ffn(gen, cfg, device, dtype)
    return p


def apply_layer(p: Params, x: torch.Tensor, *, cfg: ModelConfig,
                plan: ExecPlan | ExecConfig, mixer: str, ffn_kind: str,
                positions: torch.Tensor, cache: Optional[Params] = None,
                pad_lens: Optional[torch.Tensor] = None, pad_prompt_len=None,
                slot_lens: Optional[torch.Tensor] = None,
                block_table: Optional[torch.Tensor] = None,
                page_size: Optional[int] = None,
                chunk_offs: Optional[torch.Tensor] = None,
                enc_kv: Optional[tuple] = None):
    """One layer: the mixer, then (a decoder layer given ``enc_kv``, the
    encoder's (k, v)) cross attention, then the FFN, each on a normed
    input added to the residual stream."""
    _check_layer(cfg, mixer, ffn_kind)
    plan = _mixer_plan(as_plan(cfg, plan), mixer)
    h = layers.apply_norm(p["norm1"], x, cfg)
    if mixer == "mamba":
        kind = "mamba"
        m, new_cache = ssm.mamba(p["mamba"], h, cfg=cfg, plan=plan,
                                 cache=cache["mamba"] if cache else None,
                                 pad_lens=pad_lens)
    else:
        kind = "attn"
        m, new_cache = layers.attention(
            p["attn"], h, cfg=cfg, plan=plan, positions=positions,
            local=(mixer == "attn_local"),
            cache=cache["attn"] if cache else None, pad_lens=pad_lens,
            pad_prompt_len=pad_prompt_len, slot_lens=slot_lens,
            block_table=block_table, page_size=page_size,
            chunk_offs=chunk_offs)
    x = x + _branch(cfg, m)
    if "cross" in p and enc_kv is not None:
        cx, _ = layers.attention(p["cross"],
                                 layers.apply_norm(p["norm_x"], x, cfg),
                                 cfg=cfg, plan=plan, positions=positions,
                                 cross_kv=enc_kv)
        x = x + cx
    if ffn_kind == "moe":
        h = layers.apply_norm(p["norm2"], x, cfg)
        y = moe_mod.moe(p["moe"], h, cfg, plan)
        if "shared" in p:
            with trace.span("moe.shared"):
                y = y + layers.ffn(p["shared"], h, _shared_cfg(cfg), plan)
        x = x + _branch(cfg, y)
    elif ffn_kind == "dense":
        x = x + _branch(cfg, layers.ffn(
            p["ffn"], layers.apply_norm(p["norm2"], x, cfg), cfg, plan))
    return x, ({kind: new_cache} if new_cache is not None else None)


def init_layer_cache(cfg: ModelConfig, mixer: str, batch: int, max_len: int,
                     device, dtype, page_size: Optional[int] = None,
                     n_pages: Optional[int] = None) -> Params:
    """One layer's decode cache.

    Contiguous: k/v (batch, L, KV, hd) and a scalar write index, with L =
    max_len for a global layer and a ring of L = min(max_len, window) for a
    local one, so one stack's caches come in two lengths. Block-paged
    (``page_size``/``n_pages``, global layers only): k/v are an (n_pages,
    page_size, KV, hd) pool shared by every slot and ``idx`` is the
    (batch,) per-slot fill; ``max_len`` then only documents intent. A Mamba
    layer: its SSM state (batch, H, P, N) float32 and the last conv_width -
    1 inputs of its three convolutions in ``dtype``; it has no write index.
    """
    if mixer not in _ATTN + ("mamba",):
        raise NotImplementedError(
            f"decode caches cover attention and Mamba layers; mixer "
            f"{mixer!r} is not ported")
    if page_size is not None and mixer != "attn":
        raise NotImplementedError(
            f"block-paged caches cover global attention layers only; "
            f"mixer {mixer!r} keeps its own state layout (serve "
            f"contiguous for this config)")
    if mixer == "mamba":
        W, GN = cfg.conv_width, cfg.ssm_groups * cfg.ssm_state
        return {"mamba": {
            "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim,
                                  cfg.ssm_state), device=device,
                                 dtype=torch.float32),
            "conv_x": torch.zeros((batch, W - 1, cfg.d_inner), device=device,
                                  dtype=dtype),
            "conv_B": torch.zeros((batch, W - 1, GN), device=device,
                                  dtype=dtype),
            "conv_C": torch.zeros((batch, W - 1, GN), device=device,
                                  dtype=dtype),
        }}
    hd = cfg.resolved_head_dim
    if page_size is not None:
        if n_pages is None:
            raise ValueError("paged caches need n_pages")
        shape = (n_pages, page_size, cfg.n_kv_heads, hd)
        idx = torch.zeros((batch,), device=device, dtype=torch.int32)
    else:
        # local layers keep a ring buffer of window size
        length = min(max_len, cfg.window) if mixer == "attn_local" else max_len
        shape = (batch, length, cfg.n_kv_heads, hd)
        idx = torch.zeros((), device=device, dtype=torch.int32)
    return {"attn": {
        "k": torch.zeros(shape, device=device, dtype=dtype),
        "v": torch.zeros(shape, device=device, dtype=dtype),
        "idx": idx,
    }}


def init_stack(gen, cfg: ModelConfig, device, dtype,
               n_layers: Optional[int] = None, cross: bool = False) -> list:
    """Per-layer parameter dicts in layer order; ``n_layers`` defaults to
    ``cfg.n_layers`` (an encoder stack passes ``n_encoder_layers``)."""
    n = cfg.n_layers if n_layers is None else n_layers
    return [init_layer(gen, cfg, *cfg.layer_spec(i), device, dtype,
                       cross=cross)
            for i in range(n)]


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                     dtype, page_size: Optional[int] = None,
                     n_pages: Optional[int] = None) -> list:
    return [init_layer_cache(cfg, cfg.layer_spec(i)[0], batch, max_len,
                             device, dtype, page_size, n_pages)
            for i in range(cfg.n_layers)]


# the weight products: matrix products with no batch dimension, the
# analogue of JAX's dots_with_no_batch_dims_saveable; an einsum lowers such
# a product (attention's output projection) to a bmm of batch 1
_WEIGHT_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_weight_products(ctx, op, *args, **kwargs):
    saved = op in _WEIGHT_PRODUCTS or (op is torch.ops.aten.bmm.default
                                       and args[0].shape[0] == 1)
    return (CheckpointPolicy.MUST_SAVE if saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, cfg: ModelConfig):
    """``fn`` under activation checkpointing, by ``cfg.remat``: ``none``
    keeps every activation, ``full`` recomputes the layer in the backward
    pass, ``dots`` keeps the weight products' outputs and recomputes the
    rest. Recomputation changes no number."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_weight_products)
    elif cfg.remat != "full":
        raise ValueError(f"remat={cfg.remat!r}: none, full or dots")
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def _gathered_layer(p: Params, x: torch.Tensor, **kw):
    """`apply_layer` on a placed layer: its leaves gathered whole onto
    ``x``'s device first (a ``moe`` subtree is left placed: `moe.moe`
    reads the stripes its shards own)."""
    return apply_layer(gather_tree(p, x.device, skip=("moe",)), x, **kw)


def apply_stack(params: list, x: torch.Tensor, *, cfg: ModelConfig,
                plan: ExecPlan | ExecConfig, positions: torch.Tensor,
                caches: Optional[list], pad_lens: Optional[torch.Tensor] = None,
                pad_prompt_len=None, slot_lens: Optional[torch.Tensor] = None,
                block_table: Optional[torch.Tensor] = None,
                page_size: Optional[int] = None,
                chunk_offs: Optional[torch.Tensor] = None,
                enc_kv: Optional[list] = None, use_remat: bool = False):
    """Run every layer of ``params``; ``caches`` is `init_stack_cache`'s
    list (or None).

    ``pad_lens`` (B,) marks per-row left-pad prefixes of a bucket;
    ``block_table`` + ``page_size`` mark the caches as block-paged pools
    (one table for every layer); ``chunk_offs`` makes the call a
    chunked-prefill step; ``enc_kv`` is a decoder stack's per-layer cross
    (k, v) over the encoder output. ``use_remat`` checkpoints each layer
    as ``cfg.remat`` says (`_remat_wrap`) when autograd records (a cache-free
    call with grad enabled); serving under ``torch.no_grad()`` is unchanged.
    A placed stack is gathered layer by layer (`_gathered_layer`).
    """
    plan = as_plan(cfg, plan)
    new_caches = [] if caches is not None else None
    layer_fn = (_gathered_layer if params and is_placed(params[0])
                else apply_layer)
    if use_remat and caches is None and torch.is_grad_enabled():
        layer_fn = _remat_wrap(layer_fn, cfg)
    for i, p in enumerate(params):
        mixer, ffn_kind = cfg.layer_spec(i)
        with trace.span("model.layer", layer=i):
            x, nc = layer_fn(
                p, x, cfg=cfg, plan=plan, mixer=mixer, ffn_kind=ffn_kind,
                positions=positions,
                cache=caches[i] if caches is not None else None,
                pad_lens=pad_lens, pad_prompt_len=pad_prompt_len,
                slot_lens=slot_lens, block_table=block_table,
                page_size=page_size, chunk_offs=chunk_offs,
                enc_kv=enc_kv[i] if enc_kv is not None else None)
        if new_caches is not None:
            new_caches.append(nc)
    return x, new_caches


# --------------------------------------------------------------------------
# the model axis (training): tensor- and sequence-parallel layers
# --------------------------------------------------------------------------

def apply_layer_tp(p: Params, xs: list, *, cfg: ModelConfig,
                   plan: ExecPlan | ExecConfig, mixer: str, ffn_kind: str,
                   positions: list, group, sp: bool,
                   cross: Optional[list] = None) -> list:
    """One cache-free layer over a data replica's model positions.

    ``xs``: the residual stream, each position's sequence shard when
    ``sp`` (Megatron-SP: the reference's ``constraint(x, "batch",
    "sp_seq", None)`` after every layer), else each its whole copy. Norms
    run on the shards; the normed stream is gathered whole before the
    mixer and the FFN, and their per-position outputs come back to the
    stream's layout (`TPGroup.finish`: a reduce-scatter of the
    row-parallel partials). ``cross``: each position's whole encoder
    output, for a decoder layer's cross attention."""
    _check_layer(cfg, mixer, ffn_kind)
    if cfg.port_own:
        raise NotImplementedError(
            f"the model axis covers the reference's layers; "
            f"{', '.join(cfg.port_own)} run on one device")
    plan = _mixer_plan(as_plan(cfg, plan), mixer)
    whole = (lambda parts: all_gather(parts, 1)) if sp else (lambda t: t)

    def norm(name, parts):
        return [layers.apply_norm({k: group.read(v, m)
                                   for k, v in p[name].items()}, x, cfg)
                for m, x in enumerate(parts)]

    def add(parts, out):
        return [x + o for x, o in zip(parts, group.finish(*out, sp))]

    h = whole(norm("norm1", xs))
    if mixer == "mamba":
        out = ssm.mamba_tp(p["mamba"], h, cfg=cfg, plan=plan, group=group)
    else:
        out = layers.attention_tp(p["attn"], h, cfg=cfg, plan=plan,
                                  positions=positions, group=group,
                                  local=(mixer == "attn_local"))
    xs = add(xs, out)
    if "cross" in p and cross is not None:
        xs = add(xs, layers.attention_tp(
            p["cross"], whole(norm("norm_x", xs)), cfg=cfg, plan=plan,
            positions=positions, group=group, cross=cross))
    if ffn_kind == "moe":
        xs = add(xs, moe_mod.moe_tp(p["moe"], norm("norm2", xs), cfg, plan,
                                    group, sp))
    elif ffn_kind == "dense":
        xs = add(xs, layers.ffn_tp(p["ffn"], whole(norm("norm2", xs)), cfg,
                                   plan, group))
    return xs


def apply_stack_tp(params: list, xs: list, *, cfg: ModelConfig,
                   plan: ExecPlan | ExecConfig, positions: list, group,
                   sp: bool, cross: Optional[list] = None,
                   use_remat: bool = False) -> list:
    """`apply_layer_tp` over every layer of ``params`` (placed or not: each
    position reads its parts). ``use_remat`` checkpoints each layer as
    ``cfg.remat`` says when autograd records; the stash is the layer's
    input, each position's sequence shard, and the backward recomputes
    each position's part on its own device."""
    plan = as_plan(cfg, plan)
    layer_fn = apply_layer_tp
    if use_remat and torch.is_grad_enabled():
        layer_fn = _remat_wrap(layer_fn, cfg)
    for i, p in enumerate(params):
        mixer, ffn_kind = cfg.layer_spec(i)
        xs = layer_fn(p, xs, cfg=cfg, plan=plan, mixer=mixer,
                      ffn_kind=ffn_kind, positions=positions, group=group,
                      sp=sp, cross=cross)
    return xs
