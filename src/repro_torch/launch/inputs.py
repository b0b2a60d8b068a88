"""Meta stand-ins for every (arch x shape) dry-run cell.

The port of `repro.launch.inputs`. Nothing is allocated: parameters,
optimizer state and caches come from the real init functions on the
``meta`` device (a CPU generator draws nothing there), and inputs are meta
tensors. Beside each tree goes its spec tree from the port's
`ShardingPolicy` (`param_specs` for parameters, `cache_specs` for caches):
one entry per dimension, None (replicated), a mesh axis name or a tuple of
them. `shard_shape` gives a leaf's per-device shape under its spec, and
`leaf_table` flattens a tree and its specs into {path: global shape,
dtype, spec, shard shape}.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import tree
from ..configs.base import ModelConfig, ShapeSpec
from ..dist.sharding import ShardingPolicy, param_specs
from ..models.layers import QuantizedWeight

__all__ = ["input_specs", "cache_specs", "batch_specs", "make_policy",
           "model_flops", "shard_shape", "leaf_table", "param_leaves",
           "tree_bytes"]

_META = torch.device("meta")


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, policy: ShardingPolicy):
    """The input batch of a cell and its specs: int32 ``tokens`` (B, S),
    and bfloat16 ``enc_feats`` (B, encoder_len, d_model) for a model with
    a (stub) modality frontend, as the reference's."""
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": torch.empty((B, S), dtype=torch.int32, device=_META)}
    specs = {"tokens": policy.spec_for((B, S), ("batch", None))}
    if cfg.frontend in ("audio_stub", "vision_stub") or cfg.is_encoder_decoder:
        fe = (B, cfg.encoder_len, cfg.d_model)
        out["enc_feats"] = torch.empty(fe, dtype=torch.bfloat16, device=_META)
        specs["enc_feats"] = policy.spec_for(fe, ("batch", None, None))
    return out, specs


def _cache_axes_for(path: tuple, shape: tuple) -> tuple:
    name = str(path[-1])
    if name in ("k", "v") or "enc_kv" in path:
        return (("batch", "seq", None, None) if len(shape) == 4
                else (None,) * len(shape))
    if name == "state":
        return ("batch", "heads", "headdim", None)
    if name.startswith("conv"):
        return ("batch", None, "heads")
    return (None,) * len(shape)


def cache_specs(cache, policy: ShardingPolicy):
    """The spec tree of a cache tree (one dict per layer, and an
    encoder-decoder's ``enc_kv`` pairs), by leaf name as the reference's."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (i,))
                              for i, v in enumerate(node))
        shape = tuple(node.shape)
        axes = _cache_axes_for(path, shape)
        if len(axes) != len(shape):
            axes = (None,) * len(shape)
        return policy.spec_for(shape, axes)
    return walk(cache, ())


def make_policy(mesh, cfg: ModelConfig, shape: ShapeSpec) -> ShardingPolicy:
    """Shape-aware policy: when the batch cannot use the dp axes (B=1 long
    decode), hand them to the sequence dimension of caches instead."""
    policy = ShardingPolicy(mesh)
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    dp_size = math.prod(int(mesh.shape[a]) for a in dp)
    if shape.global_batch % dp_size != 0:
        policy.axis_map = dict(policy.axis_map)
        policy.axis_map["seq"] = dp + ("model",)
    return policy


def param_leaves(params) -> list:
    """[(path string, tensor)] of a parameter tree, a resident
    `QuantizedWeight` as its ``codes`` and ``scale`` leaves."""
    out = []
    for path, leaf in tree.leaves_with_paths(params):
        p = "/".join(str(k) for k in path)
        if isinstance(leaf, QuantizedWeight):
            out += [(p + "/codes", leaf.codes), (p + "/scale", leaf.scale)]
        else:
            out.append((p, leaf))
    return out


def model_flops(cfg: ModelConfig, params, shape: ShapeSpec) -> float:
    """Analytic MODEL_FLOPS: 6*N_active*D train / 2*N_active*D inference."""
    sizes = {p: math.prod(leaf.shape) for p, leaf in param_leaves(params)}
    total = sum(sizes.values())
    moe = sum(v for p, v in sizes.items() if "moe" in p and p.split("/")[-1]
              in ("w1", "w2", "w3"))
    emb = sum(v for p, v in sizes.items() if p.split("/")[-1] in
              ("tok_emb", "pos_emb"))
    n_active = total - emb - (moe * (1 - cfg.top_k / max(cfg.n_experts, 1))
                              if cfg.n_experts else 0)
    if cfg.tie_embeddings:
        n_active += cfg.vocab_size * cfg.d_model  # unembed reuses tok_emb
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def shard_shape(shape: tuple, spec: tuple, mesh_shape: dict) -> tuple:
    """A leaf's per-device shape: each dimension over the product of the
    mesh axes its spec entry names."""
    out = []
    for dim, entry in zip(shape, spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        out.append(dim // math.prod(int(mesh_shape[a]) for a in axes))
    return tuple(out)


def _spec_pairs(values, specs, prefix=()):
    """(path, leaf, spec) of a tree and its spec tree (a `QuantizedWeight`
    pairs with its {"codes", "scale"} specs)."""
    if isinstance(values, QuantizedWeight):
        yield prefix + ("codes",), values.codes, specs["codes"]
        yield prefix + ("scale",), values.scale, specs["scale"]
    elif isinstance(values, dict):
        for k, v in values.items():
            yield from _spec_pairs(v, specs[k], prefix + (k,))
    elif isinstance(values, (list, tuple)):
        for i, v in enumerate(values):
            yield from _spec_pairs(v, specs[i], prefix + (i,))
    else:
        yield prefix, values, specs


def leaf_table(values, specs, mesh_shape: dict) -> dict:
    """{path: {"shape", "dtype", "spec", "shard_shape"}} of a tree."""
    return {"/".join(str(k) for k in path): dict(
        shape=tuple(leaf.shape), dtype=str(leaf.dtype).replace("torch.", ""),
        spec=tuple(spec), shard_shape=shard_shape(tuple(leaf.shape), spec,
                                                  mesh_shape))
        for path, leaf, spec in _spec_pairs(values, specs)}


def tree_bytes(values, specs=None, mesh_shape: Optional[dict] = None,
               granule: int = 1) -> int:
    """Bytes of a tree's leaves (per device, by shard shape, when ``specs``
    are given), each leaf rounded up to ``granule`` bytes (512: the CUDA
    caching allocator's block size)."""
    total = 0
    if specs is None:
        pairs = [(None, leaf, None) for _, leaf in param_leaves(values)]
    else:
        pairs = _spec_pairs(values, specs)
    for _, leaf, spec in pairs:
        shp = tuple(leaf.shape) if spec is None else shard_shape(
            tuple(leaf.shape), spec, mesh_shape)
        n = math.prod(shp) * leaf.element_size()
        total += -(-n // granule) * granule
    return total


def _adamw_state(params) -> dict:
    """`train.optim.adamw_init` over a tree that may hold resident weights:
    float32 moments shaped like each leaf (a `QuantizedWeight`'s like its
    codes and its scale, as JAX maps the reference's pytree)."""
    def zeros(leaf):
        if isinstance(leaf, QuantizedWeight):
            return QuantizedWeight(zeros(leaf.codes), zeros(leaf.scale),
                                   leaf.shape)
        return torch.zeros(leaf.shape, dtype=torch.float32, device=_META)
    return {"mu": tree.map(zeros, params), "nu": tree.map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=_META)}


def input_specs(cfg: ModelConfig, shape: ShapeSpec, policy: ShardingPolicy,
                model, quantize: bool = False) -> dict:
    """Everything the step function needs, as meta tensors, with specs:
    ``params``/``param_specs``, for a train cell ``opt_state``/``ospecs``
    (AdamW's float32 moments, sharded like the parameters, and a replicated
    step), ``batch``/``bspecs`` (train, prefill), ``token``/``tspec``
    (decode) and ``cache``/``cspecs`` (prefill of a model with a cache,
    decode). ``model`` is a `Model` on ``meta``; ``quantize`` turns the
    weights into resident int8 codes (`quantize_model_params`)."""
    from ..models.model import quantize_model_params

    params = model.init(torch.Generator())
    if quantize:
        params = quantize_model_params(params)
    pspecs = param_specs(params, cfg, policy)
    out = {"params": params, "param_specs": pspecs}
    B = shape.global_batch
    if shape.kind == "train":
        out["opt_state"] = _adamw_state(params)
        out["ospecs"] = {"mu": pspecs, "nu": pspecs, "step": ()}
        out["batch"], out["bspecs"] = batch_specs(cfg, shape, policy)
    elif shape.kind == "prefill":
        out["batch"], out["bspecs"] = batch_specs(cfg, shape, policy)
        if cfg.family != "encoder":
            out["cache"] = model.init_cache(B, shape.seq_len)
            out["cspecs"] = cache_specs(out["cache"], policy)
    else:  # decode
        out["token"] = torch.empty((B, 1), dtype=torch.int32, device=_META)
        out["tspec"] = policy.spec_for((B, 1), ("batch", None))
        out["cache"] = model.init_cache(B, shape.seq_len)
        out["cspecs"] = cache_specs(out["cache"], policy)
    return out
