"""Mixture-of-Experts FFN: token-choice top-k routing with a static capacity.

The port of `repro.models.moe`. The per-shard body, step by step as the
reference's:

* the router: float32 ``x @ router`` through the plan's softmax slot (the
  Compute-ACAM Fig.-8 dataflow in raceit mode, whose probabilities sit on a
  coarse grid, so ties at the k-th probability are common);
* top-k with `jax.lax.top_k`'s tie order, the lower expert index first: a
  stable descending sort and its first k (`torch.topk` breaks ties
  otherwise);
* gates renormalized by a division by max(sum, 1e-9);
* capacity C = ceil(k * T * capacity_factor / E) over every row of the call
  (pad rows and idle slots included); a (token, choice) ranked past C
  within its expert is dropped, its residual passing through;
* dispatch into an (E*C + 1, D) buffer whose last row is the drop bin (the
  only row written more than once), three batched expert products with
  float32 accumulation, the plan's activation and the GLU multiply, and the
  gather-weight-sum combine.

The expert weights stay float in every mode (`quantize_model_params` skips
the ``moe`` subtree, as the reference does); the products are plain matrix
products, which the reference computes outside any Pallas kernel too.

Under a mesh (``ExecConfig.mesh`` naming more than one device), one
process runs the
reference's `shard_map` body on every shard, its collectives written out:

* **TP-in-expert** (the default): ``w1``/``w3`` sharded on d_ff and ``w2``
  on its rows over the ``model`` axis; every shard routes all of its
  tokens, computes partial expert outputs and combines them, and the
  partials are summed in shard order (the reference's ``psum``);
* **EP** (``expert_parallel``, E % model == 0): the experts sharded over
  ``model``, and the sequence too when it divides, so each shard routes
  its own tokens at its own capacity C = ceil(k * T_local * cf / E); the
  two ``all_to_all``s become reshuffles of the (E, C, D) blocks: expert
  owner j takes every shard's block of its experts (concatenated on C),
  and each shard takes its C rows back from every owner;
* the ``data`` (and ``pod``) axes split the batch when it divides, each
  part routed on its own, as the reference's ``batch_spec``.

Inside a shard the raceit activation and router softmax see the shard's
tensors only, as the reference's body does.

Training (`Model` with ``mesh_ctx``) runs the same two bodies over a data
replica's model positions (`moe_tp`, from `blocks.apply_layer_tp`), the
reference's `shard_map` under `use_policy`; their exchanges are
`repro_torch.dist.tp`'s collectives, so gradients flow through them.

Expert weights placed on the mesh (`repro_torch.dist.place_params`: w1/w3
striped on d_ff, w2 on its rows, over ``model`` and under FSDP ``data``
too) are gathered whole for the one-device body. The TP-in-expert body
reads the d_ff block each shard owns from the stripes that hold it (the
very stripe without FSDP), and the EP body each owner's experts from
every d_ff stripe, never the whole weight.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import trace
from ..configs.base import ExecConfig, ModelConfig
from ..dist.sharding import gather_tree
from ..dist.tp import TPGroup, add_all, all_gather, all_to_all
from ..exec.plan import ExecPlan, as_plan
from . import layers

Params = dict


def init_moe(gen, cfg: ModelConfig, device, dtype) -> Params:
    """Router (D, E) float32, experts w1/w3 (E, D, F) and w2 (E, F, D) in
    ``dtype``, with the reference's scales (its fan-in default is the
    leading dimension: E for w1 and w3)."""
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": layers._dense_init(gen, (D, E), device, torch.float32),
        "w1": layers._dense_init(gen, (E, D, F), device, dtype),
        "w2": layers._dense_init(gen, (E, F, D), device, dtype, fan_in=F),
    }
    if cfg.glu:
        p["w3"] = layers._dense_init(gen, (E, D, F), device, dtype)
    return p


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, ties to the
    lower index first, as `jax.lax.top_k` gives them."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for a call of ``T`` rows (the reference's float
    expression)."""
    K, E = cfg.top_k, cfg.n_experts
    return max(1, int(-(-K * T * cfg.capacity_factor // E)))


class Routing(NamedTuple):
    gate: torch.Tensor    # (T, K) renormalized gates, float32
    expert: torch.Tensor  # (T, K) expert ids, int64
    keep: torch.Tensor    # (T*K,) bool: the choice got a slot
    slot: torch.Tensor    # (T*K,) int64 row of the dispatch buffer (E*C: drop)
    C: int


def route(logits: torch.Tensor, cfg: ModelConfig, plan: ExecPlan) -> Routing:
    """Router logits (T, E) float32 -> gates, experts and capacity slots."""
    T = logits.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    probs = plan.softmax(logits, axis=-1)
    gate, expert = top_k(probs, K)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    C = capacity(cfg, T)
    dev = logits.device
    e_flat = expert.reshape(-1)  # (T*K,) token-major
    # rank of each (token, choice) within its expert, via a stable sort
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev),
                                right=False)
    rank_sorted = torch.arange(T * K, device=dev) - starts[sorted_e]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted  # a permutation: every entry written once
    keep = rank < C
    slot = torch.where(keep, e_flat * C + rank, E * C)  # E*C = drop bin
    return Routing(gate, expert, keep, slot, C)


def _bmm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, C, X) x (E, X, Y) in a's dtype (float32 accumulation); ``w`` is
    used as it is when its dtype is a's already (no copy)."""
    return torch.bmm(a, w.to(a.dtype))


def _dispatch(p: Params, xf: torch.Tensor, cfg: ModelConfig,
              plan: ExecPlan):
    """Route the (T, D) tokens and gather them into the (E, C, D) expert
    blocks (the drop bin left out)."""
    T, D = xf.shape
    E, K = cfg.n_experts, cfg.top_k
    with trace.span("moe.route"):
        logits = xf.float() @ p["router"]
        r = route(logits, cfg, plan)
        if trace.on:
            _count_load(r, E)
        token_id = torch.arange(T, device=xf.device).repeat_interleave(K)
        disp = torch.zeros((E * r.C + 1, D), device=xf.device,
                           dtype=xf.dtype)
        disp[r.slot] = xf[token_id]  # kept slots distinct; the rest: drop bin
        return r, disp[:-1].reshape(E, r.C, D)


def _count_load(r: Routing, E: int) -> None:
    """The tracer's expert load of one routing, under the open layer:
    ``moe.kept``, the kept (token, choice) pairs per expert (a device int64
    count, `bincount` of ``expert[keep]`` without its host sync), and
    ``moe.rows``, the E x C dispatch rows the expert products compute."""
    layer = trace.current("layer")
    kept = torch.zeros(E, dtype=torch.int64, device=r.expert.device)
    kept.index_add_(0, r.expert.reshape(-1), r.keep.to(torch.int64))
    trace.add("moe.kept", kept, key=layer)
    trace.add("moe.rows", E * r.C, key=layer)


def _experts(disp: torch.Tensor, w1, w2, w3, cfg: ModelConfig,
             plan: ExecPlan) -> torch.Tensor:
    """The three batched expert products, the activation and the GLU."""
    with trace.span("moe.experts"):
        h = _bmm(disp, w1)
        h = plan.activation(h, cfg.activation)
        if w3 is not None:
            h = h * _bmm(disp, w3)
        return _bmm(h, w2)


def _combine(y_e: torch.Tensor, r: Routing, T: int) -> torch.Tensor:
    """Gather each (token, choice) slot's output, weight it, and sum the
    choices: (E, C, D) -> (T, D)."""
    E, C, D = y_e.shape
    with trace.span("moe.combine"):
        y_pad = torch.cat([y_e.reshape(E * C, D),
                           torch.zeros((1, D), device=y_e.device,
                                       dtype=y_e.dtype)])
        w = (r.gate.reshape(-1) * r.keep)[:, None].to(y_e.dtype)
        return (y_pad[r.slot] * w).reshape(T, -1, D).sum(dim=1)


def _moe_local(p: Params, x: torch.Tensor, cfg: ModelConfig,
               plan: ExecPlan) -> torch.Tensor:
    """The MoE body on one device. x: (B, S, D)."""
    B, S, D = x.shape
    r, disp = _dispatch(p, x.reshape(B * S, D), cfg, plan)
    y_e = _experts(disp, p["w1"], p["w2"], p.get("w3"), cfg, plan)
    return _combine(y_e, r, B * S).reshape(B, S, D)


def _tp_body(p: Params, xs: list, cfg: ModelConfig, plan: ExecPlan,
             group) -> list:
    """TP-in-expert over a data replica's model positions: position m
    holds d_ff block m of ``w1``/``w3`` and those rows of ``w2``, routes
    every token of its ``xs[m]`` and returns its partial output (the
    reference's ``psum`` is the caller's sum)."""
    F_ = p["w1"].shape[-1]
    if F_ % group.size:
        raise ValueError(f"TP-in-expert needs d_ff ({F_}) divisible by the "
                         f"model axis ({group.size})")
    read = group.read
    return [_moe_local({"router": read(p["router"], m),
                        "w1": read(p["w1"], m, 2, "w1"),
                        "w2": read(p["w2"], m, 1, "w2"),
                        "w3": read(p.get("w3"), m, 2, "w3")}, x, cfg, plan)
            for m, x in enumerate(xs)]


def _ep_body(p: Params, xs: list, cfg: ModelConfig, plan: ExecPlan,
             group) -> list:
    """EP over a data replica's model positions: owner j runs experts
    ``[j*E/M, (j+1)*E/M)``. Position m routes its ``xs[m]`` at its own
    capacity; the (E, C, D) blocks go to their experts' owners, each
    owner's block of every position concatenated on C (`all_to_all`), and
    the outputs come back. Returns each position's output of its tokens."""
    M = group.size
    if cfg.n_experts % M:
        raise ValueError(f"expert parallelism needs n_experts "
                         f"({cfg.n_experts}) divisible by the model axis "
                         f"({M})")
    read = group.read
    D = xs[0].shape[-1]
    routed = [_dispatch({"router": read(p["router"], m)}, x.reshape(-1, D),
                        cfg, plan) for m, x in enumerate(xs)]
    blocks = all_to_all([disp for _, disp in routed], 0, 1)
    ys = [_experts(blk, read(p["w1"], j, 0, "w1"), read(p["w2"], j, 0, "w2"),
                   read(p.get("w3"), j, 0, "w3"), cfg, plan)
          for j, blk in enumerate(blocks)]
    back = all_to_all(ys, 1, 0)
    return [_combine(y_e, r, x.shape[0] * x.shape[1]).reshape(x.shape)
            for y_e, (r, _), x in zip(back, routed, xs)]


def moe(p: Params, x: torch.Tensor, cfg: ModelConfig,
        plan: "ExecPlan | ExecConfig") -> torch.Tensor:
    """The MoE FFN of one layer: (B, S, D) -> (B, S, D); over the ``model``
    shards of the plan's ``ExecConfig.mesh`` when it names more than one
    device (the mesh built for ``x``'s device kind, as the attention
    backends build it)."""
    plan = as_plan(cfg, plan)
    spec = plan.exec_cfg.mesh
    if spec is None or spec.n_devices <= 1:
        return _moe_local(gather_tree(p, x.device), x, cfg, plan)
    ctx = spec.context(kind=x.device.type)
    group = TPGroup(ctx.mesh)
    M = group.size
    if M == 1:
        whole = gather_tree(p, x.device)
        body = lambda xb: _moe_local(whole, xb, cfg, plan)
    elif cfg.expert_parallel:
        def body(xb):
            # the sequence sharded when it divides, else every shard routes
            # every token and the owners compute the copies (the
            # reference's decode)
            if xb.shape[1] % M:
                return _ep_body(p, group.local(xb), cfg, plan,
                                group)[0].to(x.device)
            outs = _ep_body(p, [c.to(d) for c, d in zip(xb.chunk(M, 1),
                                                         group.devices)],
                            cfg, plan, group)
            return torch.cat([o.to(x.device) for o in outs], dim=1)
    else:
        body = lambda xb: add_all(_tp_body(p, group.local(xb), cfg, plan,
                                           group), x.device)
    dp = ctx.dp_size
    if dp > 1 and x.shape[0] % dp == 0:
        # the data axes split the batch; each part is one replica set's
        # (run here on the first replica set's devices)
        return torch.cat([body(xb) for xb in x.chunk(dp, 0)], dim=0)
    return body(x)


def moe_tp(p: Params, hs: list, cfg: ModelConfig, plan: ExecPlan, group,
           sp: bool):
    """The MoE FFN over a data replica's model positions, in training,
    through the bodies `moe` runs (gradients flow through their
    collectives). ``hs``: each position's normed input in the residual
    stream's layout (sequence shards when ``sp``). Returns (outputs,
    kind): EP (``expert_parallel``) routes each position's own tokens
    (its sequence shard when ``sp``, the reference's ``seq_spec``; else
    every token) into ``"shard"`` (``"full"``) outputs; TP-in-expert
    routes every token on every position into ``"partial"`` products."""
    if cfg.expert_parallel:
        return _ep_body(p, hs, cfg, plan, group), ("shard" if sp else "full")
    return _tp_body(p, all_gather(hs, 1) if sp else hs, cfg, plan,
                    group), "partial"
