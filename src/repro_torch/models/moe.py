"""Mixture-of-Experts FFN: token-choice top-k routing with a static capacity.

The port of `repro.models.moe` without a mesh (the reference's per-shard
body at tensor-parallel size 1; its expert-parallel all_to_all and the
d_ff-sharded psum wait for the port's tensor parallelism). Step by step as
the reference:

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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs.base import ExecConfig, ModelConfig
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


def _moe_local(p: Params, x: torch.Tensor, cfg: ModelConfig,
               plan: ExecPlan) -> torch.Tensor:
    """The MoE body on one device. x: (B, S, D)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xf = x.reshape(T, D)

    logits = xf.float() @ p["router"]
    r = route(logits, cfg, plan)
    C = r.C

    token_id = torch.arange(T, device=x.device).repeat_interleave(K)
    disp = torch.zeros((E * C + 1, D), device=x.device, dtype=x.dtype)
    disp[r.slot] = xf[token_id]  # kept slots are distinct; the rest: drop bin
    disp = disp[:-1].reshape(E, C, D)

    h = _bmm(disp, p["w1"])
    h = plan.activation(h, cfg.activation)
    if "w3" in p:
        h = h * _bmm(disp, p["w3"])
    y_e = _bmm(h, p["w2"])

    # combine: gather each (token, choice) slot's output, weight, and sum
    y_pad = torch.cat([y_e.reshape(E * C, D),
                       torch.zeros((1, D), device=x.device, dtype=y_e.dtype)])
    w = (r.gate.reshape(-1) * r.keep)[:, None].to(y_e.dtype)
    y = (y_pad[r.slot] * w).reshape(T, K, D).sum(dim=1)
    return y.reshape(B, S, D)


def moe(p: Params, x: torch.Tensor, cfg: ModelConfig,
        plan: "ExecPlan | ExecConfig") -> torch.Tensor:
    """The MoE FFN of one layer: (B, S, D) -> (B, S, D)."""
    return _moe_local(p, x, cfg, as_plan(cfg, plan))
