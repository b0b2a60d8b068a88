"""Optimizers and LR schedules: AdamW over the port's parameter trees.

The port of `repro.train.optim`. Moments are float32 whatever the
parameter dtype. The update keeps the reference's op order, not
`torch.optim.AdamW`'s (which decays every tensor, scales ``p`` by ``1 - lr
* wd`` first and divides in another order):

* ``mhat = m / (1 - b1**t)`` and ``vhat = v / (1 - b2**t)``, true divisions;
* ``u = mhat / (sqrt(vhat) + eps)``;
* decoupled weight decay ``u + wd * p`` on leaves with two or more
  dimensions only;
* the update ``-lr * u``, ``lr`` a float32 product (JAX's weak typing: a
  Python float meeting a float32 tensor is cast to float32).

Over a tree placed on a mesh (`repro_torch.dist.place_params`) every
function works part by part: a stripe's moments live on the stripe's
device (ZeRO when ``fsdp`` stripes the weights over ``data``; a replicated
leaf's moments replicate with it, as the reference's state inherits its
parameters' sharding), and `global_norm` sums the squares of each leaf's
shards once onto the first leaf's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from .. import tree
from ..dist.sharding import Placed, partwise

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "apply_updates",
           "global_norm", "clip_by_global_norm", "warmup_cosine"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: Optional[Callable] = None  # step -> lr multiplier


def warmup_cosine(warmup: int, total: int, min_ratio: float = 0.1):
    """Linear warm-up over ``warmup`` steps, then a cosine from 1 down to
    ``min_ratio`` at ``total``; ``fn(step)`` takes an integer tensor.

    The reference runs inside a jitted step, where a division by a
    constant is a multiply by its float32 reciprocal; so here.
    """
    inv_warm = float(np.float32(1) / np.float32(max(warmup, 1)))
    inv_span = float(np.float32(1) / np.float32(max(total - warmup, 1)))

    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = step * inv_warm
        prog = torch.clamp((step - warmup) * inv_span, 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi
                                                                 * prog))
        return torch.where(step < warmup, warm, cos)
    return fn


def _first_device(params) -> torch.device:
    leaf = tree.leaves(params)[0]
    return leaf.devices[0] if isinstance(leaf, Placed) else leaf.device


def adamw_init(params) -> dict:
    """``{"mu", "nu"}`` float32 zeros shaped like ``params`` (placed as
    it is) and an int32 ``step`` of 0, on the first leaf's device."""
    zeros = partwise(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device))
    return {"mu": tree.map(zeros, params), "nu": tree.map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_first_device(params))}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares (a placed
    leaf's shards counted once each, summed on the first leaf's device)."""
    sums = [torch.sum(torch.square(g.float()))
            for leaf in tree.leaves(grads)
            for g in (leaf.unique_roots() if isinstance(leaf, Placed)
                      else [leaf])]
    device = sums[0].device
    return torch.sqrt(torch.sum(torch.stack([s.to(device) for s in sums])))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / max(norm, 1e-9)), norm)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree.map(partwise(lambda g: (g.float() * scale.to(g.device)
                                         ).to(g.dtype)), grads), norm


@torch.no_grad()
def adamw_update(grads, state: dict, params, cfg: AdamWConfig):
    """(updates, new state, {"grad_norm", "lr"}) of one AdamW step."""
    step = state["step"] + 1
    if cfg.grad_clip:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    lr = cfg.lr * (cfg.schedule(step) if cfg.schedule is not None else 1.0)
    b1, b2 = cfg.b1, cfg.b2
    t = step.float()
    c1 = 1 - b1 ** t
    c2 = 1 - b2 ** t

    on = lambda x, d: x.to(d) if isinstance(x, torch.Tensor) else x

    mu = tree.map(partwise(lambda g, m: b1 * m + (1 - b1) * g.float()),
                  grads, state["mu"])
    nu = tree.map(partwise(lambda g, v: b2 * v + (1 - b2) * g.float()
                           * g.float()), grads, state["nu"])

    def upd(m, v, p):
        d = m.device
        u = (m / on(c1, d)) / (torch.sqrt(v / on(c2, d)) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            u = u + cfg.weight_decay * p.float()
        return (-on(lr, d) * u).to(p.dtype)

    updates = tree.map(partwise(upd), mu, nu, params)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=step.device)
    return updates, {"mu": mu, "nu": nu, "step": step}, {
        "grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def apply_updates(params, updates):
    return tree.map(partwise(lambda p, u: p + u.to(p.dtype)), params,
                    updates)
