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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from .. import tree

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


def adamw_init(params) -> dict:
    """``{"mu", "nu"}`` float32 zeros shaped like ``params`` and an int32
    ``step`` of 0, on the parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    device = tree.leaves(params)[0].device
    return {"mu": tree.map(zeros, params), "nu": tree.map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    sums = [torch.sum(torch.square(g.float())) for g in tree.leaves(grads)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / max(norm, 1e-9)), norm)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree.map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


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

    def upd(g, m, v, p):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            u = u + cfg.weight_decay * p.float()
        return (-lr * u).to(p.dtype), m, v

    flat = zip(tree.leaves(grads), tree.leaves(state["mu"]),
               tree.leaves(state["nu"]), tree.leaves(params))
    out = [upd(g, m, v, p) for g, m, v, p in flat]
    pick = lambda i: tree.unflatten(grads, [o[i] for o in out])
    lr = torch.as_tensor(lr, dtype=torch.float32, device=step.device)
    return pick(0), {"mu": pick(1), "nu": pick(2), "step": step}, {
        "grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def apply_updates(params, updates):
    return tree.map(lambda p, u: p + u.to(p.dtype), params, updates)
