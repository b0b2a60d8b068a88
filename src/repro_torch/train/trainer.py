"""Training step: gradients, clipping, AdamW, optional microbatches.

The port of `repro.train.trainer`. `make_train_step` returns a function of
(params, opt_state, batch) that returns new trees and leaves its inputs
alone; gradients come from `torch.autograd.grad` over the tree's leaves
(a leaf the loss does not reach gets zeros, as from `jax.grad`).
"""
from __future__ import annotations

import torch

from .. import tree
from ..models import Model
from . import optim

__all__ = ["make_train_step", "make_eval_step", "value_and_grad"]


def _on_device(model: Model, batch: dict) -> dict:
    return {k: torch.as_tensor(v, device=model.device)
            for k, v in batch.items()}


def value_and_grad(model: Model, params, batch: dict, use_remat: bool = True):
    """(loss, grads): ``model.loss_fn`` and its gradient tree, shaped like
    ``params``."""
    flat = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    with torch.enable_grad():
        loss = model.loss_fn(tree.unflatten(params, flat), batch,
                             use_remat=use_remat)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), tree.unflatten(params, grads)


def make_train_step(model: Model, opt_cfg: optim.AdamWConfig,
                    microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, metrics ``loss``, ``grad_norm`` and ``lr`` (tensors).

    With ``microbatches > 1`` the batch's leading dimension splits into that
    many consecutive parts; their losses and float32 gradients are summed
    in order, then divided by the count.
    """
    def train_step(params, opt_state, batch):
        batch = _on_device(model, batch)
        if microbatches > 1:
            parts = {k: v.reshape((microbatches, -1) + v.shape[1:])
                     for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = tree.map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(microbatches):
                l, g = value_and_grad(model, params,
                                      {k: v[i] for k, v in parts.items()})
                loss = loss + l
                grads = tree.map(torch.add, grads, g)
            loss = loss / microbatches
            grads = tree.map(lambda g: g / microbatches, grads)
        else:
            loss, grads = value_and_grad(model, params, batch)
        updates, opt_state, om = optim.adamw_update(grads, opt_state, params,
                                                    opt_cfg)
        params = optim.apply_updates(params, updates)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_eval_step(model: Model):
    """``eval_step(params, batch) -> loss``, no remat, no graph."""
    @torch.no_grad()
    def eval_step(params, batch):
        return model.loss_fn(params, _on_device(model, batch),
                             use_remat=False)
    return eval_step
