"""Training step: gradients, clipping, AdamW, optional microbatches.

The port of `repro.train.trainer`. `make_train_step` returns a function of
(params, opt_state, batch) that returns new trees and leaves its inputs
alone; gradients come from `torch.autograd.grad` over the tree's stored
tensors (a tensor the loss does not reach gets zeros, as from `jax.grad`).

With a mesh (``mesh=``, the parameters placed on it by
`repro_torch.dist.place_params`), one process drives every position, as
the reference's one SPMD program under `use_policy` does (XLA inserts its
collectives from the placement and the activations' constraints; here
they are explicit, `repro_torch.dist.tp`):

* the batch's rows split over the ``pod``/``data`` replicas, each run by
  its ``model`` positions (`Model` with ``mesh_ctx``): every position
  computes its own heads, FFN columns, vocab rows (where the vocab
  divides), sequence shard and SSM heads or chunks, reads its stripes in
  place and exchanges activations (Megatron's tensor- and
  sequence-parallel layout; a replica with one position computes its
  products whole there);
* the loss is the whole batch's mean over every kept token, the
  positions' and replicas' sums over the global count (not a mean of
  means);
* one `torch.autograd.grad` over the stripes, then each shard's copies
  summed (`Placed.sum_copies`: the data replicas' all-reduce, nothing to
  do where a shard has one holder, as on one card).
"""
from __future__ import annotations

import itertools

import torch

from .. import trace, tree
from ..dist.sharding import (MeshContext, MeshSpec, partwise, roots,
                             sum_copies, with_roots)
from ..models import Model
from ..models.model import batch_axis
from . import optim

__all__ = ["make_grad_fn", "make_train_step", "make_eval_step",
           "value_and_grad"]


def _on_device(model: Model, batch: dict) -> dict:
    return {k: torch.as_tensor(v, device=model.device)
            for k, v in batch.items()}


def _mesh_model(model: Model, mesh) -> Model:
    """``model`` under the mesh's policy: the same config and plan, its
    ``mesh_ctx`` the mesh (the reference's ``Model(cfg,
    mesh_ctx=MeshContext(mesh))``)."""
    return Model(model.cfg, model.plan, mesh_ctx=MeshContext(mesh))


def value_and_grad(model: Model, params, batch: dict, use_remat: bool = True,
                   mesh=None):
    """(loss, grads): ``model.loss_fn`` and its gradient tree, shaped (and
    placed) like ``params``; with ``mesh``, the batch split over its data
    replicas (see the module's notes)."""
    flat = [t.detach().requires_grad_(True) for t in roots(params)]
    with torch.enable_grad():
        p = with_roots(params, flat)
        net = model if mesh is None else _mesh_model(model, mesh)
        with trace.span("train.forward"):
            loss = net.loss_fn(p, batch, use_remat=use_remat)
        with trace.span("train.backward"):
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(flat, grads)]
    return loss.detach(), sum_copies(with_roots(params, grads))


def make_grad_fn(model: Model, microbatches: int = 1, mesh=None):
    """``grad_fn(params, batch) -> (loss, grads)``: the train step's loss
    and gradient tree before the optimizer.

    With ``microbatches > 1`` the batch's leading dimension splits into that
    many consecutive parts; their losses and float32 gradients are summed
    in order, then divided by the count. ``mesh`` (a built `Mesh`, or a
    `MeshSpec` built for the model's device kind) splits each part over
    its data replicas; ``params`` then come placed on it.
    """
    if isinstance(mesh, MeshSpec):
        mesh = mesh.build(kind=model.device.type)
    net = model if mesh is None else _mesh_model(model, mesh)
    grad_of = lambda params, batch: value_and_grad(net, params, batch)

    def grad_fn(params, batch):
        if mesh is None:
            batch = _on_device(model, batch)
        else:
            batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        if microbatches <= 1:
            return grad_of(params, batch)
        parts = {k: v.unflatten(batch_axis(k, v), (microbatches, -1))
                 .movedim(batch_axis(k, v), 0) for k, v in batch.items()}
        loss = None
        grads = tree.map(partwise(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device)), params)
        for i in range(microbatches):
            l, g = grad_of(params, {k: v[i] for k, v in parts.items()})
            loss = l if loss is None else loss + l
            grads = tree.map(partwise(torch.add), grads, g)
        return (loss / microbatches,
                tree.map(partwise(lambda g: g / microbatches), grads))

    return grad_fn


def make_train_step(model: Model, opt_cfg: optim.AdamWConfig,
                    microbatches: int = 1, mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, metrics ``loss``, ``grad_norm`` and ``lr`` (tensors): the
    gradients of `make_grad_fn` (``microbatches``, ``mesh``), then AdamW.
    """
    grad_fn = make_grad_fn(model, microbatches, mesh)
    steps = itertools.count()

    def train_step(params, opt_state, batch):
        with trace.span("train.step", step=next(steps)):
            loss, grads = grad_fn(params, batch)
            with trace.span("train.optimizer"):
                updates, opt_state, om = optim.adamw_update(
                    grads, opt_state, params, opt_cfg)
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
