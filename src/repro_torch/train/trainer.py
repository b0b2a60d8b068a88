"""Training step: gradients, clipping, AdamW, optional microbatches.

The port of `repro.train.trainer`. `make_train_step` returns a function of
(params, opt_state, batch) that returns new trees and leaves its inputs
alone; gradients come from `torch.autograd.grad` over the tree's stored
tensors (a tensor the loss does not reach gets zeros, as from `jax.grad`).

With a mesh (``mesh=``, the parameters placed on it by
`repro_torch.dist.place_params`), one process drives every data replica,
as the reference's one SPMD program does (XLA inserts its gradient
reduction and FSDP gathers from the placement; here they are explicit):

* the batch's rows split over the ``pod``/``data`` replicas, each run on
  its compute device (its ``model`` position 0; `replica_devices`), the
  model gathering each layer there (`models.blocks.apply_stack`);
* the loss is the whole batch's mean over every kept token, the replicas'
  sums over the global count (not a mean of means);
* one `torch.autograd.grad` over the stripes, then each shard's copies
  summed (`Placed.sum_copies`: the data replicas' all-reduce, nothing to
  do where a shard has one holder, as on one card).

The ``model`` axis stripes memory only: a replica computes its products
whole on its device (tensor-parallel compute of the training products is
not ported).
"""
from __future__ import annotations

import torch

from .. import tree
from ..dist.sharding import (MeshSpec, partwise, replica_devices, roots,
                             sum_copies, with_roots)
from ..models import Model
from . import optim

__all__ = ["make_grad_fn", "make_train_step", "make_eval_step",
           "value_and_grad"]


def _on_device(model: Model, batch: dict) -> dict:
    return {k: torch.as_tensor(v, device=model.device)
            for k, v in batch.items()}


def _mesh_loss(model: Model, params, batch: dict, mesh, use_remat: bool):
    """The whole batch's mean token loss, its rows split over the mesh's
    data replicas, each run by a model on its compute device."""
    devices = replica_devices(mesh)
    rows = next(iter(batch.values())).shape[0]
    if rows % len(devices):
        raise ValueError(f"a batch of {rows} rows does not split over "
                         f"{len(devices)} data replicas")
    nll = count = None
    for i, dev in enumerate(devices):
        net = Model(model.cfg, model.plan, device=dev)
        part = {k: torch.as_tensor(v).chunk(len(devices), 0)[i].to(dev)
                for k, v in batch.items()}
        s, c = net.loss_sums(params, part, use_remat=use_remat)
        nll = s if nll is None else nll + s.to(nll.device)
        count = c if count is None else count + c.to(count.device)
    return nll / torch.clamp_min(count, 1.0)


def value_and_grad(model: Model, params, batch: dict, use_remat: bool = True,
                   mesh=None):
    """(loss, grads): ``model.loss_fn`` and its gradient tree, shaped (and
    placed) like ``params``; with ``mesh``, the batch split over its data
    replicas (see the module's notes)."""
    flat = [t.detach().requires_grad_(True) for t in roots(params)]
    with torch.enable_grad():
        p = with_roots(params, flat)
        if mesh is None:
            loss = model.loss_fn(p, batch, use_remat=use_remat)
        else:
            loss = _mesh_loss(model, p, batch, mesh, use_remat)
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
    grad_of = lambda params, batch: value_and_grad(model, params, batch,
                                                   mesh=mesh)

    def grad_fn(params, batch):
        if mesh is None:
            batch = _on_device(model, batch)
        else:
            batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        if microbatches <= 1:
            return grad_of(params, batch)
        parts = {k: v.reshape((microbatches, -1) + v.shape[1:])
                 for k, v in batch.items()}
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

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
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
