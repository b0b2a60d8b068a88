"""Tensor- and sequence-parallel compute over the ``model`` axis.

The port of the reference's `use_policy` / `constraint` partitioning
(`repro.dist.sharding`). There, ``constraint(x, "batch", "heads", ...)``
annotates an activation and XLA partitions the products of one SPMD
program over the ``model`` axis. Here one process drives every position,
so the partitioning is written out: a data replica's M ``model`` positions
(`TPGroup`) each compute their own heads, FFN columns, vocab rows,
sequence shard and SSM heads or chunks, read their weight stripes in place
(`TPGroup.read`), and exchange activations through the collectives below.

An activation that the positions hold is a list with one tensor a
position, each on that position's device. Each collective is a
`torch.autograd.Function` over such lists whose backward is its dual, so
gradients flow right where positions are distinct cards and a ``.to`` is
the only link between them:

* `all_gather` (the sequence or columns whole on every position; backward:
  reduce-scatter) and `reduce_scatter` (partial products summed, each
  position keeping its slice; backward: all-gather) — Megatron-SP's AG/RS
  around the mixer and the FFN;
* `all_reduce` (partial products summed, the sum on every position;
  backward: all-reduce, the sum of every copy's gradient) — Megatron's g
  and f in one, where the sequence does not split;
* `all_to_all` (the MoE's expert-parallel exchange; backward: the reverse
  exchange) and `send` (the SSD state carried from one position to the
  next; backward: the gradient sent back).

Sums run in position order. Whether a dimension splits is
`ShardingPolicy.spec_for`'s answer under the default axis map (the
reference's drop rules: an assignment that does not divide is dropped, a
mesh axis used at most once); the logical names are the reference's
(``sp_seq``, ``heads``, ``mlp``, ``vocab``, ``chunks``).

`record` collects each position's weight products (name and shape) while
it is open, for tests and the card's smoke.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from .sharding import (_DP_AXES, Placed, ShardingPolicy, _entry_axes,
                       _leaf_axes, _norm_device, gather)

__all__ = ["TPGroup", "add_all", "all_gather", "all_max", "all_reduce", "all_to_all",
           "record", "reduce_scatter", "replica_groups", "send"]


# --------------------------------------------------------------------------
# the recorder
# --------------------------------------------------------------------------

_RECORDS: list = []


@contextlib.contextmanager
def record():
    """Within it, every product of the model-axis compute appends
    ``(position, name, weight shape)`` to the list it yields."""
    log: list = []
    _RECORDS.append(log)
    try:
        yield log
    finally:
        _RECORDS.remove(log)


def note(m: int, name: str, w) -> None:
    for log in _RECORDS:
        log.append((m, name, tuple(w.shape)))


# --------------------------------------------------------------------------
# collectives over per-position lists
# --------------------------------------------------------------------------

def add_all(tensors, device):
    """The tensors summed in position order on ``device`` (no collective
    of its own: the reduce of serving's row-parallel partials, and the
    sum in the collectives' backwards, whose gradients are never None:
    autograd materializes the unused ones as zeros)."""
    acc = None
    for t in tensors:
        t = t.to(device)
        acc = t if acc is None else acc + t
    return acc


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, *parts):
        ctx.dim = dim
        ctx.sizes = [p.shape[dim] for p in parts]
        ctx.devices = [p.device for p in parts]
        return tuple(torch.cat([p.to(dev) for p in parts], dim)
                     for dev in ctx.devices)

    @staticmethod
    def backward(ctx, *grads):
        out, start = [], 0
        for size, dev in zip(ctx.sizes, ctx.devices):
            out.append(add_all([g.narrow(ctx.dim, start, size)
                                 for g in grads], dev))
            start += size
        return (None, *out)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, *parts):
        ctx.dim = dim
        ctx.devices = [p.device for p in parts]
        size = parts[0].shape[dim] // len(parts)
        return tuple(add_all([p.narrow(dim, m * size, size) for p in parts],
                              dev) for m, dev in enumerate(ctx.devices))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(torch.cat([g.to(dev) for g in grads], ctx.dim)
                        for dev in ctx.devices))


def _spread(total, devices):
    """``total`` as one distinct tensor on each device."""
    return tuple(total if i == 0 else
                 (total.clone() if dev == total.device else total.to(dev))
                 for i, dev in enumerate(devices))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *parts):
        ctx.devices = [p.device for p in parts]
        return _spread(add_all(parts, ctx.devices[0]), ctx.devices)

    @staticmethod
    def backward(ctx, *grads):
        total = add_all(grads, ctx.devices[0])
        return _spread(total, ctx.devices)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split_dim, cat_dim, *parts):
        ctx.dims = (split_dim, cat_dim)
        return _exchange(parts, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, *grads):
        split_dim, cat_dim = ctx.dims
        return (None, None, *_exchange(grads, cat_dim, split_dim))


def _exchange(parts, split_dim, cat_dim):
    """Position j takes block j (of len(parts), along ``split_dim``) of
    every position's tensor, concatenated along ``cat_dim`` in position
    order."""
    n = len(parts)
    devices = [p.device for p in parts]
    blocks = [p.chunk(n, split_dim) for p in parts]
    return tuple(torch.cat([b[j].to(dev) for b in blocks], cat_dim)
                 for j, dev in enumerate(devices))


class _Send(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, device):
        ctx.device = x.device
        return x.to(device) if x.device != device else x.clone()

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.device), None


def all_gather(parts: list, dim: int) -> list:
    """Every position's tensor concatenated along ``dim``, whole on every
    position."""
    return list(_AllGather.apply(dim, *parts))


def reduce_scatter(parts: list, dim: int) -> list:
    """Partial sums: position m keeps the sum (in position order) of slice
    m of every position's tensor along ``dim``."""
    return list(_ReduceScatter.apply(dim, *parts))


def all_reduce(parts: list) -> list:
    """Partial sums: their sum (in position order) on every position."""
    return list(_AllReduce.apply(*parts))


def all_to_all(parts: list, split_dim: int, cat_dim: int) -> list:
    """Position j takes block j of every position's tensor (split in
    len(parts) along ``split_dim``), concatenated along ``cat_dim``."""
    return list(_AllToAll.apply(split_dim, cat_dim, *parts))


def send(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device`` (its gradient sent back)."""
    return _Send.apply(x, torch.device(device))


def all_max(parts: list) -> list:
    """The elementwise max over the positions on every position (no
    gradient: a logsumexp's shift)."""
    with torch.no_grad():
        dev = parts[0].device
        top = parts[0]
        for p in parts[1:]:
            top = torch.maximum(top, p.to(dev))
        return [top.to(p.device) for p in parts]


# --------------------------------------------------------------------------
# a data replica's model positions
# --------------------------------------------------------------------------

class TPGroup:
    """The ``model`` positions of one data replica: their mesh coordinates
    and devices, the compute policy (the default axis map), and the reads
    of each position's part of a weight."""

    def __init__(self, mesh, replica: int = 0):
        self.mesh = mesh
        self.policy = ShardingPolicy(mesh)
        names = mesh.axis_names
        dp = [names.index(a) for a in _DP_AXES if a in names]
        index = np.unravel_index(replica, [mesh.devices.shape[i] for i in dp]) \
            if dp else ()
        base = [0] * len(names)
        for i, v in zip(dp, index):
            base[i] = int(v)
        model = names.index("model") if "model" in names else None
        count = mesh.devices.shape[model] if model is not None else 1
        self.positions = []
        for m in range(count):
            pos = list(base)
            if model is not None:
                pos[model] = m
            self.positions.append(tuple(pos))
        self.devices = [_norm_device(mesh.devices[p]) for p in self.positions]
        self.size = count

    @property
    def device(self) -> torch.device:
        """Position 0's device: where the replica's loss lands."""
        return self.devices[0]

    # ------------------------------------------------------- decisions
    def split(self, shape: tuple, names: tuple, dim: int) -> bool:
        """Whether the policy splits dimension ``dim`` of an activation of
        ``shape`` (one logical name a dimension) over ``model``."""
        if self.size <= 1:
            return False
        entry = self.policy.spec_for(tuple(shape), tuple(names))[dim]
        return "model" in _entry_axes(entry)

    def leaf_dim(self, name: str, shape: tuple) -> Optional[int]:
        """The dimension of weight leaf ``name`` that the placement rules
        split over ``model`` (None: the leaf is whole on each position)."""
        if self.size <= 1:
            return None
        spec = self.policy.spec_for(tuple(shape), _leaf_axes(name,
                                                             tuple(shape)))
        for d, entry in enumerate(spec):
            if "model" in _entry_axes(entry):
                return d
        return None

    def bounds(self, n: int, m: int) -> tuple:
        """Position m's ``[lo, hi)`` of a dimension of ``n`` split in
        ``size`` equal parts."""
        size = n // self.size
        return m * size, (m + 1) * size

    def rows(self, n: int, m: int) -> slice:
        """Position m's rows of ``n`` (`torch.tensor_split`'s cut: the
        `bounds` when ``size`` divides ``n``)."""
        q, r = divmod(n, self.size)
        lo = m * q + min(m, r)
        return slice(lo, lo + q + (m < r))

    # ----------------------------------------------------------- reads
    def read(self, leaf, m: int, dim: Optional[int] = None,
             name: Optional[str] = None):
        """Position m's part of a weight: with ``dim``, its 1/size slice
        along it, read from the stripes that hold it (the very stripe, a
        view, where the placement splits that dimension over ``model``
        only); without, the leaf whole on its device (a leaf that the
        compute does not split). ``name`` records the read as a product's
        weight."""
        if leaf is None:
            return None
        dev = self.devices[m]
        if dim is None:
            w = gather(leaf, dev)
        else:
            dim = dim % len(leaf.shape)
            lo, hi = self.bounds(leaf.shape[dim], m)
            w = (leaf.gather_slice(dev, dim, lo, hi) if isinstance(leaf, Placed)
                 else leaf.narrow(dim, lo, hi - lo).to(dev))
        if name is not None:
            note(m, name, w)
        return w

    def local(self, tensor: torch.Tensor) -> list:
        """A replicated input (tokens, positions) on every position."""
        return [tensor.to(dev) for dev in self.devices]

    def take(self, parts: list, dim: int) -> list:
        """Each position's own rows (`rows`) of a tensor every position
        holds whole (no exchange: the dual of `all_gather`)."""
        out = []
        for m, p in enumerate(parts):
            r = self.rows(p.shape[dim], m)
            out.append(p.narrow(dim, r.start, r.stop - r.start))
        return out

    def finish(self, parts: list, kind: str, sp: bool) -> list:
        """A mixer's or FFN's per-position output in the residual stream's
        layout (sequence shards when ``sp``, else whole): ``partial``
        products summed (reduce-scatter or all-reduce), ``full`` values
        each position holds whole sliced to its shard, ``shard`` values
        already in place."""
        if kind == "partial":
            return reduce_scatter(parts, 1) if sp else all_reduce(parts)
        if kind == "full":
            return self.take(parts, 1) if sp else parts
        if kind == "shard":
            return parts
        raise ValueError(f"no output kind {kind!r}")


def replica_groups(mesh) -> list:
    """One `TPGroup` for each data replica, in `replica_devices` order."""
    names = mesh.axis_names
    n = int(np.prod([mesh.devices.shape[names.index(a)] for a in _DP_AXES
                     if a in names], dtype=np.int64))
    return [TPGroup(mesh, r) for r in range(n)]
