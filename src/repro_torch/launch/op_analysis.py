"""Static cost of one traced step: the counterpart of `hlo_analysis`.

The reference reads its costs from compiled HLO text; the port has no
compiler between the model and the card, so it counts the ops the step
dispatches. `analyze_ops(fn, *args)` runs ``fn`` once under a
`TorchDispatchMode` (on ``meta`` tensors for the dry-run, which allocates
nothing, or on any device) and returns an `OpCost`:

* ``flops``: 2*M*N*K of every ``mm``, ``addmm``, ``bmm``, ``baddbmm`` and
  ``_int_mm`` (the port's models make no other product), plus the int8
  operations
  each hand-written kernel launch reports (`repro_torch.kernels.cost`).
  Eager autograd re-runs a checkpointed layer's forward in the backward,
  and the counter sees it, as XLA's HLO holds the recomputed products.
* ``memory_bytes``: operand plus result bytes of every op that is not a
  view. Eager ops all materialise, as HLO's top-level instructions do; a
  view is the counterpart of a ``bitcast`` and moves nothing. A kernel
  launch counts the bytes it reports, never its plain version's
  intermediates, nor the scratch it allocates.
* ``peak_live_bytes``: the peak of live storage over the step, the
  arguments' included: each storage the step makes is added when it first
  appears and taken off by a finalizer when it dies (a storage's Python
  object lives as long as the storage, autograd's saved tensors included).
* ``collective_bytes``: none are traced. The port is single-controller,
  so its programs hold no collective op; the dry-run reckons them from the
  sharding policy (`collectives`) with the reference's ring model
  (`hlo_analysis._collective_traffic`) and says so in ``notes``.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels import cost as kcost

__all__ = ["OpCost", "analyze_ops", "collectives", "ring_bytes",
           "row_parallel_count"]

_aten = torch.ops.aten
_MATMULS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
            _aten.baddbmm.default, _aten._int_mm.default}
# ops that allocate without touching memory, and aliases
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.detach.default,
               _aten.lift_fresh.default, _aten.alias.default}


@dataclasses.dataclass
class OpCost:
    """`hlo_analysis.HloCost`'s fields, and what only a trace can give:
    the int8 share of ``flops`` (``_int_mm`` and kernel launches), the
    peak of live storage, the argument bytes, the ops in order of first
    appearance with their counts, the kernel launches (counts, and each
    launch's `kernels.cost.Launch` in order), and the reckoned collective
    bytes per mesh axis."""
    flops: float = 0.0
    int8_ops: float = 0.0
    memory_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_type: dict = dataclasses.field(default_factory=dict)
    collective_count: int = 0
    notes: list = dataclasses.field(default_factory=list)
    peak_live_bytes: int = 0
    arg_bytes: int = 0
    ops: Counter = dataclasses.field(default_factory=Counter)
    launches: list = dataclasses.field(default_factory=list)
    collective_by_axis: dict = dataclasses.field(default_factory=dict)

    @property
    def kernel_launches(self) -> Counter:
        """Launches by kernel (the ``launches`` counter key)."""
        return Counter(x.kernel for x in self.launches)

    def add_collective(self, kind: str, axis: str, nbytes: float,
                       count: int = 1) -> None:
        self.collective_bytes += nbytes
        self.collective_by_type[kind] = (
            self.collective_by_type.get(kind, 0.0) + nbytes)
        self.collective_by_axis[axis] = (
            self.collective_by_axis.get(axis, 0.0) + nbytes)
        self.collective_count += count

    def to_dict(self) -> dict:
        return {"flops": self.flops, "int8_ops": self.int8_ops,
                "memory_bytes": self.memory_bytes,
                "collective_bytes": self.collective_bytes,
                "collective_by_type": self.collective_by_type,
                "collective_by_axis": self.collective_by_axis,
                "collective_count": self.collective_count,
                "notes": self.notes, "peak_live_bytes": self.peak_live_bytes,
                "arg_bytes": self.arg_bytes,
                "kernel_launches": dict(self.kernel_launches),
                "n_ops": sum(self.ops.values())}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _matmul_flops(func, args) -> float:
    if func in (_aten.addmm.default, _aten.baddbmm.default):
        args = args[1:]
    a, b = args[0], args[1]
    batch = a.shape[0] if a.ndim == 3 else 1
    return 2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


class _Counter(TorchDispatchMode):
    def __init__(self, cost: OpCost):
        super().__init__()
        self.cost = cost
        self.depth = 0           # > 0 inside a kernel call
        self.live = 0
        self.seen: dict = {}     # storage key -> nbytes

    # ---- storage lifetimes -------------------------------------------
    def track(self, t: torch.Tensor, finalize: bool = True) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.seen:
            return
        n = st.nbytes()
        self.seen[key] = n
        self.live += n
        self.cost.peak_live_bytes = max(self.cost.peak_live_bytes, self.live)
        if finalize:
            weakref.finalize(st, self.release, key)

    def release(self, key) -> None:
        self.live -= self.seen.pop(key, 0)

    # ---- kernel calls (`kernels.cost.counted`) -----------------------
    def kernel_call(self, launches):
        mode = self

        class _Call:
            def __enter__(self):
                mode.depth += 1

            def __exit__(self, *exc):
                mode.depth -= 1
                if exc[0] is None:
                    for x in launches:
                        mode.cost.flops += x.ops
                        mode.cost.int8_ops += x.ops
                        mode.cost.memory_bytes += x.nbytes
                        mode.cost.ops[f"kernel.{x.name}"] += 1
                        mode.cost.launches.append(x)
                return False
        return _Call()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flat_in = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
        flat_out = [t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)]
        for t in flat_in:
            self.track(t)
        for t in flat_out:
            self.track(t)
        if self.depth:
            return out
        self.cost.ops[str(func.overloadpacket.__name__)] += 1
        if func in _MATMULS:
            flops = _matmul_flops(func, args)
            self.cost.flops += flops
            if func is _aten._int_mm.default:
                self.cost.int8_ops += flops
        if func.is_view or func in _NO_TRAFFIC:
            return out
        self.cost.memory_bytes += (sum(_nbytes(t) for t in flat_in)
                                   + sum(_nbytes(t) for t in flat_out))
        return out


def analyze_ops(fn, *args, **kwargs) -> tuple[OpCost, object]:
    """(cost of one call of ``fn(*args, **kwargs)``, its result).

    The arguments' storages count as live from the start (their holder
    keeps them) and make ``arg_bytes``."""
    cost = OpCost()
    mode = _Counter(cost)
    for t in tree_flatten((args, kwargs))[0]:
        if isinstance(t, torch.Tensor):
            mode.track(t, finalize=False)
        elif hasattr(t, "codes"):  # a resident QuantizedWeight
            mode.track(t.codes, finalize=False)
            mode.track(t.scale, finalize=False)
    cost.arg_bytes = mode.live
    kcost.COUNTERS.append(mode)
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        kcost.COUNTERS.remove(mode)
    return cost, out


# --------------------------------------------------------------------------
# collectives, reckoned from the sharding policy
# --------------------------------------------------------------------------

def ring_bytes(kind: str, nbytes: float, group: int) -> float:
    """Bytes a device sends for one collective over ``group`` devices, the
    reference's ring model: an all-gather its result, a reduce-scatter its
    input, an all-reduce twice its input, each times (g - 1) / g."""
    if group <= 1:
        return 0.0
    scale = {"all-gather": 1.0, "reduce-scatter": 1.0,
             "all-reduce": 2.0}.get(kind, 1.0)
    return scale * nbytes * (group - 1) / group


def _uses(spec, axis: str) -> bool:
    return any(e == axis or (isinstance(e, tuple) and axis in e)
               for e in (spec or ()))


def collectives(cost: OpCost, pspecs, shard_param_bytes: int, mesh_shape:
                dict, *, act_rows: int, out_rows: int, d_model: int,
                vocab: int, act_itemsize: int, train: bool) -> None:
    """Add a Megatron step's collectives to ``cost``, per device.

    Every row-parallel projection whose spec uses ``model`` (``wo``,
    ``w2``, ``out_proj``: a layer's attention, FFN or mixer output) and the
    vocab-sharded embedding gather all-reduce the (act_rows, d_model)
    activation over ``model``; a vocab-sharded unembedding all-gathers the
    (out_rows, vocab) logits. A train step does each twice (forward and
    backward) and all-reduces its gradients, the parameters' shard bytes,
    over ``data`` and then, for the 1/data share each device keeps,
    over ``pod`` (hierarchical rings)."""
    model = int(mesh_shape.get("model", 1))
    act = act_rows * d_model * act_itemsize
    passes = 2 if train else 1
    row_parallel = row_parallel_count(pspecs)
    if row_parallel and model > 1:
        cost.add_collective("all-reduce", "model",
                            passes * row_parallel
                            * ring_bytes("all-reduce", act, model),
                            passes * row_parallel)
    unembed = _find(pspecs, "unembed")
    if unembed is None:
        unembed = _find(pspecs, "tok_emb")   # tied
        vocab_sharded = unembed is not None and _uses(unembed[:1], "model")
    else:
        vocab_sharded = _uses(unembed[-1:], "model")
    if vocab_sharded and model > 1:
        logits = out_rows * vocab * act_itemsize
        cost.add_collective("all-gather", "model",
                            passes * ring_bytes("all-gather", logits, model),
                            passes)
    if train:
        data = int(mesh_shape.get("data", 1))
        pod = int(mesh_shape.get("pod", 1))
        if data > 1:
            cost.add_collective("all-reduce", "data", ring_bytes(
                "all-reduce", shard_param_bytes, data))
        if pod > 1:
            cost.add_collective("all-reduce", "pod", ring_bytes(
                "all-reduce", shard_param_bytes / data, pod))
    cost.notes.append("collectives are a model reckoned from the sharding "
                      "policy (ring algorithms), not a trace: the port is "
                      "single-controller and its step holds no collective")


def row_parallel_count(pspecs, names=("wo", "w2", "out_proj",
                                      "tok_emb")) -> int:
    """Leaves named in ``names`` whose spec uses ``model``: by default the
    row-parallel projections and a vocab-sharded ``tok_emb``, one
    all-reduce each a pass. Resident int8 codes replicate, so they count
    none."""
    return sum(1 for path, spec in _spec_leaves(pspecs)
               if path and path[-1] in names and _uses(spec, "model"))


def _spec_leaves(specs, prefix=()):
    """(path, spec) of a spec tree; a spec is a tuple of entries."""
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from _spec_leaves(v, prefix + (k,))
    elif isinstance(specs, list):
        for i, v in enumerate(specs):
            yield from _spec_leaves(v, prefix + (i,))
    else:
        yield prefix, specs


def _find(specs, name):
    """The spec of leaf ``name`` (a resident weight's: its codes')."""
    for path, spec in _spec_leaves(specs):
        if name in path[-2:]:
            return spec
    return None
