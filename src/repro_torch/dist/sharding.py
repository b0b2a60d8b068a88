"""Logical-axis sharding policy and the mesh of a tensor-parallel run.

The port of `repro.dist.sharding`. The reference runs its shards as one
SPMD program (`shard_map` over a `jax.sharding.Mesh`); the port keeps the
same single-controller design, one process driving every shard, with the
collectives written out as explicit stages over a list of shards
(`repro_torch.exec.sharded`, `repro_torch.models.moe`). What carries over:

- `MeshSpec`, the declarative, hashable mesh shape on ``ExecConfig.mesh``
  (part of the `resolve_plan` cache key), with the launcher's ``--mesh``
  forms. `MeshSpec.build` makes a small `Mesh`: the axis names and sizes
  and one `torch.device` per position, cached per spec and device kind.
  With no devices given, a CUDA mesh takes ``cuda:0 .. n-1`` and raises
  when the process has fewer cards; a CPU mesh puts every position on
  ``cpu``. A caller may build a spec onto an explicit list that repeats a
  device (``["cuda:0"] * 4``): every shard then runs on that card, the
  analogue of the reference's simulated host devices, and later `build`
  calls (the backends') return that mesh.
- `MeshContext`, the conventional axis roles the MoE FFN reads.
- `ShardingPolicy.spec_for`, which maps logical axis names onto mesh axes,
  never reusing a mesh axis and dropping an assignment that does not
  divide its dimension.
- `param_specs`, the Megatron placement rules over the port's unstacked
  parameter tree (one dict per layer): a spec is a tuple with one entry per
  dimension (None: replicated).

Only the ``model`` axis shards attention; replicas along ``data`` compute
the same thing, so the port runs one replica set and ``data`` only splits
the MoE batch, as the reference's ``batch_spec`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["Mesh", "MeshContext", "MeshSpec", "ShardingPolicy",
           "param_specs"]

_DP_AXES = ("pod", "data")


# --------------------------------------------------------------------------
# the built mesh
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Axis names and sizes, and the device of every mesh position
    (``devices`` is an object array of `torch.device`, one dim per axis)."""

    axis_names: tuple
    devices: np.ndarray

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, name: str) -> list:
        """The devices along axis ``name``, every other axis at index 0
        (one replica set); ``[devices.flat[0]]`` when the axis is absent."""
        if name not in self.axis_names:
            return [self.devices.flat[0]]
        ax = self.axis_names.index(name)
        index = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[ax]):
            index[ax] = i
            out.append(self.devices[tuple(index)])
        return out


_BUILT_MESHES: dict = {}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape: what `ExecConfig.mesh` carries.

    A frozen, hashable value: `resolve_plan` is cached over
    ``(ModelConfig, ExecConfig)``, so the config carries the mesh *shape*
    (which decides the capability predicates: model_size, divisibility),
    never devices. ``axes`` is an ordered tuple of ``(name, size)`` pairs;
    `parse` takes the launcher's ``--mesh`` forms ``"4"`` / ``"model=4"`` /
    ``"data=2,model=4"``.
    """

    axes: tuple = ()

    def __post_init__(self):
        seen = set()
        for entry in self.axes:
            name, size = entry
            if name in seen:
                raise ValueError(f"duplicate mesh axis {name!r} in {self.axes}")
            seen.add(name)
            if not isinstance(size, int) or size < 1:
                raise ValueError(f"mesh axis {name!r} needs a positive int "
                                 f"size, got {size!r}")

    @classmethod
    def parse(cls, text: str) -> "MeshSpec":
        """``"4"`` (model=4) / ``"model=4"`` / ``"data=2,model=4"``."""
        axes = []
        for part in str(text).split(","):
            part = part.strip()
            if not part:
                continue
            name, eq, size = part.partition("=")
            if not eq:
                name, size = "model", part
            try:
                axes.append((name.strip(), int(size)))
            except ValueError:
                raise ValueError(f"--mesh entries are axis=size, got {part!r}")
        return cls(axes=tuple(axes))

    @property
    def axis_names(self) -> tuple:
        return tuple(name for name, _ in self.axes)

    @property
    def n_devices(self) -> int:
        return int(np.prod([size for _, size in self.axes], dtype=np.int64)) \
            if self.axes else 1

    @property
    def model_size(self) -> int:
        return dict(self.axes).get("model", 1)

    def describe(self) -> str:
        return ",".join(f"{n}={s}" for n, s in self.axes) or "1"

    def build(self, devices=None, kind: str = "cuda") -> Mesh:
        """The concrete `Mesh` (cached per spec and device kind).

        ``devices``: one device per position, in row-major order over the
        axes; a device may repeat (several shards on one card). With none
        given, the cached mesh of ``kind``, else ``cuda:0 .. n-1`` for
        ``kind="cuda"`` (raising, with the count, when the process has
        fewer cards) or ``cpu`` at every position for ``kind="cpu"``.
        """
        if devices is not None:
            devs = [torch.device(d) for d in devices]
            if len(devs) != self.n_devices:
                raise ValueError(f"mesh {self.describe()} takes "
                                 f"{self.n_devices} devices, got {len(devs)}")
            kinds = {d.type for d in devs}
            if len(kinds) != 1:
                raise ValueError(f"one device kind per mesh, got {kinds}")
            kind = kinds.pop()
        else:
            cached = _BUILT_MESHES.get((self, kind))
            if cached is not None:
                return cached
            if kind == "cuda":
                have = torch.cuda.device_count()
                if self.n_devices > have:
                    raise RuntimeError(
                        f"mesh {self.describe()} needs {self.n_devices} "
                        f"devices but the process has {have} CUDA "
                        f"device(s); run on that many cards, or build the "
                        f"spec onto an explicit device list first (a list "
                        f"may repeat a card: MeshSpec.build(['cuda:0'] * "
                        f"{self.n_devices}))")
                devs = [torch.device("cuda", i) for i in range(self.n_devices)]
            elif kind == "cpu":
                devs = [torch.device("cpu")] * self.n_devices
            else:
                raise ValueError(f"no mesh of device kind {kind!r}")
        grid = np.empty(len(devs), dtype=object)
        grid[:] = devs
        mesh = Mesh(self.axis_names,
                    grid.reshape(tuple(s for _, s in self.axes) or (1,)))
        _BUILT_MESHES[(self, kind)] = mesh
        return mesh

    def context(self, kind: str = "cuda") -> "MeshContext":
        return MeshContext(self.build(kind=kind))


# --------------------------------------------------------------------------
# mesh context
# --------------------------------------------------------------------------

@dataclasses.dataclass
class MeshContext:
    """Physical mesh + the conventional axis roles used by the model stack."""

    mesh: Optional[Mesh] = None

    @property
    def axis_names(self) -> tuple:
        return tuple(self.mesh.axis_names) if self.mesh is not None else ()

    def _size(self, name: str) -> int:
        return int(self.mesh.shape[name]) if name in self.axis_names else 1

    @property
    def model_size(self) -> int:
        return self._size("model")

    @property
    def present_dp_axes(self) -> tuple:
        return tuple(a for a in _DP_AXES if a in self.axis_names)

    @property
    def dp_size(self) -> int:
        return int(np.prod([self._size(a) for a in self.present_dp_axes],
                           dtype=np.int64))

    def model_devices(self) -> list:
        """One device per ``model`` shard (the first replica set)."""
        return self.mesh.axis_devices("model")


# --------------------------------------------------------------------------
# policy
# --------------------------------------------------------------------------

def _default_axis_map(mesh) -> dict:
    names = tuple(mesh.axis_names) if mesh is not None else ()
    dp = tuple(a for a in _DP_AXES if a in names)
    model = ("model",) if "model" in names else ()
    return {
        "batch": dp,
        "seq": (),            # caches replicate over seq
        "sp_seq": model,      # Megatron-SP residual stream
        "heads": model,
        "mlp": model,
        "vocab": model,
        "model": model,
        "chunks": model,      # SSD chunk dim fallback when heads don't divide
        "headdim": (),
    }


class ShardingPolicy:
    """Maps logical axis names onto mesh axes with divisibility checks.

    ``mesh`` needs only ``axis_names`` and ``shape`` (a `Mesh`, or any
    object with the two, as the reference's tests fake one).
    """

    def __init__(self, mesh, axis_map: Optional[dict] = None):
        self.mesh = mesh
        self.axis_map = dict(axis_map) if axis_map is not None \
            else _default_axis_map(mesh)

    def mesh_axes(self, name: Optional[str]) -> tuple:
        if name is None:
            return ()
        return tuple(self.axis_map.get(name, ()))

    def axes_size(self, axes) -> int:
        if isinstance(axes, str):
            axes = (axes,)
        return int(np.prod([int(self.mesh.shape[a]) for a in axes],
                           dtype=np.int64)) if axes else 1

    def spec_for(self, shape: tuple, names: tuple) -> tuple:
        """One entry per dim of ``shape`` (one logical name or None each):
        None (replicated), a mesh axis name, or a tuple of them.

        A mesh axis is used at most once; an assignment that does not divide
        the dimension is dropped (replicated) rather than erroring.
        """
        used: set = set()
        entries = []
        for dim, name in zip(shape, names):
            picked = []
            for ax in self.mesh_axes(name):
                size = int(self.mesh.shape[ax])
                if ax in used or size <= 0:
                    continue
                if dim % (self.axes_size(tuple(picked)) * size) != 0:
                    continue
                picked.append(ax)
            used.update(picked)
            if not picked:
                entries.append(None)
            elif len(picked) == 1:
                entries.append(picked[0])
            else:
                entries.append(tuple(picked))
        return tuple(entries)


# --------------------------------------------------------------------------
# parameter sharding rules
# --------------------------------------------------------------------------

# logical axes per weight leaf, keyed by leaf name and aligned to the
# *trailing* dims of the leaf (leading expert dims replicate). Megatron
# split: qkv/up projections shard their output (heads/mlp), wo/down their
# input, embeddings the vocab.
_PARAM_RULES = {
    "wq": (None, "heads", None),
    "wk": (None, "heads", None),
    "wv": (None, "heads", None),
    "bq": ("heads", None),
    "bk": ("heads", None),
    "bv": ("heads", None),
    "wo": ("heads", None, None),
    "w1": (None, "mlp"),
    "w3": (None, "mlp"),
    "w2": ("mlp", None),
    "tok_emb": ("vocab", None),
    "unembed": (None, "vocab"),
    "w_z": (None, "heads"),
    "w_x": (None, "heads"),
    "w_B": (None, "heads"),
    "w_C": (None, "heads"),
    "w_dt": (None, "heads"),
    "out_proj": ("heads", None),
}


def _leaf_axes(name: str, shape: tuple) -> tuple:
    rule = _PARAM_RULES.get(name)
    if rule is None or len(rule) > len(shape):
        return tuple(None for _ in shape)
    return tuple(None for _ in range(len(shape) - len(rule))) + tuple(rule)


def param_specs(params, cfg, policy: ShardingPolicy):
    """The spec tree of a parameter tree (dicts and lists of tensors, or
    of anything with a ``shape``). A resident `QuantizedWeight` (int8 codes
    and per-column scales, flattened to 2-D) replicates, as the reference's
    codes and scales do (no rule names them)."""
    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, name) for v in node]
        if hasattr(node, "codes"):  # a resident QuantizedWeight
            return {"codes": (None,) * node.codes.ndim,
                    "scale": (None,) * node.scale.ndim}
        shape = tuple(node.shape)
        return policy.spec_for(shape, _leaf_axes(name, shape))
    return walk(params, None)
