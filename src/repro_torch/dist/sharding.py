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

- `place_params`, the placement of a parameter tree on a mesh (the
  reference's ``jax.device_put`` under `named_sharding_tree`): each leaf
  becomes a `Placed` leaf, its stripes on the devices of the mesh
  positions that hold them, and `gather` / `gather_tree` bring a leaf or a
  subtree whole onto one device (differentiably: ``.to`` and
  ``torch.cat``), `unplace` a whole tree for a checkpoint.

Only the ``model`` axis shards attention; replicas along ``data`` compute
the same thing, so the port serves one replica set and ``data`` only splits
the MoE batch, as the reference's ``batch_spec`` does. Training splits the
batch over the ``data`` (and ``pod``) replicas (`replica_devices`), and
each replica's products over its ``model`` positions (`repro_torch.dist.tp`,
the reference's `use_policy` / `constraint`).

There is no ``torch.distributed`` job behind a mesh: one process drives
every position, so there is no process group, DTensor or FSDP wrapper. A
stripe is a tensor on its position's device; a gather is ``.to`` and
``torch.cat`` in that process.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["Mesh", "MeshContext", "MeshSpec", "Placed", "ShardingPolicy",
           "gather", "gather_tree", "is_placed", "param_specs", "partwise",
           "place_model_params", "place_params", "placement_policy",
           "position_bytes", "replica_devices", "roots", "sum_copies",
           "unplace", "with_roots"]

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
        fewer cards) or ``cpu`` (``meta``) at every position for
        ``kind="cpu"`` (``"meta"``: shapes only, for the dry-run).
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
            elif kind in ("cpu", "meta"):
                devs = [torch.device(kind)] * self.n_devices
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


def placement_policy(mesh, cfg) -> ShardingPolicy:
    """The policy a parameter tree is placed under: the default axis map,
    and when ``cfg.fsdp`` the present ``pod``/``data`` axes appended to
    ``heads``, ``mlp`` and ``vocab`` (the reference engine's FSDP rule), so
    a weight too large for one device stripes over the data replicas too."""
    policy = ShardingPolicy(mesh)
    if cfg.fsdp:
        dp = tuple(a for a in _DP_AXES if a in mesh.axis_names)
        for name in ("heads", "mlp", "vocab"):
            policy.axis_map[name] = tuple(policy.axis_map.get(name, ())) + dp
    return policy


# --------------------------------------------------------------------------
# placement: the parameter tree in stripes over the mesh's devices
# --------------------------------------------------------------------------

def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _norm_device(device) -> torch.device:
    """``cuda`` without an index means the current card, as a tensor's
    ``.device`` names it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Placed:
    """One leaf of a parameter tree in stripes over a mesh.

    ``spec`` has one entry per dimension (`param_specs`); dimension ``d``
    is cut into ``splits[d]`` equal chunks, the product of its mesh axes'
    sizes (the first axis of an entry the major one), and shard ``sid``
    is the row-major index of a chunk on every dimension. A mesh position
    holds the shard of its coordinates; the axes a spec does not name
    replicate it.

    The leaf is stored in ``parts``, one ``(device, sid, tensor)`` per
    holder: the positions are grouped by device (by position under
    `_distinct_positions`), and a holder that needs every shard keeps the whole
    leaf (``sid`` None) with its stripes views into that one storage, so
    on one card the placed leaf is the very tensor it was made from. A
    holder that needs some shards keeps each as a tensor of its own. A
    leaf that is not a tensor (a resident `QuantizedWeight`) replicates:
    one whole part per holder.
    """

    def __init__(self, mesh, spec, shape, parts):
        self.mesh = mesh
        self.spec = spec
        self.shape = shape
        self.parts = parts
        self.splits = tuple(
            int(np.prod([mesh.shape[a] for a in _entry_axes(e)],
                        dtype=np.int64)) for e in spec)
        self.n_shards = int(np.prod(self.splits, dtype=np.int64))

    # ---------------------------------------------------------- layout
    def _chunk_index(self, sid: int) -> tuple:
        return tuple(int(i) for i in np.unravel_index(sid, self.splits)) \
            if self.splits else ()

    def _chunk(self, whole, sid: int):
        """Shard ``sid`` of the whole leaf ``whole``: a view."""
        if self.n_shards == 1:
            return whole
        for d, (i, n) in enumerate(zip(self._chunk_index(sid),
                                       self.splits)):
            if n > 1:
                size = whole.shape[d] // n
                whole = whole.narrow(d, i * size, size)
        return whole

    def position_sid(self, position: tuple) -> int:
        """The shard a mesh position (one index per mesh axis) holds."""
        coord = dict(zip(self.mesh.axis_names, position))
        index = []
        for e in self.spec:
            i = 0
            for a in _entry_axes(e):
                i = i * int(self.mesh.shape[a]) + int(coord[a])
            index.append(i)
        return int(np.ravel_multi_index(index, self.splits)) \
            if self.splits else 0

    @property
    def dtype(self):
        return self.parts[0][2].dtype

    @property
    def devices(self) -> list:
        return [d for d, _, _ in self.parts]

    # --------------------------------------------------------- reading
    def shard(self, sid: int, device=None):
        """Shard ``sid``, from a holder on ``device`` when there is one."""
        device = None if device is None else _norm_device(device)
        first = None
        for dev, psid, t in self.parts:
            if psid is None or psid == sid:
                if dev == device:
                    return t if psid is not None else self._chunk(t, sid)
                if first is None:
                    first = t if psid is not None else self._chunk(t, sid)
        return first

    def stripe(self, position: tuple):
        """The stripe a mesh position holds (a view where its holder keeps
        the whole leaf)."""
        return self.shard(self.position_sid(position),
                          self.mesh.devices[tuple(position)])

    def gather(self, device):
        """The whole leaf on ``device``: the holder's own tensor where it
        keeps the whole leaf there, else the shards moved (``.to``) and
        concatenated. Differentiable: autograd sends each gradient back to
        the part it was read from."""
        device = _norm_device(device)
        for dev, psid, t in self.parts:
            if psid is None and dev == device:
                return t
        if self.n_shards == 1:
            return self.shard(0, device).to(device)
        return self._assemble(device, lambda sid: self.shard(sid, device),
                              [range(n) for n in self.splits])

    def gather_slice(self, device, dim: int, lo: int, hi: int):
        """``gather(device)`` narrowed to ``[lo, hi)`` along ``dim``, read
        from the shards that overlap it only: a stripe that is that slice
        is returned as it is (moved to ``device``)."""
        device = _norm_device(device)
        dim = dim % len(self.shape)
        for dev, psid, t in self.parts:
            if psid is None and dev == device:
                return t.narrow(dim, lo, hi - lo)
        size = self.shape[dim] // self.splits[dim]
        ranges = [range(n) for n in self.splits]
        ranges[dim] = range(lo // size, -(-hi // size))

        def piece(sid):
            t = self.shard(sid, device)
            start = self._chunk_index(sid)[dim] * size
            a, b = max(lo, start), min(hi, start + size)
            return t if (a, b) == (start, start + size) \
                else t.narrow(dim, a - start, b - a)
        return self._assemble(device, piece, ranges)

    def _assemble(self, device, piece, ranges):
        def build(prefix):
            d = len(prefix)
            if d == len(ranges):
                sid = int(np.ravel_multi_index(prefix, self.splits))
                return piece(sid).to(device)
            subs = [build(prefix + (i,)) for i in ranges[d]]
            return subs[0] if len(subs) == 1 else torch.cat(subs, d)
        return build(())

    # -------------------------------------------------- roots (training)
    def roots(self) -> list:
        """The stored tensors, one a part: what autograd and the optimizer
        see."""
        return [t for _, _, t in self.parts]

    def with_roots(self, tensors) -> "Placed":
        """The same layout holding ``tensors`` (one a part)."""
        return Placed(self.mesh, self.spec, self.shape,
                      [(d, s, t) for (d, s, _), t in zip(self.parts, tensors)])

    def map_roots(self, fn, *others) -> "Placed":
        """``fn`` part by part over this leaf and ``others`` (leaves of the
        same layout): the optimizer's moments live where their stripe
        does."""
        rest = [o.roots() for o in others]
        return self.with_roots([fn(t, *(r[i] for r in rest))
                                for i, t in enumerate(self.roots())])

    def unique_roots(self) -> list:
        """Tensors that hold every shard once: a whole part, else the first
        copy of each shard (a norm counts a replicated leaf once)."""
        for _, psid, t in self.parts:
            if psid is None:
                return [t]
        seen, out = set(), []
        for _, psid, t in self.parts:
            if psid not in seen:
                seen.add(psid)
                out.append(t)
        return out

    def sum_copies(self) -> "Placed":
        """Of a gradient leaf: every copy of a shard given the sum over
        its copies (the data replicas' all-reduce). With one holder a
        shard there is nothing to sum and the leaf comes back as it is."""
        contrib = {sid: [] for sid in range(self.n_shards)}
        for _, psid, t in self.parts:
            if psid is None:
                for sid in contrib:
                    contrib[sid].append(self._chunk(t, sid))
            else:
                contrib[psid].append(t)
        if all(len(c) == 1 for c in contrib.values()):
            return self
        total = {}
        for sid, ts in contrib.items():
            acc = ts[0]
            for t in ts[1:]:
                acc = acc + t.to(acc.device)
            total[sid] = acc
        new = []
        for dev, psid, _ in self.parts:
            if psid is None:
                new.append(self._assemble(dev, total.__getitem__,
                                          [range(n) for n in self.splits]))
            else:
                new.append(total[psid].to(dev))
        return self.with_roots(new)

    def _filled(self, whole, layout) -> "Placed":
        """``whole`` in ``layout``'s ``(device, sid)`` holders: a whole
        part moved as it is, a shard copied into a tensor of its own."""
        return Placed(self.mesh, self.spec, self.shape, [
            (dev, sid, whole.to(dev) if sid is None else self._chunk(
                whole, sid).to(device=dev, copy=True,
                               memory_format=torch.contiguous_format))
            for dev, sid in layout])

    def like(self, whole) -> "Placed":
        """``whole`` placed as this leaf is, holder for holder (the
        elastic restore)."""
        return self._filled(whole, [(d, s) for d, s, _ in self.parts])

    def stripe_nbytes(self, position: tuple) -> int:
        s = self.stripe(position)
        if hasattr(s, "codes"):
            return s.codes.nbytes + s.scale.nbytes
        return s.numel() * s.element_size()

    def __repr__(self):
        return (f"Placed(shape={tuple(self.shape)}, spec={self.spec}, "
                f"parts={[(str(d), s) for d, s, _ in self.parts]})")


def partwise(fn):
    """``fn`` over a leaf (and the matching leaves of other trees), or
    part by part over a placed leaf: for `tree.map` over placed trees."""
    def apply(leaf, *rest):
        if isinstance(leaf, Placed):
            return leaf.map_roots(fn, *rest)
        return fn(leaf, *rest)
    return apply


_DISTINCT = False


@contextlib.contextmanager
def _distinct_positions():
    """Within it, placing keeps every position's stripes apart even where
    positions share a device: the layout distinct cards get, built on one
    device (the tests read it on the CPU)."""
    global _DISTINCT
    before, _DISTINCT = _DISTINCT, True
    try:
        yield
    finally:
        _DISTINCT = before


def place_leaf(x, spec, mesh) -> Placed:
    """``x`` (a tensor, or a resident weight: replicated) in stripes
    under ``spec`` over ``mesh``; see `Placed`."""
    if isinstance(x, Placed):
        x = x.gather(x.devices[0])
    quantized = hasattr(x, "codes")
    shape = tuple(x.codes.shape) if quantized else tuple(x.shape)
    if quantized or spec is None:
        spec = (None,) * (0 if quantized else len(shape))
    probe = Placed(mesh, spec, shape, [])
    holders: dict = {}
    for flat, position in enumerate(np.ndindex(*mesh.devices.shape)):
        dev = _norm_device(mesh.devices[position])
        holders.setdefault(flat if _DISTINCT else dev, (dev, set()))[1].add(
            probe.position_sid(position))
    layout = []
    for dev, sids in holders.values():
        layout += [(dev, None)] if len(sids) == probe.n_shards \
            else [(dev, sid) for sid in sorted(sids)]
    return probe._filled(x, layout)


def place_params(params, specs, mesh):
    """``params`` with each leaf placed under its spec (`param_specs`'
    tree) over ``mesh``: the counterpart of ``jax.device_put(params,
    named_sharding_tree(specs, mesh))``."""
    if isinstance(params, dict):
        return {k: place_params(v, specs[k], mesh) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(place_params(v, s, mesh)
                            for v, s in zip(params, specs))
    if params is None:
        return None
    return place_leaf(params, None if hasattr(params, "codes") else specs,
                      mesh)


def place_model_params(params, cfg, mesh):
    """``params`` placed under `param_specs` with `placement_policy`."""
    specs = param_specs(params, cfg, placement_policy(mesh, cfg))
    return place_params(params, specs, mesh)


def gather(leaf, device):
    """A leaf whole on ``device``: `Placed.gather`, or ``leaf.to``."""
    if isinstance(leaf, Placed):
        return leaf.gather(device)
    return leaf.to(device)


def gather_tree(node, device, skip: tuple = ()):
    """``node`` with every `Placed` leaf gathered whole onto ``device``;
    other leaves, and the subtrees under a key in ``skip``, as they are."""
    if isinstance(node, Placed):
        return node.gather(device)
    if isinstance(node, dict):
        return {k: (v if k in skip else gather_tree(v, device, skip))
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(gather_tree(v, device, skip) for v in node)
    return node


def unplace(tree_, device="cpu"):
    """A placed tree whole on ``device`` (tensors moved there too)."""
    if isinstance(tree_, dict):
        return {k: unplace(v, device) for k, v in tree_.items()}
    if isinstance(tree_, (list, tuple)):
        return type(tree_)(unplace(v, device) for v in tree_)
    if tree_ is None:
        return None
    return gather(tree_, device)


def is_placed(node) -> bool:
    """Whether ``node`` holds a `Placed` leaf."""
    if isinstance(node, Placed):
        return True
    if isinstance(node, dict):
        return any(is_placed(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return any(is_placed(v) for v in node)
    return False


def _leaves(node) -> list:
    if isinstance(node, dict):
        return [x for k in sorted(node) for x in _leaves(node[k])]
    if isinstance(node, (list, tuple)):
        return [x for v in node for x in _leaves(v)]
    return [] if node is None else [node]


def roots(tree_) -> list:
    """The stored tensors of a tree in leaf order: a `Placed` leaf's
    parts, a plain leaf itself."""
    out = []
    for leaf in _leaves(tree_):
        out.extend(leaf.roots() if isinstance(leaf, Placed) else [leaf])
    return out


def with_roots(tree_, tensors: list):
    """``tree_`` holding ``tensors`` (in `roots` order)."""
    it = iter(tensors)

    def take(leaf):
        if isinstance(leaf, Placed):
            return leaf.with_roots([next(it) for _ in leaf.parts])
        return next(it)

    def build(node):
        if isinstance(node, dict):
            new = {k: build(node[k]) for k in sorted(node)}
            return {k: new[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return None if node is None else take(node)
    out = build(tree_)
    if next(it, None) is not None:
        raise ValueError("more tensors than the tree's roots")
    return out


def sum_copies(grads):
    """A gradient tree with each `Placed` leaf's copies summed
    (`Placed.sum_copies`)."""
    if isinstance(grads, Placed):
        return grads.sum_copies()
    if isinstance(grads, dict):
        return {k: sum_copies(v) for k, v in grads.items()}
    if isinstance(grads, (list, tuple)):
        return type(grads)(sum_copies(v) for v in grads)
    return grads


def replica_devices(mesh) -> list:
    """The compute device of each data replica, over the ``pod`` and
    ``data`` axes in mesh order: its position with every other axis
    (``model``) at 0."""
    names = mesh.axis_names
    dp = [names.index(a) for a in _DP_AXES if a in names]
    out = []
    for idx in np.ndindex(*[mesh.devices.shape[i] for i in dp]):
        position = [0] * len(names)
        for i, v in zip(dp, idx):
            position[i] = v
        out.append(_norm_device(mesh.devices[tuple(position)]))
    return out


def position_bytes(tree_, mesh) -> list:
    """Bytes of the stripes each mesh position holds (row-major over the
    mesh): what each of distinct cards would hold."""
    leaves = [x for x in _leaves(tree_) if isinstance(x, Placed)]
    return [sum(x.stripe_nbytes(position) for x in leaves)
            for position in np.ndindex(*mesh.devices.shape)]
