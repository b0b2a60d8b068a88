"""The placement of parameter trees on a mesh (`repro_torch.dist`:
`place_params`, `Placed`, `gather`, `gather_tree`, `unplace`), on the CPU.

* Every catalog model's tree (made on ``meta``: no memory) placed under
  data=2,model=2, with and without the FSDP axis map, and under
  pod=2,data=2,model=2 for one model: each position's stripe has the shard
  shape of the reference's `param_specs` spec for that leaf (the
  reference's rules run on a fake mesh, as tests/test_sharded_exec.py
  does).
* On tiny models on the CPU, for positions on one device and kept apart
  (`_distinct_positions`): each stripe is the chunk of the leaf that the
  spec's mesh coordinates name (the first axis of an entry the major one), and
  `gather` of the placed leaf is the leaf bit for bit; on one device the
  placed leaf is the very tensor and its stripes views of it.
* Resident `QuantizedWeight` leaves replicate; `gather_slice` reads a
  stripe in place; `sum_copies`, `roots`/`with_roots`,
  `replica_devices`, `position_bytes` and the FSDP axis map.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.dist.sharding import ShardingPolicy as RPolicy  # noqa: E402
from repro.dist.sharding import param_specs as r_param_specs  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs.catalog import PORTED  # noqa: E402
from repro_torch.dist import (MeshSpec, Placed, gather, gather_tree,  # noqa: E402
                              is_placed, place_model_params,
                              placement_policy, position_bytes,
                              replica_devices, roots, sum_copies, unplace,
                              with_roots)
from repro_torch.dist.sharding import _distinct_positions  # noqa: E402
from repro_torch.models import Model, quantize_model_params  # noqa: E402

from _torch_helpers import port_model_config  # noqa: E402
from conftest import tiny_config  # noqa: E402

MESHES = {"data=2,model=2": (("data", 2), ("model", 2)),
          "pod=2,data=2,model=2": (("pod", 2), ("data", 2), ("model", 2))}


def _fake_mesh(axes):
    return SimpleNamespace(axis_names=tuple(a for a, _ in axes),
                           shape=dict(axes))


def _reference_specs(params, cfg, axes, fsdp):
    """The reference's spec of every leaf of the port's tree (its rules
    read a leaf's name and shape), with the reference engine's FSDP map."""
    mesh = _fake_mesh(axes)
    pol = RPolicy(mesh)
    if fsdp:
        amap = dict(pol.axis_map)
        dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        for name in ("heads", "mlp", "vocab"):
            amap[name] = tuple(amap.get(name, ())) + dp
        pol.axis_map = amap
    specs = r_param_specs(params, cfg, pol)
    flat = jax.tree_util.tree_flatten(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return [tuple(s) for s in flat], dict(axes)


def _shard_shape(shape, spec, sizes):
    out = []
    for dim, entry in zip(shape, spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        out.append(dim // int(np.prod([sizes[a] for a in axes])))
    return tuple(out)


CASES = [(name, fsdp, "data=2,model=2") for name in PORTED
         for fsdp in (False, True)] + [("command-r-35b", True,
                                        "pod=2,data=2,model=2")]


@pytest.mark.parametrize("name,fsdp,mesh_name", CASES,
                         ids=[f"{n}-{'fsdp' if f else 'tp'}-{m}"
                              for n, f, m in CASES])
def test_stripes_take_the_reference_shard_shapes(name, fsdp, mesh_name):
    rcfg = get_config(name)
    cfg = port_model_config(rcfg).replace(fsdp=fsdp)
    params = Model(cfg, device="meta").init(torch.Generator())
    want, sizes = _reference_specs(params, rcfg, MESHES[mesh_name], fsdp)
    mesh = MeshSpec(axes=MESHES[mesh_name]).build(kind="meta")
    placed = place_model_params(params, cfg, mesh)
    leaves = tree.leaves(placed)
    assert len(leaves) == len(want) > 0
    striped = 0
    for leaf, spec in zip(leaves, want):
        assert isinstance(leaf, Placed) and leaf.spec == spec
        shard = _shard_shape(leaf.shape, spec, sizes)
        for position in np.ndindex(*mesh.devices.shape):
            assert tuple(leaf.stripe(position).shape) == shard
        striped += shard != tuple(leaf.shape)
    assert striped > 0
    assert len(leaves[0].parts) == 1  # one device: the whole leaf, once


def _chunk_of(x, spec, sizes, coord):
    """The chunk of ``x`` at mesh coordinates ``coord``, by numpy."""
    x = np.asarray(x)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n, i = 1, 0
        for a in axes:
            n *= sizes[a]
            i = i * sizes[a] + coord[a]
        size = x.shape[d] // n
        x = np.take(x, np.arange(i * size, (i + 1) * size), axis=d)
    return x


def _place(params, cfg, mesh, distinct=False):
    """`place_model_params`, with every position's stripes kept apart
    when ``distinct`` (the layout of distinct cards)."""
    if not distinct:
        return place_model_params(params, cfg, mesh)
    with _distinct_positions():
        return place_model_params(params, cfg, mesh)


def _tiny(name, **kw):
    cfg = port_model_config(tiny_config(get_config(name))).replace(**kw)
    return cfg, Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))


@pytest.mark.parametrize("distinct", [False, True],
                         ids=["one-device", "distinct"])
@pytest.mark.parametrize("name", ["gpt2-large", "mixtral-8x22b",
                                  "jamba-v0.1-52b"])
def test_gather_of_place_is_the_leaf(name, distinct):
    cfg, params = _tiny(name, fsdp=True)
    spec = MeshSpec(axes=MESHES["data=2,model=2"])
    mesh = spec.build(kind="cpu")
    placed = _place(params, cfg, mesh, distinct)
    assert is_placed(placed) and not is_placed(params)
    sizes = dict(MESHES["data=2,model=2"])
    for x, leaf in zip(tree.leaves(params), tree.leaves(placed)):
        whole = gather(leaf, "cpu")
        assert whole.dtype == x.dtype and torch.equal(whole, x)
        if not distinct:  # the very tensor; its stripes views of it
            assert whole is x and len(leaf.parts) == 1
        for position in np.ndindex(*mesh.devices.shape):
            stripe = leaf.stripe(position)
            coord = dict(zip(mesh.axis_names, position))
            np.testing.assert_array_equal(
                stripe.numpy(), _chunk_of(x.numpy(), leaf.spec, sizes, coord))
            if not distinct:
                assert stripe.untyped_storage().data_ptr() == \
                    x.untyped_storage().data_ptr()
    back = unplace(placed)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(back),
                                                 tree.leaves(params)))
    layer = gather_tree(placed["blocks"][0], "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(layer), tree.leaves(params["blocks"][0])))


@pytest.mark.parametrize("distinct", [False, True],
                         ids=["one-device", "distinct"])
def test_quantized_weights_replicate(distinct):
    cfg, params = _tiny("gpt2-large", fsdp=True)
    q = quantize_model_params(params)
    mesh = MeshSpec(axes=MESHES["data=2,model=2"]).build(kind="cpu")
    placed = _place(q, cfg, mesh, distinct)
    wq = placed["blocks"][0]["attn"]["wq"]
    assert isinstance(wq, Placed) and wq.n_shards == 1
    assert len(wq.parts) == (4 if distinct else 1)
    ref = q["blocks"][0]["attn"]["wq"]
    for position in np.ndindex(*mesh.devices.shape):
        s = wq.stripe(position)
        assert torch.equal(s.codes, ref.codes) and torch.equal(s.scale,
                                                               ref.scale)
        assert s.shape == ref.shape
    # the float leaves still stripe: the q bias over heads, model x data
    assert placed["blocks"][0]["attn"]["bq"].spec == (("model", "data"),
                                                      None)
    # quantizing a placed float tree gives the same codes
    again = quantize_model_params(place_model_params(params, cfg, mesh))
    got = again["blocks"][0]["attn"]["wq"]
    assert torch.equal(got.codes, ref.codes)


def test_gather_slice_reads_the_owned_stripe():
    cfg, params = _tiny("mixtral-8x22b", fsdp=False)
    mesh = MeshSpec(axes=MESHES["data=2,model=2"]).build(kind="cpu")
    w1 = params["blocks"][0]["moe"]["w1"]          # (E, D, F), F on model
    F = w1.shape[-1]
    tp = _place(params, cfg, mesh, distinct=True)
    leaf = tp["blocks"][0]["moe"]["w1"]
    assert leaf.spec == (None, None, "model")
    for m in range(2):
        got = leaf.gather_slice("cpu", -1, m * F // 2, (m + 1) * F // 2)
        assert got.data_ptr() == leaf.stripe((0, m)).data_ptr()  # in place
        assert torch.equal(got, w1[..., m * F // 2:(m + 1) * F // 2])
    ep = leaf.gather_slice("cpu", 0, 2, 4)       # experts 2, 3 of 4
    assert torch.equal(ep, w1[2:4])
    fsdp = _place(params, cfg.replace(fsdp=True), mesh,
                  distinct=True)["blocks"][0]["moe"]["w1"]
    assert fsdp.spec == (None, None, ("model", "data"))
    assert torch.equal(fsdp.gather_slice("cpu", 2, F // 2, F),
                       w1[..., F // 2:])
    one = place_model_params(params, cfg, mesh)["blocks"][0]["moe"]["w1"]
    view = one.gather_slice("cpu", 2, 0, F // 2)
    assert view.data_ptr() == w1.data_ptr()


@pytest.mark.parametrize("distinct", [False, True],
                         ids=["one-device", "distinct"])
def test_like_places_a_leaf_as_the_template(distinct):
    """The elastic restore's step: a whole leaf placed holder for holder as
    a placed template is, whatever layout placed the template."""
    cfg, params = _tiny("mixtral-8x22b", fsdp=True)
    mesh = MeshSpec(axes=MESHES["data=2,model=2"]).build(kind="cpu")
    placed = _place(params, cfg, mesh, distinct)
    for x, leaf in zip(tree.leaves(params), tree.leaves(placed)):
        new = leaf.like(x + 1)
        assert [(str(d), s) for d, s, _ in new.parts] == \
            [(str(d), s) for d, s, _ in leaf.parts]
        assert new.spec == leaf.spec and torch.equal(new.gather("cpu"), x + 1)


def test_sum_copies_roots_and_bytes():
    cfg, params = _tiny("gpt2-large", fsdp=True)
    mesh = MeshSpec(axes=MESHES["data=2,model=2"]).build(kind="cpu")
    placed = _place(params, cfg, mesh, distinct=True)
    flat = roots(placed)
    assert len(flat) == sum(len(x.parts) for x in tree.leaves(placed))
    again = with_roots(placed, [t + 1 for t in flat])
    assert torch.equal(unplace(again)["final_norm"]["scale"],
                       params["final_norm"]["scale"] + 1)
    norm = placed["final_norm"]["scale"]          # replicated: 4 copies
    assert len(norm.parts) == 4
    ones = norm.with_roots([torch.full_like(t, float(i))
                            for i, t in enumerate(norm.roots())])
    summed = sum_copies({"n": ones})["n"]
    assert all(torch.equal(t, torch.full_like(t, 6.0))
               for t in summed.roots())
    bq = placed["blocks"][0]["attn"]["bq"]        # 4 stripes, no copies
    assert sum_copies(bq) is bq and len(bq.unique_roots()) == 4
    per = position_bytes(placed, mesh)
    whole = sum(x.numel() * x.element_size() for x in tree.leaves(params))
    assert len(per) == 4 and len(set(per)) == 1 and per[0] < whole
    assert replica_devices(mesh) == [torch.device("cpu")] * 2
    three = MeshSpec(axes=MESHES["pod=2,data=2,model=2"]).build(
        ["cpu"] * 8)
    assert len(replica_devices(three)) == 4


def test_placement_policy_is_the_reference_engines_fsdp_map():
    mesh = MeshSpec(axes=MESHES["pod=2,data=2,model=2"]).build(kind="meta")
    cfg = port_model_config(get_config("command-r-35b"))
    amap = placement_policy(mesh, cfg).axis_map
    assert amap["heads"] == amap["mlp"] == amap["vocab"] == (
        "model", "pod", "data")
    assert placement_policy(mesh, cfg.replace(fsdp=False)).axis_map[
        "mlp"] == ("model",)
