"""The port's mesh surface against the reference's, with no mesh built:
`MeshSpec`, plan resolution under a mesh, `ShardingPolicy` and
`param_specs` (`repro_torch.dist`, `repro_torch.exec.sharded`).

* Plans: every catalog model x {no mesh, model=2, model=4, model=8,
  data=2,model=4} x {clean, ``nominal`` noise} resolves the reference's
  backends with the reference's degrade reasons, ``plan.explain()`` line
  for line.
* `ShardingPolicy.spec_for` gives the reference's spec on the cases of
  tests/test_dist.py and tests/test_sharded_exec.py and on a sweep of
  shapes and names, on fake meshes.
* `param_specs`: every leaf of every catalog model's tree (made on the
  ``meta`` device: no memory) gets the reference's spec with the stacked
  layer dimension dropped, on a fake data=2,model=4 mesh, with and without
  the FSDP axis map.
* `MeshSpec` parses the launcher's forms, keys the plan cache, builds CPU
  meshes and meshes on an explicit (repeated) device list, and raises when
  a CUDA mesh needs more cards than the process has.
"""
import itertools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ExecConfig  # noqa: E402
from repro.dist import MeshSpec as RMeshSpec  # noqa: E402
from repro.dist.sharding import ShardingPolicy as RPolicy  # noqa: E402
from repro.dist.sharding import param_specs as r_param_specs  # noqa: E402
from repro.exec.plan import resolve_plan as r_resolve  # noqa: E402
from repro.hw.noise import NoiseConfig  # noqa: E402
from repro.models import Model as RModel  # noqa: E402
from repro_torch.configs.base import ExecConfig as TExec  # noqa: E402
from repro_torch.configs.catalog import PORTED  # noqa: E402
from repro_torch.dist import MeshSpec, ShardingPolicy, param_specs  # noqa: E402
from repro_torch.exec import get_backend, resolve_plan  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models.model import encoder_config  # noqa: E402

from _torch_helpers import port_exec_config, port_model_config  # noqa: E402

MESHES = (None, "model=2", "model=4", "model=8", "data=2,model=4")


def _fake_mesh(**shape):
    return SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


# ------------------------------------------------------------------ plans

@pytest.mark.filterwarnings("ignore::RuntimeWarning")
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m or "none")
@pytest.mark.parametrize("name", PORTED)
def test_plan_under_a_mesh_matches_reference(name, mesh):
    cfg = get_config(name)
    for noise in (None, NoiseConfig.preset("nominal", seed=7)):
        ec = ExecConfig.serving(
            mode="raceit", noise=noise,
            mesh=None if mesh is None else RMeshSpec.parse(mesh))
        rp = r_resolve(cfg, ec)
        tp = resolve_plan(port_model_config(cfg), port_exec_config(ec))
        for slot in ("attention_prefill", "attention_decode"):
            assert tp.backend(slot) == rp.backend(slot), (slot, noise)
        assert [(d.slot, d.requested, d.chosen, d.reason)
                for d in tp.degrades] == [
            (d.slot, d.requested, d.chosen, d.reason) for d in rp.degrades]
        assert tp.explain() == rp.explain()


def test_tp_backends_are_registered_and_paged():
    for slot, name in (("attention_prefill", "raceit_fused_tp"),
                       ("attention_decode", "raceit_fused_tp"),
                       ("attention_decode", "raceit_gqa_tp")):
        assert get_backend(slot, name) is not None, (slot, name)
    assert get_backend("attention_decode", "raceit_fused_tp").paged
    assert get_backend("attention_decode", "raceit_gqa_tp").paged


def test_tp_degrades_only_where_the_reference_does():
    """A non-dividing model axis and a 1-device mesh fall through to the
    single-device chain with the reason recorded; a data-only mesh is not
    tensor parallelism; the mesh is part of the plan cache key."""
    cfg = port_model_config(get_config("gpt2-large").replace(
        n_heads=8, n_kv_heads=4, d_model=128))
    plan = lambda m: resolve_plan(cfg, TExec.serving(
        mesh=None if m is None else MeshSpec.parse(m)))
    ref = plan(None)
    for m in ("model=3", "model=1", "data=4"):
        for slot in ("attention_prefill", "attention_decode"):
            assert plan(m).backend(slot) == ref.backend(slot), (m, slot)
    why = get_backend("attention_decode", "raceit_gqa_tp").supported(
        cfg, TExec.serving(mesh=MeshSpec.parse("model=3")))
    assert "divisible" in why
    assert plan("data=2,model=2").backend("attention_decode") == "raceit_gqa_tp"
    assert plan("model=4") is plan("model=4") and plan("model=4") is not ref


# ----------------------------------------------------------------- policy

_POLICY_CASES = [
    (dict(data=4, model=16), (7, 64), ("batch", "heads")),
    (dict(data=4, model=16), (24, 64), ("heads", "heads")),
    (dict(data=4, model=16), (32, 64), ("heads", "heads")),
    (dict(data=2, model=8), (6, 64), ("heads", "mlp")),
    (dict(model=4), (16, 16), ("heads", "mlp")),
    (dict(model=1), (8, 64), ("heads", "mlp")),
]


@pytest.mark.parametrize("shape,dims,names", _POLICY_CASES)
def test_spec_for_matches_reference(shape, dims, names):
    mesh = _fake_mesh(**shape)
    assert ShardingPolicy(mesh).spec_for(dims, names) == tuple(
        RPolicy(mesh).spec_for(dims, names))


def test_spec_for_sweep_matches_reference():
    names = (None, "batch", "heads", "mlp", "vocab", "seq", "sp_seq")
    for shape in (dict(data=2, model=4), dict(pod=2, data=2, model=2),
                  dict(model=3)):
        mesh = _fake_mesh(**shape)
        fsdp = {k: v + ("data",) if k in ("heads", "mlp", "vocab") else v
                for k, v in RPolicy(mesh).axis_map.items()} \
            if "data" in shape else None
        for amap in (None, fsdp):
            rp, tp = RPolicy(mesh, amap), ShardingPolicy(mesh, amap)
            for dims in itertools.product((1, 2, 6, 8, 12), repeat=2):
                for nm in itertools.product(names, repeat=2):
                    assert tp.spec_for(dims, nm) == tuple(
                        rp.spec_for(dims, nm)), (shape, dims, nm)


def test_policy_edge_cases():
    pol = ShardingPolicy(_fake_mesh(data=4, model=16))
    assert pol.spec_for((7, 64), ("batch", "heads")) == (None, "model")
    assert pol.spec_for((24, 64), ("heads", "heads")) == (None, "model")
    assert pol.spec_for((32, 64), ("heads", "heads")) == ("model", None)
    one = ShardingPolicy(_fake_mesh(model=1))
    assert one.axes_size(("model",)) == 1


# ------------------------------------------------------------ param_specs

def _port_paths(tree, prefix=()):
    """(path, leaf) of a parameter or spec tree (a spec is a tuple)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_paths(v, prefix + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _port_paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _reference_path(path, cfg):
    """The port's per-layer path -> (the reference's path, stacked?)."""
    if path[0] not in ("blocks", "encoder", "decoder"):
        return "/".join(path), False
    lcfg = encoder_config(cfg) if path[0] == "encoder" else cfg
    n = cfg.n_encoder_layers if path[0] == "encoder" else cfg.n_layers
    P_, t = lcfg.block_period, int(path[1])
    n_full = n // P_
    if t < n_full * P_:
        return "/".join((path[0], "scan", str(t % P_)) + path[2:]), True
    return "/".join((path[0], "tail", str(t - n_full * P_)) + path[2:]), False


def _amap(policy, fsdp):
    amap = dict(policy.axis_map)
    if fsdp:
        for ax in ("heads", "mlp", "vocab"):
            amap[ax] = tuple(amap.get(ax, ())) + ("data",)
    return amap


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("name", PORTED)
def test_param_specs_match_reference(name, fsdp):
    cfg = get_config(name)
    mesh = _fake_mesh(data=2, model=4)
    rpol = RPolicy(mesh)
    rpol.axis_map = _amap(rpol, fsdp)
    shapes = jax.eval_shape(RModel(cfg).init, jax.random.PRNGKey(0))
    rspecs = r_param_specs(shapes, cfg, rpol)
    flat = jax.tree_util.tree_flatten_with_path(
        rspecs, is_leaf=lambda x: isinstance(x, P))[0]
    ref = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in kp): tuple(s) for kp, s in flat}

    tcfg = port_model_config(cfg)
    params = TModel(tcfg, device="meta").init(torch.Generator())
    tpol = ShardingPolicy(mesh)
    tpol.axis_map = _amap(tpol, fsdp)
    specs = param_specs(params, tcfg, tpol)
    leaves = dict(_port_paths(params))
    n = 0
    for path, spec in _port_paths(specs):
        rpath, stacked = _reference_path(path, cfg)
        want = ref[rpath][1:] if stacked else ref[rpath]
        assert spec == want, (name, path, spec, want)
        assert len(spec) == leaves[path].ndim
        n += 1
    assert n == len(leaves) > 0
    used = {ax for _, s in _port_paths(specs) for e in s
            for ax in ((e,) if isinstance(e, str) else e or ())}
    assert "model" in used
    assert ("data" in used) == fsdp or name in ("bert-base", "whisper-tiny")


def test_param_specs_replicate_resident_codes():
    from repro_torch.models import quantize_model_params
    from conftest import tiny_config
    cfg = port_model_config(tiny_config(get_config("gpt2-large")))
    params = quantize_model_params(
        TModel(cfg, device="cpu").init(torch.Generator().manual_seed(0)))
    specs = param_specs(params, cfg, ShardingPolicy(_fake_mesh(model=2)))
    assert specs["blocks"][0]["attn"]["wq"] == {"codes": (None, None),
                                                "scale": (None, None)}
    assert specs["embed"]["tok_emb"] == ("model", None)


# --------------------------------------------------------------- MeshSpec

def test_meshspec_forms_match_reference():
    for text in ("4", "model=4", "data=2,model=4", "data=2, model=2", ""):
        r, t = RMeshSpec.parse(text), MeshSpec.parse(text)
        assert t.axes == r.axes and t.describe() == r.describe()
        assert (t.n_devices, t.model_size, t.axis_names) == (
            r.n_devices, r.model_size, r.axis_names)
    for bad in ("model=x", "model=0"):
        with pytest.raises(ValueError):
            MeshSpec.parse(bad)
    with pytest.raises(ValueError, match="duplicate"):
        MeshSpec(axes=(("model", 2), ("model", 2)))
    assert hash(TExec(mesh=MeshSpec.parse("model=2"))) == hash(
        TExec(mesh=MeshSpec.parse("2")))


def test_meshspec_builds_cpu_and_explicit_meshes():
    spec = MeshSpec.parse("data=2,model=4")
    mesh = spec.build(kind="cpu")
    assert mesh.shape == {"data": 2, "model": 4}
    assert mesh.axis_devices("model") == [torch.device("cpu")] * 4
    assert spec.build(kind="cpu") is mesh  # cached per spec and kind
    ctx = spec.context(kind="cpu")
    assert (ctx.model_size, ctx.dp_size, ctx.present_dp_axes) == (4, 2,
                                                                  ("data",))
    explicit = MeshSpec.parse("model=3").build(["cpu"] * 3)
    assert MeshSpec.parse("model=3").build(kind="cpu") is explicit
    with pytest.raises(ValueError, match="takes 3 devices"):
        MeshSpec.parse("model=3").build(["cpu"] * 2)


def test_cuda_mesh_larger_than_the_process_raises(monkeypatch):
    from repro_torch.dist import sharding
    monkeypatch.setattr(sharding, "_BUILT_MESHES", {})  # this test's own
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="needs 4 devices but the process "
                       "has 2"):
        MeshSpec.parse("model=4").build()
    assert np.asarray(MeshSpec.parse("model=2").build().axis_devices(
        "model")).tolist() == [torch.device("cuda", 0),
                               torch.device("cuda", 1)]


def test_make_host_mesh_and_policy_context():
    """`make_host_mesh` names the reference's axes, and a `ShardingPolicy`
    over the built mesh (its default axis map from the mesh's own axes)
    places specs as the reference's policy over a mesh of that shape."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(data=2, model=2, kind="cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 2, "model": 2}
    assert make_host_mesh(model=2, pod=2, kind="cpu").axis_names == (
        "pod", "data", "model")
    fake = _fake_mesh(data=2, model=2)
    for dims, names in (((8, 6), ("batch", "heads")),
                        ((6, 8), ("mlp", "vocab")),
                        ((3, 4), ("batch", "mlp"))):
        assert ShardingPolicy(mesh).spec_for(dims, names) == tuple(
            RPolicy(fake).spec_for(dims, names))
