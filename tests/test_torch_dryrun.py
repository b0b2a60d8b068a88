"""The port's dry-run against the reference's (`repro_torch.launch`:
mesh, inputs, dryrun).

* `valid_cells` is the reference's grid and skips.
* `model_flops` is the reference's float for every catalog model x shape
  at full config (parameters made on ``meta`` and by ``jax.eval_shape``).
* `input_specs`: every leaf's global shape, dtype, PartitionSpec and
  per-device shard shape, digital and ``quantize=True``, for train,
  prefill and decode cells, equals the reference's on the reference's own
  test meshes, (4, 2) and (2, 2, 2) simulated devices, computed in a child
  process (tests/_torch_dryrun_child.py, ``eval_shape`` only); the port's
  stand-ins sit on ``meta``. A stacked reference leaf is compared per
  layer, its leading layer dimension dropped.
* The production mesh and the card's constants; a few full-width
  `run_cell`s on meta (nothing allocated) return ``status ok`` with the
  memory, fit and roofline keys.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import SHAPES as R_SHAPES  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import Model as RModel  # noqa: E402
from repro_torch.configs import SHAPES  # noqa: E402
from repro_torch.configs.base import ExecConfig  # noqa: E402
from repro_torch.configs.catalog import ASSIGNED, PAPER_OWN, PORTED  # noqa: E402
from repro_torch.launch import dryrun, inputs, mesh as lmesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.model import encoder_config  # noqa: E402

from _torch_helpers import port_model_config  # noqa: E402

HERE = Path(__file__).resolve().parent
CHILD = HERE / "_torch_dryrun_child.py"


def _reference_dryrun():
    """`repro.launch.dryrun`, imported without letting its module-level
    ``XLA_FLAGS`` (512 host devices) reach this process's JAX."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as rdr
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return rdr


def test_valid_cells_match_reference():
    assert dryrun.valid_cells() == _reference_dryrun().valid_cells()
    assert set(ASSIGNED) | set(PAPER_OWN) == set(PORTED)
    assert list(SHAPES) == list(R_SHAPES)
    for name, s in SHAPES.items():
        r = R_SHAPES[name]
        assert (s.seq_len, s.global_batch, s.kind) == (
            r.seq_len, r.global_batch, r.kind)


@pytest.mark.parametrize("name", PORTED)
def test_model_flops_match_reference(name):
    from repro.launch import inputs as rinputs
    cfg = get_config(name)
    rparams = jax.eval_shape(RModel(cfg).init, jax.random.PRNGKey(0))
    tcfg = port_model_config(cfg)
    params = Model(tcfg, device="meta").init(torch.Generator())
    for shp in SHAPES:
        want = rinputs.model_flops(cfg, rparams, R_SHAPES[shp])
        got = inputs.model_flops(tcfg, params, SHAPES[shp])
        assert got == want and isinstance(got, float), (name, shp)


# --------------------------------------------------------------- input_specs

@pytest.fixture(scope="module")
def reference_specs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "specs.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, str(CHILD), str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert "CHILD_OK" in run.stdout, run.stderr[-3000:]
    return json.loads(out.read_text())


def _stack_path(parts, cfg, n_layers):
    """A per-layer path (layer index first) -> the reference's stacked
    path and whether the leaf is stacked (one more leading dim)."""
    P_, t = cfg.block_period, int(parts[0])
    n_full = n_layers // P_
    if t < n_full * P_:
        return ["scan", str(t % P_)] + parts[1:], True
    return ["tail", str(t - n_full * P_)] + parts[1:], False


def _reference_path(kind, parts, cfg):
    """The port's leaf path in tree ``kind`` -> (the reference's, stacked);
    a resident weight's ``codes``/``scale`` are the reference's NamedTuple
    fields 0 and 1 (a norm's ``scale`` stays)."""
    if kind == "opt_state":
        if parts[0] == "step":
            return "step", False
        inner, stacked = _reference_path("params", parts[1:], cfg)
        return f"{parts[0]}/{inner}", stacked
    if kind == "params" and parts[0] in ("blocks", "encoder", "decoder"):
        if parts[0] == "decoder" or cfg.is_encoder_decoder:
            lcfg = encoder_config(cfg) if parts[0] == "encoder" else cfg
            n = (cfg.n_encoder_layers if parts[0] == "encoder"
                 else cfg.n_layers)
        else:
            lcfg, n = cfg, cfg.n_layers
        path, stacked = _stack_path(parts[1:], lcfg, n)
        return "/".join([parts[0]] + path), stacked
    if kind == "cache" and parts[0].isdigit():
        path, stacked = _stack_path(parts, cfg, cfg.n_layers)
        return "/".join(path), stacked
    return "/".join(parts), False


def _fake_mesh(mesh_name):
    axes = ((("pod", 2),) if mesh_name == "2x2x2" else ()) + (
        ("data", 4 if mesh_name == "4x2" else 2), ("model", 2))
    from repro_torch.dist import MeshSpec
    spec = MeshSpec(axes=axes)
    return spec.build(["meta"] * spec.n_devices)


def _norm(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.mark.parametrize("mesh_name", ["4x2", "2x2x2"])
def test_input_specs_match_reference(reference_specs, mesh_name):
    checked = 0
    for key, ref in reference_specs.items():
        m, arch, shp, quantize = key.split("|")
        if m != mesh_name:
            continue
        cfg = get_config(arch)
        tcfg = port_model_config(cfg)
        mesh = _fake_mesh(mesh_name)
        shape = SHAPES[shp]
        policy = inputs.make_policy(mesh, tcfg, shape)
        model = Model(tcfg, ExecConfig(), device="meta")
        spec = inputs.input_specs(tcfg, shape, policy, model,
                                  quantize=bool(int(quantize)))
        pairs = {"params": "param_specs", "opt_state": "ospecs",
                 "batch": "bspecs", "cache": "cspecs", "token": "tspec"}
        assert set(ref) - {"model_flops"} == {k for k in pairs if k in spec}
        for kind, skey in pairs.items():
            if kind not in spec:
                continue
            table = inputs.leaf_table(spec[kind], spec[skey], mesh.shape)
            seen = set()
            for path, leaf in table.items():
                parts = path.split("/")
                rpath, stacked = _reference_path(kind, parts, cfg)
                if rpath not in ref[kind] and parts[-1] in ("codes", "scale"):
                    parts[-1] = "0" if parts[-1] == "codes" else "1"
                    rpath, stacked = _reference_path(kind, parts, cfg)
                want = ref[kind][rpath]
                cut = 1 if stacked else 0
                got = (list(leaf["shape"]), leaf["dtype"],
                       _norm(leaf["spec"]), list(leaf["shard_shape"]))
                exp = (want["shape"][cut:], want["dtype"],
                       want["spec"][cut:], want["shard_shape"][cut:])
                assert got == exp, (key, kind, path, got, exp)
                seen.add(rpath)
                checked += 1
            assert seen == set(ref[kind]), (key, kind,
                                            set(ref[kind]) ^ seen)
        assert inputs.model_flops(tcfg, spec["params"], shape) == \
            ref["model_flops"], key
    assert checked > 1000


# ------------------------------------------------------------------ dry-run

def test_production_mesh_and_constants():
    single = lmesh.make_production_mesh()
    multi = lmesh.make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 32, "model": 8}
    assert multi.shape == {"pod": 2, "data": 32, "model": 8}
    assert {d.type for d in multi.devices.flat} == {"meta"}
    assert (lmesh.PEAK_BF16_FLOPS, lmesh.PEAK_INT8_OPS, lmesh.HBM_BW,
            lmesh.NVLINK_BW, lmesh.IB_BW, lmesh.HBM_BYTES) == (
        989e12, 1979e12, 3.35e12, 450e9, 50e9, 80e9)
    assert lmesh.AXIS_BW == {"model": 450e9, "data": 50e9, "pod": 50e9}


@pytest.mark.parametrize("arch,shape,mesh_kind,mode", [
    ("olmo-1b", "decode_32k", "single", "raceit_q8"),
    ("whisper-tiny", "prefill_32k", "multi", "raceit_q8"),
    ("mamba2-130m", "long_500k", "single", "digital"),
    ("olmo-1b", "train_4k", "multi", "raceit_q8"),
])
def test_run_cell_full_width_on_meta(arch, shape, mesh_kind, mode):
    before = torch.cuda.memory_allocated() if torch.cuda.is_available() else 0
    r = dryrun.run_cell(arch, shape, mesh_kind, mode)
    if mode == "raceit_q8" and SHAPES[shape].kind == "train":
        assert r["status"] == "skipped" and "int8" in r["reason"]
        return
    assert r["status"] == "ok", r
    mem, roof = r["memory"], r["roofline"]
    assert mem["per_device_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["fits_80GB"] == (mem["per_device_bytes"] < 80e9)
    for term in ("compute_s", "memory_s", "collective_s"):
        assert roof[term] >= 0
    assert roof["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert r["n_chips"] == (256 if mesh_kind == "single" else 512)
    assert r["ops"]["flops"] > 0 and r["model_flops_global"] > 0
    if mode == "raceit_q8" and arch == "olmo-1b":
        # the contiguous kernel's two passes, every layer
        cfg = get_config(arch)
        assert r["ops"]["kernel_launches"] == {
            "acam_attention": 2 * cfg.n_layers}
        assert mem["param_bytes"] < 2e9  # int8 codes, replicated
    if torch.cuda.is_available():
        assert torch.cuda.memory_allocated() == before


def test_cli_writes_cells(tmp_path):
    out = tmp_path / "dryrun.json"
    rc = dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                      "--mesh", "multi", "--mode", "raceit_q8",
                      "--out", str(out)])
    assert rc == 0
    res = json.loads(out.read_text())
    (key, r), = res.items()
    assert key == "whisper-tiny|decode_32k|multi|raceit_q8"
    assert r["status"] == "ok" and r["memory"]["fits_80GB"]
    assert r["ops"]["collective_by_axis"].keys() <= {"model", "data", "pod"}
