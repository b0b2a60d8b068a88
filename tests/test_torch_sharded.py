"""Tensor-parallel attention of the port (`repro_torch.exec.sharded`): the
``raceit_fused_tp`` / ``raceit_gqa_tp`` backends against the port's own
single-device chain and against the reference's sharded backends.

* Against the port's chain: for MHA (8/8 heads) and GQA (16/8), on a
  ``model`` axis of 1, 2, 4 and 8 shards (every shard on the CPU, the
  kernels as their plain versions), every dataflow of the card's phase
  (causal and padded-bucket prefill, contiguous decode with per-row
  kv_len and a contiguous chunk step, paged decode and a paged chunk
  step) gives the no-mesh plan's output bit for bit, and every call
  launches the two kernel calls (probe and exact) on every shard.
* Against the reference: tests/_torch_sharded_child.py runs the
  reference's jitted TP backends on 8 simulated devices at model 2 and
  4, once per module. The resolved backends are the reference's; each
  shard's integer values (the codes and scale of every quantizer call,
  the exact call's int32 accumulator and cmax) are equal bit for bit;
  decode and chunk outputs are equal bit for bit, prefill outputs within
  4 ulp (the reference's own contract between its sharded and unsharded
  prefill: XLA re-associates the f32 epilogue inside shard_map).
* The protocol's pieces: the global scale equals the single-device
  quantizer's on the concatenated tensor, and the probe -> exact floor
  makes every shard's cmax the single-device call's.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_helpers  # noqa: E402,F401  (one torch thread a worker)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ExecConfig  # noqa: E402
from repro_torch.core.quant import quantize_tensor  # noqa: E402
from repro_torch.dist import MeshSpec  # noqa: E402
from repro_torch.exec import resolve_plan  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

from _torch_sharded_cases import (DATAFLOWS, OPS_CONFIGS,  # noqa: E402
                                  OPS_MESHES, PORT_MESHES, config_kw,
                                  ops_call, ops_inputs)

ROOT = Path(__file__).resolve().parent.parent
CHILD = ROOT / "tests" / "_torch_sharded_child.py"
PREFILL_ULP = 4


class _Child:
    """A running child; `result` waits for it and returns its npz."""

    def __init__(self, mode, out_dir):
        self.mode, self.path = mode, out_dir / f"{mode}.npz"
        self.log = open(out_dir / f"{mode}.log", "w+")
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env["PYTHONPATH"] = str(ROOT / "src")
        self.proc = subprocess.Popen(
            [sys.executable, str(CHILD), mode, str(self.path)], env=env,
            stdout=self.log, stderr=subprocess.STDOUT, text=True)

    def result(self):
        try:
            self.proc.wait(timeout=300)
        finally:
            self.stop()
        self.log.seek(0)
        text = self.log.read()
        assert "CHILD_OK" in text, (
            f"child {self.mode!r} failed:\n{text[-6000:]}")
        return dict(np.load(self.path))

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def start_child(mode, out_dir):
    """Start the reference's sharded paths in a child process (8
    simulated devices)."""
    return _Child(mode, out_dir)


def run_child(mode, out_dir):
    """Run the reference's sharded paths in a child process (8 simulated
    devices); returns its npz."""
    return start_child(mode, out_dir).result()


def _cfg(tag):
    return get_config("gpt2-large").replace(**config_kw(*OPS_CONFIGS[tag]))


def _plan(cfg, ms):
    mesh = None if ms == 0 else MeshSpec.parse(f"model={ms}")
    return resolve_plan(cfg, ExecConfig.serving(mesh=mesh))


def _port_inputs(tag):
    return {k: torch.from_numpy(v) for k, v in ops_inputs(tag).items()}


def _scale(cfg):
    return 1.0 / float(np.sqrt(cfg.resolved_head_dim))


class _Recorder:
    """Each shard's values of the port's tp_* calls, labelled in call
    order as the child labels the reference's."""

    def __init__(self, monkeypatch):
        self.records, self.n = {}, 0
        for name in ("tp_quantize_tensor", "tp_masked_prefix_quantize",
                     "tp_masked_page_quantize"):
            monkeypatch.setattr(kops, name, self._quant(getattr(kops, name)))
        monkeypatch.setattr(kops, "tp_exact_call",
                            self._exact(kops.tp_exact_call))

    def _label(self, kind):
        self.n += 1
        return f"{kind}{self.n - 1}"

    def _quant(self, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            lab = self._label("quant")
            self.records[f"{lab}/codes"] = np.stack(
                [q.codes.numpy() for q in out])
            self.records[f"{lab}/scale"] = np.stack(
                [q.scale.numpy() for q in out])
            return out
        return wrapped

    def _exact(self, fn):
        def wrapped(calls):
            out = fn(calls)
            lab = self._label("exact")
            self.records[f"{lab}/out32"] = np.stack([o.numpy() for o, _ in out])
            self.records[f"{lab}/cmax"] = np.stack([c.numpy() for _, c in out])
            return out
        return wrapped


def _ulp(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


# ---------------------------------------------- the port's own chain

@pytest.fixture(scope="module")
def single_device():
    """The no-mesh plan's output of every dataflow, per config."""
    out = {}
    for tag in OPS_CONFIGS:
        cfg = _cfg(tag)
        plan = _plan(cfg, 0)
        assert "tp" not in plan.backend("attention_decode")
        x = _port_inputs(tag)
        out[tag] = {n: ops_call(plan, n, x, _scale(cfg)) for n in DATAFLOWS}
    return out


@pytest.mark.parametrize("ms", PORT_MESHES)
@pytest.mark.parametrize("tag", list(OPS_CONFIGS))
def test_tp_equals_single_device_chain(tag, ms, single_device):
    cfg = _cfg(tag)
    plan = _plan(cfg, ms)
    if ms > 1:
        assert plan.backend("attention_prefill") == "raceit_fused_tp"
        assert plan.backend("attention_decode") == (
            "raceit_gqa_tp" if tag == "gqa" else "raceit_fused_tp")
    else:  # a 1-device mesh resolves to the single-device chain
        assert plan.backend("attention_decode") == _plan(cfg, 0).backend(
            "attention_decode")
    x = _port_inputs(tag)
    for name in DATAFLOWS:
        got = ops_call(plan, name, x, _scale(cfg))
        want = single_device[tag][name]
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got, want), (tag, ms, name)


def test_tp_runs_probe_and_exact_call_on_every_shard(monkeypatch):
    """Two kernel calls per shard: a probe at floor 0, then the exact call
    at the global floor, which is the single-device call's cmax."""
    seen = []
    real = kops.acam_attention_codes

    def counted(*a, cmax_floor=None, **k):
        out = real(*a, cmax_floor=cmax_floor, **k)
        seen.append((int(cmax_floor or 0), int(out[1])))
        return out
    monkeypatch.setattr(kops, "acam_attention_codes", counted)
    cfg = _cfg("mha")
    x = _port_inputs("mha")
    ops_call(_plan(cfg, 0), "paged_decode", x, _scale(cfg))
    (_, single), = seen
    seen.clear()
    ops_call(_plan(cfg, 4), "paged_decode", x, _scale(cfg))
    assert len(seen) == 8
    probes, exact = seen[:4], seen[4:]
    assert all(floor == 0 for floor, _ in probes)
    assert len({c for _, c in probes}) > 1  # the shards' maxima differ
    assert max(c for _, c in probes) == single
    assert all(floor == single and c == single for floor, c in exact)


@pytest.mark.parametrize("ms", [2, 4, 8])
def test_tp_quantizers_take_the_global_scale(ms):
    rng = np.random.default_rng(ms)
    x = torch.from_numpy(rng.standard_normal((2, 24, 8, 16)).astype(
        np.float32))
    x[1, 3, 5] *= 9.0  # the max sits in one shard only
    kvl = torch.tensor([17, 9], dtype=torch.int32)
    whole = quantize_tensor(x, bits=8)
    shards = kops.tp_quantize_tensor(list(x.chunk(ms, 2)))
    assert torch.equal(torch.cat([q.codes for q in shards], 2), whole.codes)
    assert all(torch.equal(q.scale, whole.scale) for q in shards)
    ref = kops.prefix_quantize_tensor(x, kvl, axis=1)
    tp = kops.tp_masked_prefix_quantize(list(x.chunk(ms, 2)), kvl, axis=1)
    assert torch.equal(torch.cat([q.codes for q in tp], 2), ref.codes)
    assert all(torch.equal(q.scale, ref.scale) and torch.equal(q.amax, ref.amax)
               for q in tp)
    pv = torch.tensor([0, 8, 3, 8, 1, 0, 5, 8, 8, 2, 0, 4], dtype=torch.int32)
    pool = x.reshape(12, 4, 8, 16)
    ref = kops.page_quantize_tensor(pool, pv)
    tp = kops.tp_masked_page_quantize(list(pool.chunk(ms, 2)), pv)
    assert torch.equal(torch.cat([q.codes for q in tp], 2), ref.codes)
    assert all(torch.equal(q.scale, ref.scale) for q in tp)


# ------------------------------------------------ against the reference

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_child("ops", tmp_path_factory.mktemp("tp_ops"))


@pytest.mark.parametrize("name", DATAFLOWS)
@pytest.mark.parametrize("ms", OPS_MESHES)
@pytest.mark.parametrize("tag", list(OPS_CONFIGS))
def test_tp_matches_the_reference_tp(tag, ms, name, reference, monkeypatch):
    cfg = _cfg(tag)
    plan = _plan(cfg, ms)
    assert list(reference[f"{tag}/m{ms}/backends"]) == [
        plan.backend("attention_prefill"), plan.backend("attention_decode")]
    rec = _Recorder(monkeypatch)
    got = ops_call(plan, name, _port_inputs(tag), _scale(cfg)).numpy()
    case = f"{tag}/m{ms}/{name}"
    want_keys = sorted(k[len(case) + 1:] for k in reference
                       if k.startswith(case + "/") and not k.endswith("/out"))
    assert sorted(rec.records) == want_keys
    for key in want_keys:
        want = reference[f"{case}/{key}"]
        have = rec.records[key].reshape(want.shape)
        assert have.dtype == want.dtype, key
        np.testing.assert_array_equal(have, want, err_msg=f"{case} {key}")
    want = reference[f"{case}/out"]
    assert got.shape == want.shape
    if name.startswith("prefill"):
        assert _ulp(got, want) <= PREFILL_ULP
    else:
        np.testing.assert_array_equal(got, want)
