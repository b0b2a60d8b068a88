"""The port's checkpoint writer (`repro_torch.ckpt.CheckpointManager`) and
fault-tolerant loop (`repro_torch.train.run_training`):

* round trips bit for bit, bfloat16 and float8 leaves included; retention
  and asynchronous saves; an asynchronous save holds the tree as it was
  when `save` returned; a failed write raises;
* `restore(device=...)`: one device, or a tree of devices like the
  template;
* the reference's `CheckpointManager.restore` reads a port-written tree,
  and the port's reads a reference-written one;
* loop resume bit for bit on the CPU (10 steps against 5 + 5), the
  straggler flag, the metrics CSV and SIGTERM;
* a run that the reference's `run_training` started for 5 steps, carried
  across (`load_reference_training_checkpoint`) and resumed by the port to
  10, with losses within 1e-3 of the reference's uninterrupted 10.
"""
import csv
import json
import os
import signal

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ckpt import CheckpointManager as RMgr  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.data import SyntheticLM as RSyn  # noqa: E402
from repro.models import Model as RModel  # noqa: E402
from repro.train import optim as RO, run_training as r_run  # noqa: E402
from repro.train import TrainLoopConfig as RLoop, trainer as RT  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.ckpt import (CheckpointManager,  # noqa: E402
                              load_reference_training_checkpoint)
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import (TrainLoopConfig, optim,  # noqa: E402
                               run_training, trainer)

from _torch_helpers import port_model_config, port_params  # noqa: E402
from conftest import tiny_config  # noqa: E402


def _tree():
    return {"a": torch.arange(5.0),
            "b": {"c": torch.randn(2, 3, generator=torch.Generator()
                                   .manual_seed(0)).to(torch.bfloat16),
                  "f8": torch.tensor([0.5, -2.0, 448.0]).to(
                      torch.float8_e4m3fn)},
            "l": [torch.tensor(7, dtype=torch.int32),
                  torch.tensor([True, False])],
            "t": (torch.ones(4, dtype=torch.float16),)}


def _equal_trees(a, b):
    la, lb = tree.leaves_with_paths(a), tree.leaves_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert torch.equal(x.view(torch.uint8) if x.element_size() == 1
                           and x.is_floating_point() else x,
                           y.view(torch.uint8) if y.element_size() == 1
                           and y.is_floating_point() else y), p


def test_roundtrip_bit_for_bit(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    t = _tree()
    mgr.save(10, t, extra={"step": 10, "data_state": {"step": 3}})
    restored, extra = mgr.restore(t)
    assert extra == {"step": 10, "data_state": {"step": 3}}
    _equal_trees(restored, t)
    meta = json.loads((tmp_path / "step-10" / "meta.json").read_text())
    assert meta["dtypes"]["b/c"] == "bfloat16"
    assert meta["dtypes"]["b/f8"] == "float8_e4m3fn"
    assert meta["paths"] == ["a", "b/c", "b/f8", "l/0", "l/1", "t/0"]
    assert meta["treedef"] == ("{'a': *, 'b': {'c': *, 'f8': *}, "
                               "'l': [*, *], 't': (*,)}")
    with np.load(tmp_path / "step-10" / "leaves.npz") as z:
        assert z["b/c"].dtype == np.uint16 and z["b/f8"].dtype == np.uint8
    # a bare leaf is "_root"
    mgr.save(11, torch.arange(3))
    with np.load(tmp_path / "step-11" / "leaves.npz") as z:
        assert z.files == ["_root"]
    assert torch.equal(mgr.restore(torch.zeros(3, dtype=torch.int64))[0],
                       torch.arange(3))


def test_retention_and_async(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    t = {"w": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        mgr.save(s, t, block=False)
    mgr.wait()
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    assert not list(tmp_path.glob("tmp-*"))


def test_async_save_holds_the_tree_as_it_was(tmp_path, monkeypatch):
    """The leaves are copied before `save` returns: an in-place update made
    while the write is in flight does not reach the checkpoint."""
    import threading
    gate = threading.Event()
    real = np.savez

    def slow_savez(*a, **k):
        gate.wait(10)
        return real(*a, **k)
    monkeypatch.setattr(np, "savez", slow_savez)
    mgr = CheckpointManager(tmp_path)
    w = torch.arange(6.0)
    mgr.save(1, {"w": w}, block=False)
    w.add_(100.0)  # the caller's next step writes in place
    gate.set()
    mgr.wait()
    restored, _ = mgr.restore({"w": w})
    assert torch.equal(restored["w"], torch.arange(6.0))


def test_failed_write_raises(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(np, "savez", broken)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": torch.ones(2)}, block=False)
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.wait()
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.save(2, {"w": torch.ones(2)})
    assert mgr.steps() == []


def test_restore_onto_devices(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = {"a": torch.ones(2), "b": [torch.zeros(3), torch.arange(2)]}
    mgr.save(1, t)
    on_meta, _ = mgr.restore(t, device="meta")
    assert all(x.device.type == "meta" for x in tree.leaves(on_meta))
    placed, _ = mgr.restore(t, device={"a": "cpu", "b": ["meta", "cpu"]})
    assert [x.device.type for x in tree.leaves(placed)] == ["cpu", "meta",
                                                             "cpu"]
    assert torch.equal(placed["b"][1], torch.arange(2))
    with pytest.raises(ValueError, match="devices"):
        mgr.restore(t, device={"a": "cpu"})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(t)


def test_reference_reads_port_and_port_reads_reference(tmp_path):
    t = _tree()
    del t["b"]["f8"]  # the reference restores float8 too, not needed here
    CheckpointManager(tmp_path / "port").save(3, t, extra={"step": 3})
    template = {"a": jnp.zeros(5), "b": {"c": jnp.zeros((2, 3),
                                                         jnp.bfloat16)},
                "l": [jnp.zeros((), jnp.int32), jnp.zeros(2, bool)],
                "t": (jnp.zeros(4, jnp.float16),)}
    restored, extra = RMgr(tmp_path / "port").restore(template)
    assert extra == {"step": 3}
    for x, y in zip(jax.tree.leaves(restored), tree.leaves(t)):
        if y.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                np.asarray(x).view(np.uint16),
                y.view(torch.int16).numpy().view(np.uint16))
        else:
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    # the reverse: a reference-written tree into the port's template
    ref_tree = {"w": jnp.arange(4.0), "b": {"c": jnp.asarray(
        np.linspace(-3, 3, 6, dtype=np.float32).reshape(2, 3)).astype(
            jnp.bfloat16)}}
    RMgr(tmp_path / "ref").save(5, ref_tree, extra={"step": 5})
    tmpl = {"w": torch.zeros(4), "b": {"c": torch.zeros(
        2, 3, dtype=torch.bfloat16)}}
    got, extra = CheckpointManager(tmp_path / "ref").restore(tmpl)
    assert extra == {"step": 5}
    np.testing.assert_array_equal(got["w"].numpy(), np.arange(4.0))
    np.testing.assert_array_equal(
        got["b"]["c"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(ref_tree["b"]["c"]).view(np.uint16))
    assert np.asarray(ref_tree["b"]["c"]).dtype == ml_dtypes.bfloat16


# ---------------------------------------------------------------- the loop

def _tiny_olmo():
    return port_model_config(tiny_config(get_config("olmo-1b")))


def _train_to(steps, ckpt_dir, model, params, opt, **kw):
    data = SyntheticLM(vocab_size=model.cfg.vocab_size, seq_len=16,
                       global_batch=2, seed=7)
    step = trainer.make_train_step(model, optim.AdamWConfig(lr=1e-3))
    lc = TrainLoopConfig(steps=steps, ckpt_dir=str(ckpt_dir), ckpt_every=5,
                         log_every=100, **kw)
    return run_training(step, params, opt, data, lc, log=lambda *a: None)


def test_loop_resume_bit_for_bit(tmp_path):
    model = Model(_tiny_olmo(), device="cpu")
    params0 = model.init(torch.Generator().manual_seed(0))
    opt0 = optim.adamw_init(params0)
    p_full, o_full, out_full = _train_to(10, tmp_path / "full", model,
                                         params0, opt0)
    _, _, out_half = _train_to(5, tmp_path / "resume", model, params0, opt0)
    logs = []
    data = SyntheticLM(vocab_size=model.cfg.vocab_size, seq_len=16,
                       global_batch=2, seed=7)
    p_res, o_res, out_res = run_training(
        trainer.make_train_step(model, optim.AdamWConfig(lr=1e-3)),
        params0, opt0, data,
        TrainLoopConfig(steps=10, ckpt_dir=str(tmp_path / "resume"),
                        ckpt_every=5, log_every=100), log=logs.append)
    assert logs == ["[loop] resumed from step 5"]
    assert out_half["final_step"] == 5 and out_res["final_step"] == 10
    assert [h["loss"] for h in out_res["history"]] == [
        h["loss"] for h in out_full["history"][5:]]
    _equal_trees((p_res, o_res), (p_full, o_full))
    assert data.state() == {"step": 10, "seed": 7}


class _FakeData:
    def __init__(self):
        self.step = 0

    def next_batch(self):
        self.step += 1
        return {}

    def state(self):
        return {"step": self.step}

    def set_state(self, st):
        self.step = st["step"]


def test_stragglers_metrics_csv_and_sigterm(tmp_path, monkeypatch):
    import time

    def step_fn(p, o, b):
        return p, o, {"loss": torch.tensor(1.0), "lr": torch.tensor(0.5)}

    # by this clock every step takes 1 s but the 12th, 4 s: more than 3
    # times the median of the 11 before it
    times = [1.0] * 11 + [4.0] + [1.0] * 3
    clock = iter(np.cumsum([0.0] + [x for t in times for x in (t, 0.0)]))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
    p = {"w": torch.zeros(2)}
    cfg = TrainLoopConfig(steps=15, ckpt_dir=str(tmp_path / "c"),
                          ckpt_every=100, metrics_path=str(tmp_path / "m" /
                                                          "metrics.csv"))
    _, _, out = run_training(step_fn, p, {"s": torch.zeros(())}, _FakeData(),
                             cfg, log=lambda *a: None)
    flags = [h["straggler"] for h in out["history"]]
    assert out["stragglers"] == 1 and flags.index(True) == 11
    rows = list(csv.reader(open(tmp_path / "m" / "metrics.csv")))
    assert len(rows) == 15 and rows[11][-1] == "True"
    assert rows[0][:2] == ["1", "1.0"] and rows[0][3] == "0.5"

    # SIGTERM during step 3: the loop stops after it and checkpoints
    clock = iter(range(1000))

    def killed(p, o, b):
        if b["n"] == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return p, o, {"loss": torch.tensor(0.0)}
    data = _FakeData()
    before = signal.getsignal(signal.SIGTERM)
    _, _, out = run_training(killed, p, {}, data,
                             TrainLoopConfig(steps=10, ckpt_dir=str(
                                 tmp_path / "k"), ckpt_every=100),
                             make_batch=lambda b: {"n": data.step},
                             log=lambda *a: None)
    assert out["final_step"] == 3
    assert CheckpointManager(tmp_path / "k").steps() == [3]
    assert signal.getsignal(signal.SIGTERM) is before


def test_port_resumes_a_reference_run(tmp_path):
    """The reference trains 5 steps and checkpoints; the port carries its
    params, AdamW state and data state across and trains on to 10."""
    cfg = tiny_config(get_config("olmo-1b"))
    rm = RModel(cfg)
    rp0 = rm.init(jax.random.PRNGKey(0))
    rstep = jax.jit(RT.make_train_step(rm, RO.AdamWConfig(lr=1e-3)))

    def ref_to(steps, d):
        data = RSyn(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
                    seed=7)
        return r_run(rstep, rp0, RO.adamw_init(rp0), data,
                     RLoop(steps=steps, ckpt_dir=str(d), ckpt_every=5,
                           log_every=100),
                     make_batch=lambda b: {k: jnp.asarray(v)
                                           for k, v in b.items()},
                     log=lambda *a: None)
    _, _, ref_full = ref_to(10, tmp_path / "ref_full")
    rp5, ro5, _ = ref_to(5, tmp_path / "ref_half")

    pcfg = port_model_config(cfg)
    params, opt, extra = load_reference_training_checkpoint(
        tmp_path / "ref_half", pcfg, device="cpu")
    assert extra["step"] == 5 and extra["data_state"]["step"] == 5
    assert int(opt["step"]) == 5 and opt["step"].dtype == torch.int32
    # the carry is exact
    for a, b in zip(tree.leaves(params), tree.leaves(port_params(rp5, cfg))):
        assert torch.equal(a, b)
    for a, b in zip(tree.leaves(opt["mu"]),
                    tree.leaves(port_params(ro5["mu"], cfg))):
        assert torch.equal(a, b)

    port_dir = tmp_path / "port"
    CheckpointManager(port_dir).save(extra["step"], (params, opt),
                                     extra=extra)
    model = Model(pcfg, device="cpu")
    fresh = model.init(torch.Generator().manual_seed(1))
    _, _, out = _train_to(10, port_dir, model, fresh,
                          optim.adamw_init(fresh))
    assert out["final_step"] == 10 and len(out["history"]) == 5
    np.testing.assert_allclose([h["loss"] for h in out["history"]],
                               [h["loss"] for h in ref_full["history"][5:]],
                               rtol=1e-3)
