"""Tensor- and sequence-parallel compute of the port's train step over the
``model`` axis (`repro_torch.dist.tp`, `Model(..., mesh_ctx=...)`), every
position on the CPU and kept apart (the distinct-card layout).

* (a) For each case of tests/_torch_tp_cases.py (tiny gpt2-large,
  command-r-35b, gemma3-4b, mixtral-8x22b, mamba2-130m, jamba, bert-base,
  qwen2-vl-2b with (3, B, S) M-RoPE positions and whisper-tiny on
  data=2,model=2 or data=1,model=2; data replicas alone, data=2,model=1;
  the drop cases: KV heads not dividing model=4, a 15-token sequence, a
  vocab of 255, 3 SSM heads on 2 positions; 2 microbatches; remat
  ``dots`` through the MoE's EP body and ``full``): the port's mesh step's loss within ``LOSS_RTOL`` and each
  gradient leaf within 1e-4 max|g| + 1e-7 (the training tests' contract)
  of the reference's jitted value_and_grad under `use_policy` on the same
  mesh of simulated devices (`tests/_torch_sharded_child.py tp_train`),
  and of its unsharded one.
* (b) A recorder shows each position's products taking 1/M of the heads,
  FFN columns, vocab rows, SSM heads and (EP) experts, and no leaf that
  the placement splits over ``model`` is gathered whole.
* (f) ``launch.train --data 1 --model 2 --device cpu`` gives the no-mesh
  loss history within ``LOSS_RTOL``.
* The collectives' backwards are their duals (gradcheck), the mesh
  `forward` gives the whole logits, and a non-digital plan under the
  model axis raises.
"""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import Model as RModel  # noqa: E402
from repro_torch.dist import (MeshContext, MeshSpec,  # noqa: E402
                              place_model_params, tp)
from repro_torch.dist.sharding import Placed, _distinct_positions  # noqa: E402
from repro_torch.dist.sharding import unplace  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

from _torch_helpers import port_model_config, port_params  # noqa: E402
from _torch_tp_cases import TP_CASES, tp_batch, tp_config  # noqa: E402
from _torch_train_cases import LOSS_RTOL, assert_grads_close  # noqa: E402

HERE = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_train") / "ref.npz"
    proc = subprocess.run(
        [sys.executable, str(HERE / "_torch_sharded_child.py"), "tp_train",
         str(out)], capture_output=True, text=True, timeout=900)
    assert "CHILD_OK" in proc.stdout, proc.stdout[-3000:] + proc.stderr[-3000:]
    return dict(np.load(out))


def _ref_tree(ref, tag, rcfg, key):
    treedef = jax.tree.structure(jax.eval_shape(RModel(rcfg).init,
                                                jax.random.PRNGKey(0)))
    return jax.tree.unflatten(treedef, [ref[f"{tag}/{key}{i}"] for i in
                                        range(treedef.num_leaves)])


def _mesh(data, model):
    return MeshSpec.parse(f"data={data},model={model}").build(kind="cpu")


_PORT: dict = {}


def _port_step(ref, tag):
    """The port's mesh step on the case's weights and batch (once a case):
    (loss, whole gradient tree, port config)."""
    if tag not in _PORT:
        _, _, data, model, _, _, micro = TP_CASES[tag]
        rcfg = tp_config(tag)
        cfg = port_model_config(rcfg)
        params = port_params(_ref_tree(ref, tag, rcfg, "w"), rcfg)
        mesh = _mesh(data, model)
        with _distinct_positions():
            placed = place_model_params(params, cfg, mesh)
        grad_fn = trainer.make_grad_fn(Model(cfg, device="cpu"), micro,
                                       mesh=mesh)
        loss, grads = grad_fn(placed, tp_batch(tag, rcfg))
        _PORT[tag] = (float(loss), unplace(grads), cfg, rcfg)
    return _PORT[tag]


@pytest.mark.parametrize("tag", list(TP_CASES))
def test_tp_step_matches_the_reference_mesh_step(ref, tag):
    loss, grads, cfg, rcfg = _port_step(ref, tag)
    np.testing.assert_allclose(loss, float(ref[f"{tag}/mesh/loss"]),
                               rtol=LOSS_RTOL)
    assert_grads_close(grads, _ref_tree(ref, tag, rcfg, "mesh/g"), cfg)


@pytest.mark.parametrize("tag", list(TP_CASES))
def test_tp_step_matches_unsharded_value_and_grad(ref, tag):
    loss, grads, cfg, rcfg = _port_step(ref, tag)
    np.testing.assert_allclose(loss, float(ref[f"{tag}/flat/loss"]),
                               rtol=LOSS_RTOL)
    assert_grads_close(grads, _ref_tree(ref, tag, rcfg, "flat/g"), cfg)


# ---------------------------------------------------------------- (b)

def _recorded_step(tag, monkeypatch):
    """One port mesh step (fresh weights) with the recorder on and every
    whole gather of a placed leaf logged by its spec."""
    _, _, data, model, _, _, _ = TP_CASES[tag]
    rcfg = tp_config(tag)
    cfg = port_model_config(rcfg)
    net = Model(cfg, device="cpu")
    mesh = _mesh(data, model)
    with _distinct_positions():
        placed = place_model_params(
            net.init(torch.Generator().manual_seed(0)), cfg, mesh)
    whole = []
    real = Placed.gather

    def spy(self, device):
        whole.append(self.spec)
        return real(self, device)
    monkeypatch.setattr(Placed, "gather", spy)
    with tp.record() as log:
        trainer.value_and_grad(net, placed, tp_batch(tag, rcfg), mesh=mesh)
    return cfg, model, log, whole


def _shapes(log, name):
    """{position: set of weight shapes} of the products of ``name``."""
    out: dict = {}
    for m, n, shape in log:
        if n == name:
            out.setdefault(m, set()).add(shape)
    return out


@pytest.mark.parametrize("tag", ["gpt2", "command_r", "mixtral", "mamba2",
                                 "jamba", "bert", "qwen2_vl", "whisper",
                                 "kv_drop"])
def test_each_position_computes_its_share(tag, monkeypatch):
    cfg, M, log, whole = _recorded_step(tag, monkeypatch)
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    every = lambda shape: {m: {shape} for m in range(M)}
    if cfg.n_heads:
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        assert _shapes(log, "wq") == every((D, H // M, hd))
        assert _shapes(log, "wo") == every((H // M, hd, D))
        assert _shapes(log, "wk") == every(
            (D, KV // M, hd) if KV % M == 0 else (D, KV, hd))
    if "dense" in cfg.ffn_pattern:
        assert _shapes(log, "w1").get(0) >= {(D, F // M)}
        assert _shapes(log, "w2").get(M - 1) >= {(F // M, D)}
    if "moe" in cfg.ffn_pattern:
        E = cfg.n_experts
        want = (E // M, D, F) if cfg.expert_parallel else (E, D, F // M)
        assert all(want in s for s in _shapes(log, "w1").values())
        assert len(_shapes(log, "w1")) == M
    if cfg.ssm_state:
        d_in = cfg.d_inner
        assert _shapes(log, "w_x") == every((D, d_in // M))
        assert _shapes(log, "out_proj") == every((d_in // M, D))
    assert _shapes(log, "lm_head") == every(
        (V // M, D) if cfg.tie_embeddings else (D, V // M))
    split = [s for s in whole if any(
        "model" in ((e,) if isinstance(e, str) else tuple(e or ()))
        for e in s)]
    assert not split, split


# ---------------------------------------------------------------- (f)

def test_launcher_on_the_model_axis_follows_no_mesh(tmp_path):
    from repro_torch.launch import train as launch
    kw = dict(steps=3, batch=2, seq=16, device="cpu", log=lambda *a: None,
              overrides=dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                             head_dim=16, d_ff=128, vocab_size=256))
    _, _, flat = launch.train("command-r-35b", ckpt_dir=str(tmp_path / "a"),
                              **kw)
    with tp.record() as log:
        _, _, split = launch.train("command-r-35b", data=1, model=2,
                                   ckpt_dir=str(tmp_path / "b"), **kw)
    np.testing.assert_allclose([h["loss"] for h in split["history"]],
                               [h["loss"] for h in flat["history"]],
                               rtol=LOSS_RTOL)
    assert _shapes(log, "wq") == {0: {(64, 2, 16)}, 1: {(64, 2, 16)}}


# ---------------------------------------------------------- collectives

def _parts(shapes, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g, dtype=torch.float64,
                        requires_grad=True) for s in shapes]


@pytest.mark.parametrize("name", ["all_gather", "reduce_scatter",
                                  "all_reduce", "all_to_all", "send"])
def test_collective_backward_is_its_dual(name):
    """gradcheck: each collective's explicit backward is the true adjoint
    of its forward over the per-position lists."""
    fns = {
        "all_gather": (lambda *p: tp.all_gather(list(p), 1),
                       [(2, 3, 4), (2, 3, 4)]),
        "reduce_scatter": (lambda *p: tp.reduce_scatter(list(p), 1),
                           [(2, 4, 3), (2, 4, 3)]),
        "all_reduce": (lambda *p: tp.all_reduce(list(p)),
                       [(3, 2), (3, 2), (3, 2)]),
        "all_to_all": (lambda *p: tp.all_to_all(list(p), 0, 1),
                       [(4, 3, 2), (4, 3, 2)]),
        "send": (lambda x: tp.send(x, x.device), [(3, 4)]),
    }
    fn, shapes = fns[name]
    assert torch.autograd.gradcheck(fn, tuple(_parts(shapes)))


def test_mesh_forward_gives_the_whole_logits():
    rcfg = tp_config("gpt2")
    cfg = port_model_config(rcfg)
    batch = tp_batch("gpt2", rcfg)
    for V in (256, 255):
        c = cfg.replace(vocab_size=V)
        p = Model(c, device="cpu").init(torch.Generator().manual_seed(0))
        want = Model(c, device="cpu").forward(p, batch)
        mesh = _mesh(2, 2)
        got = Model(c, mesh_ctx=MeshContext(mesh)).forward(
            place_model_params(p, c, mesh), batch)
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_a_raceit_plan_under_the_model_axis_raises():
    from repro_torch.configs.base import ExecConfig
    cfg = port_model_config(tp_config("gpt2"))
    with pytest.raises(NotImplementedError, match="digital plan"):
        Model(cfg, ExecConfig.serving(mode="raceit"),
              mesh_ctx=MeshContext(_mesh(1, 2)))
