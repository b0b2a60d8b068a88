"""Data- and model-parallel training of the port on a mesh, every position
on the CPU (`repro_torch.train.trainer` with ``mesh=``, AdamW over
stripes, placed checkpoints, the launcher).

* Tiny gpt2-large, command-r-35b and mixtral-8x22b at data=2,model=2
  (their ``fsdp`` on), with and without 2 microbatches, on weights of the
  init's shapes drawn from a seed (remat off on both sides, which changes
  no number; the launcher's and the resume's tests below run it on): the
  mesh step's loss within 1e-6 and each gradient leaf within 1e-4 max|g|
  + 1e-7 of the reference's unsharded, jitted ``jax.value_and_grad``
  (the training tests' contract, `tests/_torch_train_cases.py`; with
  microbatches the mean of the reference's per-part values, as its train
  step takes it).
* 2 AdamW steps on the mesh against the port's no-mesh steps on the same
  weights and batches: losses within 1e-6; every parameter within
  ``PARAM_SHARE`` (a tenth) of the summed learning rate, the largest move
  the two runs' updates could differ by being twice it (the batch's split
  over replicas sums each gradient in another order). `global_norm` of a
  placed gradient tree equals the same tree's unplaced, bit for bit, on
  one device, and within 1e-6 with the positions kept apart.
* A mesh run's checkpoint restores whole in the no-mesh port and in the
  reference's `repro.ckpt.CheckpointManager`, bit for bit; a resume on
  data=1,model=2 from data=2,model=2 continues as the uninterrupted run
  does (the same tolerances).
* The launcher hands its initial state over to the loop (not held for
  the run).
"""
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ckpt import CheckpointManager as RMgr  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import Model as RModel  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.dist import MeshSpec, place_model_params, unplace  # noqa: E402
from repro_torch.dist.sharding import _distinct_positions  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import (TrainLoopConfig, optim,  # noqa: E402
                               run_training, trainer)

from _torch_helpers import port_model_config, port_params  # noqa: E402
from _torch_train_cases import (LOSS_RTOL, assert_grads_close,  # noqa: E402
                                batch_of)
from conftest import tiny_config  # noqa: E402

ARCHS = ["gpt2-large", "command-r-35b", "mixtral-8x22b"]
LR = 1e-3
PARAM_SHARE = 0.1  # of the summed learning rate


def _mesh(text="data=2,model=2"):
    return MeshSpec.parse(text).build(kind="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """Weights from a seed in the reference's layout, its jitted
    value_and_grad, the port's model and the same weights placed on
    data=2,model=2."""
    rcfg = tiny_config(get_config(request.param)).replace(fsdp=True,
                                                          remat="none")
    rm = RModel(rcfg)
    # weights of the init's shapes from numpy (the eager init costs more
    # than the comparison on one core); remat off, which changes no number
    rng = np.random.default_rng(0)
    rparams = jax.tree.map(
        lambda a: jnp.asarray((0.2 * rng.standard_normal(a.shape)
                               ).astype(a.dtype)),
        jax.eval_shape(rm.init, jax.random.PRNGKey(0)))
    vg = jax.jit(jax.value_and_grad(rm.loss_fn))
    cfg = port_model_config(rcfg)
    params = port_params(rparams, rcfg)
    return dict(rcfg=rcfg, rparams=rparams, vg=vg, cfg=cfg,
                model=Model(cfg, device="cpu"), params=params,
                placed=place_model_params(params, cfg, _mesh()))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_mesh_step_matches_the_reference(case, microbatches):
    batch = batch_of(case["cfg"], B=2 * microbatches, loss_mask=True)
    losses, grads = [], []
    for i in range(microbatches):  # the reference's per-part values
        part = {k: jnp.asarray(v[2 * i:2 * i + 2]) for k, v in batch.items()}
        l, g = case["vg"](case["rparams"], part)
        losses.append(float(l))
        grads.append(g)
    rg = jax.tree.map(lambda *g: sum(g) / microbatches, *grads)
    grad_fn = trainer.make_grad_fn(case["model"], microbatches,
                                   mesh=_mesh())
    loss, g = grad_fn(case["placed"], batch)
    np.testing.assert_allclose(float(loss), np.mean(losses), rtol=LOSS_RTOL)
    whole = unplace(g)
    assert_grads_close(whole, rg, case["cfg"])
    assert torch.equal(optim.global_norm(g), optim.global_norm(whole))
    if microbatches > 1:
        return
    with _distinct_positions():
        apart = place_model_params(case["params"], case["cfg"], _mesh())
    la, ga = grad_fn(apart, batch)
    np.testing.assert_allclose(float(la), float(loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(optim.global_norm(ga)),
                               float(optim.global_norm(g)), rtol=1e-6)
    assert_grads_close(unplace(ga), rg, case["cfg"])


def _steps(model, params, batches, mesh=None, microbatches=1):
    step = trainer.make_train_step(model, optim.AdamWConfig(lr=LR),
                                   microbatches=microbatches, mesh=mesh)
    opt_state = optim.adamw_init(params)
    losses = []
    for b in batches:
        params, opt_state, m = step(params, opt_state, b)
        losses.append(float(m["loss"]))
    return params, opt_state, losses


def _params_close(got, want, n_steps):
    tol = PARAM_SHARE * LR * n_steps
    for (path, a), (_, b) in zip(tree.leaves_with_paths(got),
                                 tree.leaves_with_paths(want)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert float((a - b).abs().max()) <= tol, path


@pytest.mark.parametrize("microbatches", [1, 2])
def test_two_adamw_steps_on_the_mesh_follow_no_mesh(case, microbatches):
    batches = [batch_of(case["cfg"], seed=s, B=4) for s in (1, 2)]
    p0, o0, l0 = _steps(case["model"], case["params"], batches,
                        microbatches=microbatches)
    p1, o1, l1 = _steps(case["model"], case["placed"], batches, _mesh(),
                        microbatches)
    np.testing.assert_allclose(l1, l0, rtol=LOSS_RTOL)
    _params_close(unplace(p1), p0, 2)
    leaf = tree.leaves(o1["mu"])[0]
    assert leaf.roots()[0].device == torch.device("cpu")  # with its stripe
    assert int(o1["step"]) == 2


def _loop(model, params, steps, ckpt_dir, mesh):
    data = SyntheticLM(vocab_size=model.cfg.vocab_size, seq_len=16,
                       global_batch=4, seed=3)
    step = trainer.make_train_step(model, optim.AdamWConfig(lr=LR),
                                   mesh=mesh)
    return run_training(step, params, optim.adamw_init(params), data,
                        TrainLoopConfig(steps=steps, ckpt_dir=str(ckpt_dir),
                                        ckpt_every=2, log_every=100),
                        log=lambda *a: None)


def test_mesh_checkpoint_restores_without_a_mesh_and_in_the_reference(
        tmp_path):
    cfg = port_model_config(tiny_config(get_config("command-r-35b")))
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    mesh = _mesh()
    p, o, _ = _loop(model, place_model_params(params, cfg, mesh), 2,
                    tmp_path, mesh)
    whole = unplace((p, o))
    template = tree.map(torch.zeros_like, whole)
    got, extra = CheckpointManager(tmp_path).restore(template)
    assert extra["step"] == 2
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(got),
                                                 tree.leaves(whole)))
    rtemplate = jax.tree.map(lambda t: jnp.zeros(tuple(t.shape),
                                                 np.asarray(t).dtype),
                             tree.map(lambda t: t.numpy(), whole))
    rgot, rextra = RMgr(tmp_path).restore(rtemplate)
    assert rextra["step"] == 2
    for a, b in zip(jax.tree.leaves(rgot), tree.leaves(whole)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # placed again under the template's layout: the elastic restore
    again, _ = CheckpointManager(tmp_path).restore(
        (place_model_params(params, cfg, _mesh("data=1,model=2")), o))
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(unplace(again)), tree.leaves(whole)))


def test_resume_on_another_mesh_continues_the_run(tmp_path):
    cfg = port_model_config(tiny_config(get_config("gpt2-large"))).replace(
        fsdp=True)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    big, small = _mesh(), _mesh("data=1,model=2")
    p_full, _, full = _loop(model, place_model_params(params, cfg, big), 4,
                            tmp_path / "full", big)
    _loop(model, place_model_params(params, cfg, big), 2, tmp_path / "res",
          big)
    p_res, o_res, res = _loop(model, place_model_params(params, cfg, small),
                              4, tmp_path / "res", small)
    assert res["final_step"] == 4 and len(res["history"]) == 2
    np.testing.assert_allclose([h["loss"] for h in res["history"]],
                               [h["loss"] for h in full["history"][2:]],
                               rtol=LOSS_RTOL)
    _params_close(unplace(p_res), unplace(p_full), 4)
    wq = p_res["blocks"][0]["attn"]["wq"]
    assert wq.mesh is small and wq.spec == (None, ("model", "data"), None)


def test_launcher_hands_its_initial_state_over(monkeypatch, tmp_path):
    from repro_torch.launch import train as launch
    alive = []
    real = run_training

    def spy(step, params, opt_state, *a, **kw):
        refs = [weakref.ref(x) for x in tree.leaves(params)]

        def counted(p, o, b):
            out = step(p, o, b)
            alive.append(sum(r() is not None for r in refs))
            return out
        box = [params, opt_state]
        del params, opt_state
        return real(counted, box.pop(0), box.pop(0), *a, **kw)
    monkeypatch.setattr("repro_torch.train.run_training", spy)
    launch.train("gpt2-large", steps=3, batch=2, seq=16, data=2,
                 ckpt_dir=str(tmp_path), device="cpu", log=lambda *a: None,
                 overrides=dict(n_layers=1, d_model=32, n_heads=2,
                                n_kv_heads=2, d_ff=64, vocab_size=64))
    assert alive[1:] == [0, 0]
