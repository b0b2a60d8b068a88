"""The port's MoE FFN and serving under a mesh (`repro_torch.models.moe`,
`repro_torch.serve`, the launcher's ``--mesh``), every shard on the CPU.

* MoE against the reference's sharded `moe`: tests/_torch_sharded_child.py
  runs it jitted on 8 simulated devices (tiny mixtral with TP-in-expert at
  model=2; tiny llama4-scout with EP at model 2 and 4; a decode step, S=1,
  and a 16-token prefill; digital and raceit; capacity factor 1.25, so
  choices drop). Each shard's routing (expert ids, kept choices, dispatch
  slots, capacity) equals the reference shard's exactly, its renormalized
  gates to 1e-6 (each framework's float32 router product feeds them; on
  the same logits tests/test_torch_moe.py holds them bit for bit); the
  outputs agree to 1e-5 of the largest output, the
  tolerance of tests/test_torch_moe.py (float32 products reduce in other
  orders, and the TP partials are summed by the reference's psum).
* The soak of tests/_sharded_parity_child.py on the port: `generate` at
  model=4 gives the no-mesh engine's tokens (MHA and GQA), and three
  mixed-length paged `ContinuousBatcher` traces at model=4 give the
  no-mesh batcher's tokens, with the pool invariants held after every
  step; the summary names the mesh and a ``_tp`` decode backend, and a
  no-mesh batcher's has no mesh.
* MoE serving: tiny llama4-scout paged at model=2 (EP and
  ``raceit_gqa_tp``) in digital mode with no drops gives the no-mesh
  tokens.
* The launcher: ``--device cpu --mesh model=2`` serves with the TP plan
  and the no-mesh tokens; a CUDA mesh larger than the process's cards
  raises before any weight is made.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro_torch.configs.base import ExecConfig  # noqa: E402
from repro_torch.dist import MeshSpec  # noqa: E402
from repro_torch.exec import resolve_plan  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.serve import (ContinuousBatcher, GenerationEngine,  # noqa: E402
                               Request)

from _torch_helpers import port_model_config  # noqa: E402
from _torch_sharded_cases import (MOE_CASES, MOE_CF, MOE_MODES,  # noqa: E402
                                  OPS_CONFIGS, config_kw, moe_inputs)
from conftest import tiny_config  # noqa: E402
from test_torch_sharded import run_child  # noqa: E402

TOL = 1e-5  # tests/test_torch_moe.py's, relative to the largest output
# the gates are renormalized probabilities of float32 router logits, which
# XLA's and torch's CPU matmuls sum in other orders (a few ulp of 1.0)
GATE_TOL = 1e-6


def _exec(mode, mesh=None):
    mesh = None if mesh is None else MeshSpec.parse(mesh)
    if mode == "raceit":
        return ExecConfig.serving(mode="raceit", mesh=mesh)
    return ExecConfig(mode="digital", mesh=mesh)


# -------------------------------------------------------------------- MoE

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_child("moe", tmp_path_factory.mktemp("tp_moe"))


@pytest.mark.parametrize("mode", MOE_MODES)
@pytest.mark.parametrize("index", range(len(MOE_CASES)),
                         ids=[c[0] for c in MOE_CASES])
def test_moe_under_a_mesh_matches_reference(index, mode, reference,
                                            monkeypatch):
    tag, name, ms, b, s = MOE_CASES[index]
    cfg = port_model_config(tiny_config(get_config(name)).replace(
        capacity_factor=MOE_CF))
    x, p = moe_inputs(index, b, s, cfg.d_model, cfg.n_experts, cfg.d_ff,
                      cfg.glu)
    routes = []
    real = TM.route

    def recorded(*a, **k):
        routes.append(real(*a, **k))
        return routes[-1]
    monkeypatch.setattr(TM, "route", recorded)
    plan = resolve_plan(cfg, _exec(mode, f"model={ms}"))
    got = TM.moe({k: torch.from_numpy(v) for k, v in p.items()},
                 torch.from_numpy(x), cfg, plan).numpy()
    case = f"{tag}/{mode}"
    assert len(routes) == ms == reference[f"{case}/route/expert"].shape[0]
    for i, r in enumerate(routes):
        want = {k: reference[f"{case}/route/{k}"][i]
                for k in ("expert", "gate", "keep", "slot", "C")}
        np.testing.assert_array_equal(r.expert.numpy(), want["expert"])
        # gates come from each framework's float router product
        np.testing.assert_allclose(r.gate.numpy(), want["gate"], rtol=0,
                                   atol=GATE_TOL)
        np.testing.assert_array_equal(r.keep.numpy(), want["keep"])
        np.testing.assert_array_equal(r.slot.numpy(), want["slot"])
        assert r.C == int(want["C"])
    if s > 1 and cfg.expert_parallel:  # each shard routes its own tokens
        assert not np.array_equal(routes[0].expert.numpy(),
                                  routes[1].expert.numpy())
    if s > 1:  # the prefills crowd experts past their capacity
        assert any((~r.keep).any() for r in routes)
    want = reference[f"{case}/out"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("data", [1, 2])
def test_moe_data_axis_splits_the_batch(data):
    """``data`` routes each half of the batch on its own (its own
    capacity), as the reference's batch_spec does: the halves equal the
    meshless layer on each half; a batch that does not divide stays
    whole."""
    cfg = port_model_config(tiny_config(get_config(
        "llama4-scout-17b-a16e")).replace(capacity_factor=MOE_CF))
    x, p = moe_inputs(0, 4, 16, cfg.d_model, cfg.n_experts, cfg.d_ff, cfg.glu)
    p = {k: torch.from_numpy(v) for k, v in p.items()}
    x = torch.from_numpy(x)
    plan = resolve_plan(cfg, _exec("digital", f"data={data},model=2"))
    one = resolve_plan(cfg, _exec("digital", "model=2"))
    got = TM.moe(p, x, cfg, plan)
    want = torch.cat([TM.moe(p, xb, cfg, one) for xb in x.chunk(data, 0)])
    assert torch.equal(got, want)
    odd = TM.moe(p, x[:3], cfg, plan)
    assert torch.equal(odd, TM.moe(p, x[:3], cfg, one))


# ------------------------------------------------------------------ soak

def _tp_cfg(tag):
    return port_model_config(get_config("gpt2-large").replace(
        **config_kw(*OPS_CONFIGS[tag])))


def _engines(cfg, meshes, max_len, mode="raceit"):
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    return {m: GenerationEngine(cfg, params, exec_cfg=_exec(mode, m),
                                max_len=max_len, device="cpu")
            for m in meshes}


@pytest.mark.parametrize("tag", list(OPS_CONFIGS))
def test_generate_on_model4_gives_the_no_mesh_tokens(tag):
    engines = _engines(_tp_cfg(tag), (None, "model=4"), 32)
    assert engines["model=4"].plan.backend("attention_decode").endswith("_tp")
    assert engines["model=4"].exec_cfg.mesh.model_size == 4
    prompts = np.random.default_rng(11).integers(0, 256, (2, 12))
    ref = engines[None].generate(prompts, n_new=6)
    np.testing.assert_array_equal(engines["model=4"].generate(prompts, 6), ref)


def _trace(eng, seed, page_size=8, n_slots=3, n_pages=13):
    cb = ContinuousBatcher(eng, n_slots=n_slots, page_size=page_size,
                           n_pages=n_pages)
    assert cb.paged
    rng = np.random.default_rng(seed)
    for rid in range(int(rng.integers(3, 6))):
        L = int(rng.integers(1, 3 * page_size))
        prompt = np.random.default_rng(1000 + L).integers(
            0, eng.cfg.vocab_size, size=L).tolist()
        cb.submit(Request(rid, prompt, n_new=int(rng.integers(1, 5))))
    steps = 0
    while cb.queue or any(s is not None for s in cb.slots):
        cb.step()
        steps += 1
        assert steps < 500, "soak trace failed to drain"
        cb.allocator.assert_invariants()
    return cb, {rid: [int(t) for t in r.result] for rid, r in cb.done.items()}


@pytest.mark.parametrize("seed", range(3))
def test_paged_soak_on_model4_gives_the_no_mesh_tokens(seed):
    engines = _engines(_tp_cfg("gqa"), (None, "model=4"), 64)
    cb_ref, ref = _trace(engines[None], seed)
    cb_tp, out = _trace(engines["model=4"], seed)
    assert out == ref and len(ref) >= 3
    s = cb_tp.summary()
    assert s["mesh"] == "model=4" and s["decode_backend"] == "raceit_gqa_tp"
    assert "mesh" not in cb_ref.summary()


def test_moe_paged_serving_on_model2_gives_the_no_mesh_tokens():
    cfg = port_model_config(tiny_config(get_config("llama4-scout-17b-a16e")))
    engines = _engines(cfg, (None, "model=2"), 64, mode="digital")
    _, ref = _trace(engines[None], 0)
    cb, out = _trace(engines["model=2"], 0)
    assert out == ref
    assert cb.summary()["mesh"] == "model=2"
    assert cfg.expert_parallel and engines["model=2"].exec_cfg.mesh.model_size == 2


def test_moe_paged_raceit_serving_on_model2_runs_the_tp_backends():
    """raceit_q8-style serving of tiny llama4-scout at model=2: the GQA TP
    decode and EP layers drain the trace (tokens are counted, not held:
    with EP the capacity is per shard, as in the reference)."""
    cfg = port_model_config(tiny_config(get_config("llama4-scout-17b-a16e")))
    engines = _engines(cfg, (None, "model=2"), 64)
    assert engines["model=2"].plan.backend("attention_decode") == \
        "raceit_gqa_tp"
    _, ref = _trace(engines[None], 1)
    _, out = _trace(engines["model=2"], 1)
    assert sorted(out) == sorted(ref)
    assert all(len(out[r]) == len(ref[r]) for r in ref)


# -------------------------------------------------------------- launcher

def test_launcher_serves_with_mesh_on_cpu(capsys):
    from repro_torch.launch.serve import main
    argv = ["--arch", "gpt2-large", "--mode", "raceit_q8", "--device", "cpu",
            "--continuous", "--page-size", "8", "--requests", "3",
            "--n-new", "4", "--set", "n_layers=2", "d_model=64", "n_heads=4",
            "n_kv_heads=4", "d_ff=128", "vocab_size=256"]
    ref = main(argv)
    capsys.readouterr()
    out = main(argv + ["--mesh", "model=2"])
    text = capsys.readouterr().out
    assert "[serve] device mesh: model=2 (2 devices)" in text
    assert "attention_decode  -> raceit_fused_tp" in text
    assert {r: d.result.tolist() for r, d in out.items()} == {
        r: d.result.tolist() for r, d in ref.items()}


def test_launcher_refuses_a_cuda_mesh_larger_than_the_cards(monkeypatch):
    """On the card a mesh takes one card a position: the launcher stops
    before it makes any weight when the process has fewer (the count is
    mocked here, where there is no card)."""
    from repro_torch.dist import sharding
    from repro_torch.launch.serve import main
    monkeypatch.setattr(sharding, "_BUILT_MESHES", {})  # this test's own
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 devices but the process "
                       "has 1 CUDA device"):
        main(["--arch", "gpt2-large", "--mesh", "model=2"])
