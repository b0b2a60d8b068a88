"""Serving from parameters placed on a data=2,model=2 mesh, every position
on the CPU (`repro_torch.serve.GenerationEngine` places the tree at load
under `param_specs`, with the FSDP axis map when the config sets
``fsdp``), held against the reference on the same weights.

* The weights are the reference's ``Model.init(PRNGKey(0))`` of tiny
  gpt2-large, command-r-35b and mixtral-8x22b with ``fsdp=True``, carried
  across as numpy arrays and quantized to resident int8 on each side
  (``raceit``: the ``raceit_*_tp`` backends; mixtral's MoE layers through
  the TP-in-expert body over the placed experts).
* The engine's tree is placed: float leaves in stripes over ``model`` and
  (FSDP) ``data``, resident int8 weights replicated, nothing copied on one
  device.
* Greedy tokens through `generate`, and those of mixed-length traces
  through `ContinuousBatcher` with the page-pool invariants held after
  every step (the reference soak's contract,
  tests/_sharded_parity_child.py), are bit-equal three ways: the port's
  mesh engine, the port's no-mesh engine, and the reference's. The
  reference's are its no-mesh engine's, in this process, and its FSDP
  engine's on a data=2,model=2 mesh of simulated devices, run by
  tests/_torch_sharded_child.py (``fsdp``). Mixtral's local layers have no
  paged form, so its traces run through the contiguous slot pool.
* The launcher serves ``--mesh data=2,model=2`` with the no-mesh tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ExecConfig as RExecConfig  # noqa: E402
from repro.models import Model as RModel  # noqa: E402
from repro.models.model import quantize_model_params as r_quantize  # noqa: E402
from repro.serve import ContinuousBatcher as RBatcher  # noqa: E402
from repro.serve import GenerationEngine as REngine  # noqa: E402
from repro.serve import Request as RRequest  # noqa: E402
from repro_torch.configs.base import ExecConfig  # noqa: E402
from repro_torch.dist import MeshSpec, Placed, is_placed  # noqa: E402
from repro_torch.models import quantize_model_params  # noqa: E402
from repro_torch.serve import (ContinuousBatcher, GenerationEngine,  # noqa: E402
                               Request)

from _torch_helpers import port_model_config, port_params  # noqa: E402
from _torch_sharded_cases import (FSDP_MAX_LEN, FSDP_MESH,  # noqa: E402
                                  FSDP_MODELS, FSDP_SEEDS, drive_trace,
                                  fsdp_batcher_kw, fsdp_prompts, fsdp_trace)
from conftest import tiny_config  # noqa: E402
from test_torch_sharded import start_child  # noqa: E402

MESH = FSDP_MESH


@pytest.fixture(scope="module", autouse=True)
def _reference_child(tmp_path_factory):
    """The reference's FSDP engine in a child process, started before the
    module's first test so that it runs beside the port's engines."""
    child = start_child("fsdp", tmp_path_factory.mktemp("fsdp"))
    yield child
    child.stop()


@pytest.fixture(scope="module")
def reference_fsdp(_reference_child):
    """The reference's FSDP engine's tokens on a data=2,model=2 mesh."""
    return _reference_child.result()


_ENGINES: dict = {}
_MESH_TOKENS: dict = {}


def _engines(name):
    """The port's engines with no mesh and on ``MESH`` (key None and
    ``MESH``), and the reference's no-mesh engine (key ``"reference"``),
    on the same resident int8 weights; cached."""
    if name not in _ENGINES:
        cfg = tiny_config(get_config(name)).replace(fsdp=True)
        p0 = RModel(cfg).init(jax.random.PRNGKey(0))
        params = quantize_model_params(port_params(p0, cfg))
        out = {m: GenerationEngine(
            port_model_config(cfg), params, exec_cfg=ExecConfig.serving(
                mode="raceit", mesh=None if m is None else MeshSpec.parse(m)),
            max_len=FSDP_MAX_LEN, device="cpu") for m in (None, MESH)}
        out["reference"] = REngine(cfg, r_quantize(p0),
                                   RExecConfig.serving(mode="raceit"),
                                   max_len=FSDP_MAX_LEN)
        _ENGINES[name] = out
    return _ENGINES[name]


@pytest.fixture(scope="module", params=FSDP_MODELS)
def engines(request):
    return _engines(request.param)


def _port_trace(eng, seed):
    paged = ContinuousBatcher.pageable_reason(eng) is None
    cb = ContinuousBatcher(eng, paged=paged, **fsdp_batcher_kw(paged))
    return cb, drive_trace(cb, fsdp_trace(seed, eng.cfg.vocab_size), Request)


def _mesh_tokens(name, what):
    """The port's mesh engine's tokens of ``"generate"``, or its batcher
    and tokens of ``("trace", seed)``; cached."""
    if (name, what) not in _MESH_TOKENS:
        eng = _engines(name)[MESH]
        _MESH_TOKENS[name, what] = (eng.generate(fsdp_prompts(), 6)
                                    if what == "generate"
                                    else _port_trace(eng, what[1]))
    return _MESH_TOKENS[name, what]


def test_the_engine_places_its_tree(engines):
    eng, ref = engines[MESH], engines[None]
    assert is_placed(eng.params) and not is_placed(ref.params)
    attn = eng.params["blocks"][0]
    assert attn["norm1"]["scale"].spec == (None,)
    wq = attn["attn"]["wq"]
    assert isinstance(wq, Placed) and wq.n_shards == 1  # codes replicate
    assert wq.gather("cpu").codes is ref.params["blocks"][0]["attn"][
        "wq"].codes  # one device: nothing copied
    if "moe" in attn:  # experts stay float, striped on d_ff
        assert attn["moe"]["w1"].spec == (None, None, ("model", "data"))
    tok = eng.params["embed"]["tok_emb"]
    assert tok.spec == (("model", "data"), None)
    assert tok.gather("cpu") is ref.params["embed"]["tok_emb"]
    assert eng.plan.backend("attention_decode").endswith("_tp")


def test_generate_gives_the_no_mesh_tokens(engines):
    name = engines["reference"].cfg.name
    np.testing.assert_array_equal(_mesh_tokens(name, "generate"),
                                  engines[None].generate(fsdp_prompts(), 6))


def test_generate_gives_the_reference_tokens(engines):
    name = engines["reference"].cfg.name
    ref = engines["reference"].generate(jnp.asarray(fsdp_prompts()), 6)
    np.testing.assert_array_equal(_mesh_tokens(name, "generate"),
                                  np.asarray(ref))


@pytest.mark.parametrize("seed", FSDP_SEEDS)
def test_continuous_batching_gives_the_no_mesh_tokens(engines, seed):
    name = engines["reference"].cfg.name
    cb_ref, ref = _port_trace(engines[None], seed)
    cb, out = _mesh_tokens(name, ("trace", seed))
    assert out == ref and len(ref) >= 3
    assert cb.paged == (engines[None].cfg.mixer_pattern != ("attn_local",))
    s = cb.summary()
    assert s["mesh"] == MESH and s["decode_backend"].endswith("_tp")


@pytest.mark.parametrize("seed", FSDP_SEEDS)
def test_continuous_batching_gives_the_reference_tokens(engines, seed):
    r = engines["reference"]
    cb, out = _mesh_tokens(r.cfg.name, ("trace", seed))
    rb = RBatcher(r, paged=cb.paged, **fsdp_batcher_kw(cb.paged))
    ref = drive_trace(rb, fsdp_trace(seed, r.cfg.vocab_size), RRequest)
    assert out == ref and len(ref) >= 3


def test_launcher_serves_on_a_fsdp_mesh(capsys):
    from repro_torch.launch.serve import main
    argv = ["--arch", "command-r-35b", "--mode", "raceit_q8", "--device",
            "cpu", "--continuous", "--page-size", "8", "--requests", "3",
            "--n-new", "4", "--set", "n_layers=2", "d_model=64",
            "n_heads=4", "n_kv_heads=2", "head_dim=16", "d_ff=128",
            "vocab_size=256"]
    ref = main(argv)
    capsys.readouterr()
    out = main(argv + ["--mesh", MESH])
    text = capsys.readouterr().out
    assert f"[serve] device mesh: {MESH} (4 devices)" in text
    assert {r: d.result.tolist() for r, d in out.items()} == {
        r: d.result.tolist() for r, d in ref.items()}


def test_the_reference_fsdp_engine_gives_the_port_tokens(reference_fsdp):
    """The port's mesh tokens against the reference's FSDP engine on
    data=2,model=2 (the child): `generate` and every trace, request by
    request."""
    for name in FSDP_MODELS:
        np.testing.assert_array_equal(_mesh_tokens(name, "generate"),
                                      reference_fsdp[f"{name}/generate"])
        for seed in FSDP_SEEDS:
            cb, out = _mesh_tokens(name, ("trace", seed))
            assert bool(reference_fsdp[f"{name}/paged"]) == cb.paged
            prefix = f"{name}/trace{seed}/"
            fsdp = {int(k[len(prefix):]): reference_fsdp[k].tolist()
                    for k in reference_fsdp if k.startswith(prefix)}
            assert out == fsdp, (name, seed)
