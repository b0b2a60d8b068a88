"""The Mixture-of-Experts FFN of the port (`repro_torch.models.moe`) against
the reference's `repro.models.moe`, at `tests/conftest.py` `tiny_config`
size (d_model 64, d_ff 128, 4 experts).

* Top-k: the port's stable descending sort gives `jax.lax.top_k`'s values
  and indices bit for bit on rows full of ties (k 1 and 2; 4, 8 and 16
  experts; all-equal rows), where `torch.topk` would pick other experts.
* The layer: `moe(..., mesh_ctx=None)` of the jitted reference and the
  port's `moe` on the same weights and inputs, in digital and raceit mode,
  at capacity factors 8.0 (no drops) and 1.25 (drops), with 1, 8 and 13
  tokens and top-k 1 (llama4-scout) and 2 (mixtral). The routing (expert
  ids, renormalized gates, kept choices, dispatch slots) is equal bit for
  bit (the digital softmax follows XLA's graph); the outputs agree to 1e-5
  of the largest output (float32 products reduce in other orders in XLA's
  and torch's CPU matmuls). Each raceit case holds at least 5%
  of its tokens tied at the k-th probability (the Fig.-8 softmax puts the
  router's probabilities on a coarse grid), so the tie order is exercised;
  each case at 1.25 with more than one token drops a choice.
* `quantize_model_params` leaves every ``moe`` subtree float, as the same
  tensor objects, and every other code is the reference's.
* The two configurations are the reference's field for field and in
  `PORTED`; their resolved plans print the reference's lines; a reference
  checkpoint of each crosses over (scan-stacked (R, E, D, F) experts, in
  float32 and bfloat16).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import CheckpointManager  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.configs.base import ExecConfig  # noqa: E402
from repro.exec import resolve_plan as r_resolve  # noqa: E402
from repro.models import Model as RModel  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.models.model import quantize_model_params as r_quantize  # noqa: E402
from repro_torch.ckpt import load_reference_checkpoint  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs.catalog import PORTED  # noqa: E402
from repro_torch.exec import resolve_plan as t_resolve  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.layers import QuantizedWeight  # noqa: E402
from repro_torch.models.model import quantize_model_params as t_quantize  # noqa: E402

from _torch_helpers import (port_exec_config, port_model_config,  # noqa: E402
                            port_params)
from conftest import tiny_config  # noqa: E402

MODELS = ("mixtral-8x22b", "llama4-scout-17b-a16e")
# float32 outputs, relative to the largest output: XLA's and torch's CPU
# matmuls sum in other orders
TOL = 1e-5
MIN_TIES = 0.05


def _exec(mode):
    return (ExecConfig.serving(mode="raceit") if mode == "raceit"
            else ExecConfig(mode="digital"))


# ------------------------------------------------------------------ top-k

def _tie_rows(rng, n_rows, E):
    """Rows of a few distinct values (ties everywhere), with all-equal
    rows, as the Fig.-8 softmax's coarse probabilities give them."""
    x = rng.integers(0, 3, (n_rows, E)).astype(np.float32) / 4
    x[:4] = 0.25          # all equal
    x[4, :] = 0.0
    x[4, -1] = 0.5        # one winner, the rest tied behind it
    return x


@pytest.mark.parametrize("E", [4, 8, 16])
@pytest.mark.parametrize("k", [1, 2])
def test_top_k_takes_jax_tie_order(k, E):
    x = _tie_rows(np.random.default_rng(E + k), 64, E)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = TM.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert (got_i[:4] == torch.arange(k)).all()  # all-equal: lowest first


def test_torch_topk_breaks_ties_otherwise():
    """The hazard the stable sort avoids: `torch.topk` picks other experts
    on a tie (its order is not specified; on this input it does)."""
    x = torch.tensor([[.1, .3, .3, .3, .2, .3, .1, .3]])
    assert TM.top_k(x, 2)[1].tolist() == [[1, 2]]
    assert torch.topk(x, 2).indices.tolist() != [[1, 2]]


# ------------------------------------------------------------------ layer

def _inputs(T, D, seed):
    """(1, T, D) activations: a direction every token shares (as a pool's
    pad rows share one state, they crowd the same experts) plus noise,
    at per-token scales from 0.02 (router logits inside one LOGIT step:
    every probability tied) to 1; the first token tied, so a 1-token call
    ties too."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.02, 1.0, (T, 1)).astype(np.float32)
    scale[0] = 0.02
    shared = rng.standard_normal((1, D)).astype(np.float32)
    z = rng.standard_normal((T, D)).astype(np.float32)
    return ((z + shared) * scale)[None]


def _cases():
    for name in MODELS:
        for mode in ("digital", "raceit"):
            for cf in (8.0, 1.25):
                for T in (1, 8, 13):
                    yield pytest.param(name, mode, cf, T,
                                       id=f"{name}-{mode}-cf{cf}-T{T}")


@pytest.mark.parametrize("name,mode,cf,T", list(_cases()))
def test_moe_layer_matches_reference(name, mode, cf, T):
    cfg = tiny_config(get_config(name)).replace(capacity_factor=cf)
    ec = _exec(mode)
    rplan = r_resolve(cfg, ec)
    p = RM.init_moe(jax.random.PRNGKey(T), cfg, jnp.float32)
    x = _inputs(T, cfg.d_model, seed=T)

    want = np.asarray(jax.jit(lambda p, x: RM.moe(p, x, cfg, rplan, None))(
        p, jnp.asarray(x)))
    # the reference's routing of the same logits, jitted as in the layer
    logits = np.asarray(jax.jit(
        lambda x, r: (x.astype(jnp.float32) @ r).astype(jnp.float32))(
            jnp.asarray(x.reshape(T, -1)), p["router"]))
    K, E = cfg.top_k, cfg.n_experts

    def r_route(logits):
        probs = rplan.softmax(logits, axis=-1)
        gate, expert = jax.lax.top_k(probs, K)
        gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
        C = max(1, int(-(-K * T * cfg.capacity_factor // E)))
        e_flat = expert.reshape(-1)
        order = jnp.argsort(e_flat, stable=True)
        sorted_e = e_flat[order]
        starts = jnp.searchsorted(sorted_e, jnp.arange(E), side="left")
        rank_sorted = jnp.arange(T * K, dtype=jnp.int32) - starts[sorted_e]
        rank = jnp.zeros((T * K,), jnp.int32).at[order].set(rank_sorted)
        keep = rank < C
        return gate, expert, keep, jnp.where(keep, e_flat * C + rank, E * C)
    rg, re_, rk, rs = (np.asarray(a) for a in jax.jit(r_route)(logits))

    tcfg = port_model_config(cfg)
    tplan = t_resolve(tcfg, port_exec_config(ec))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    got = TM.moe(tp, torch.from_numpy(x), tcfg, tplan).numpy()
    r = TM.route(torch.from_numpy(np.array(logits)), tcfg, tplan)
    np.testing.assert_array_equal(r.expert.numpy(), re_)
    np.testing.assert_array_equal(r.gate.numpy(), rg)
    np.testing.assert_array_equal(r.keep.numpy(), rk)
    np.testing.assert_array_equal(r.slot.numpy(), rs)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())

    if mode == "raceit":
        probs = np.sort(np.asarray(rplan.softmax(jnp.asarray(logits),
                                                 axis=-1)), -1)[:, ::-1]
        ties = np.mean(probs[:, K - 1] == probs[:, K])
        assert ties >= MIN_TIES, ties
    if cf == 1.25 and T > 1:
        assert not rk.all()  # some choice is dropped


def test_moe_layer_bf16_keeps_the_expert_weights(monkeypatch):
    """In bfloat16 the products run on the expert weights as they are (no
    copy), within a bfloat16 step of the reference's einsum."""
    cfg = tiny_config(get_config("mixtral-8x22b")).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    p = RM.init_moe(jax.random.PRNGKey(3), cfg, jnp.bfloat16)
    x = jnp.asarray(_inputs(8, cfg.d_model, seed=3)).astype(jnp.bfloat16)
    rplan = r_resolve(cfg, ExecConfig(mode="digital"))
    want = np.asarray(jax.jit(lambda p, x: RM.moe(p, x, cfg, rplan, None))(
        p, x).astype(jnp.float32))

    def bf16(a):
        return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
            torch.bfloat16)
    tp = {k: (torch.from_numpy(np.array(v)) if v.dtype == jnp.float32
              else bf16(v)) for k, v in p.items()}
    weights = {tp[k].data_ptr() for k in ("w1", "w2", "w3")}
    seen = []
    bmm = torch.bmm
    monkeypatch.setattr(torch, "bmm", lambda a, w: seen.append(
        w.data_ptr()) or bmm(a, w))
    tcfg = port_model_config(cfg)
    got = TM.moe(tp, bf16(x), tcfg, t_resolve(tcfg, ExecConfig(mode="digital")))
    assert got.dtype == torch.bfloat16
    assert len(seen) == 3 and set(seen) == weights
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -6 * np.abs(want).max())


# --------------------------------------------------------------- quantize

@pytest.mark.parametrize("name", MODELS)
def test_quantize_keeps_moe_float(name):
    cfg = tiny_config(get_config(name))
    p0 = RModel(cfg).init(jax.random.PRNGKey(1))
    tparams = port_params(p0, cfg)
    q = t_quantize(tparams)
    rq = r_quantize(p0)
    for layer, qlayer in zip(tparams["blocks"], q["blocks"]):
        assert qlayer["moe"] is layer["moe"]
        for leaf in ("router", "w1", "w2", "w3"):
            assert qlayer["moe"][leaf] is layer["moe"][leaf]
            assert qlayer["moe"][leaf].dtype == torch.float32
    # every other weight: the reference's codes and scales bit for bit
    stack = rq["blocks"]["scan"][0]
    assert stack["moe"] is p0["blocks"]["scan"][0]["moe"]  # float there too
    for i, qlayer in enumerate(q["blocks"]):
        for leaf in ("wq", "wk", "wv", "wo"):
            got, want = qlayer["attn"][leaf], stack["attn"][leaf]
            assert isinstance(got, QuantizedWeight)
            np.testing.assert_array_equal(got.codes.numpy(),
                                          np.asarray(want.codes)[i])
            np.testing.assert_array_equal(got.scale.numpy(),
                                          np.asarray(want.scale)[i])
    np.testing.assert_array_equal(q["embed"]["unembed"].codes.numpy(),
                                  np.asarray(rq["embed"]["unembed"].codes))


# ------------------------------------------------------- configs and plans

@pytest.mark.parametrize("name", MODELS)
def test_config_is_the_reference(name):
    assert name in PORTED
    cfg = t_get(name)
    assert cfg == port_model_config(get_config(name))
    want = {"mixtral-8x22b": (56, 6144, 48, 8, 128, 16384, 32768, 8, 2,
                              ("attn_local",), 4096, None, 1e6),
            "llama4-scout-17b-a16e": (48, 5120, 40, 8, 128, 8192, 202048,
                                      16, 1, ("attn",), None, 48, 5e5)}[name]
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.n_experts,
           cfg.top_k, cfg.mixer_pattern,
           cfg.window if cfg.mixer_pattern == ("attn_local",) else None,
           cfg.head_pad_to, cfg.rope_theta)
    assert got == want
    assert (cfg.ffn_pattern, cfg.activation, cfg.glu, cfg.norm) == \
        (("moe",), "silu", True, "rmsnorm")
    assert cfg.expert_parallel == (name == "llama4-scout-17b-a16e")


@pytest.mark.parametrize("which", ["serving-raceit", "serving", "digital"])
@pytest.mark.parametrize("name", MODELS)
def test_plan_explain(name, which):
    ec = {"serving-raceit": ExecConfig.serving(mode="raceit"),
          "serving": ExecConfig.serving(),
          "digital": ExecConfig(mode="digital")}[which]
    cfg = tiny_config(get_config(name))
    want = r_resolve(cfg, ec).explain().splitlines()
    got = t_resolve(port_model_config(cfg), port_exec_config(ec)).explain()
    assert got.splitlines() == want


# ------------------------------------------------------------- checkpoints

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODELS)
def test_checkpoint_crosses_over(tmp_path, name, dtype):
    """The experts are scan-stacked (R, E, D, F) in a reference checkpoint,
    bfloat16 leaves stored as uint16 views; they load leaf for leaf as the
    in-memory crossing gives them, and serve the same prefill logits."""
    cfg = tiny_config(get_config(name)).replace(param_dtype=dtype,
                                                compute_dtype=dtype)
    params = RModel(cfg).init(jax.random.PRNGKey(5))
    assert params["blocks"]["scan"][0]["moe"]["w1"].shape == (
        cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
    CheckpointManager(str(tmp_path)).save(1, params)
    loaded = load_reference_checkpoint(tmp_path, port_model_config(cfg),
                                       device="cpu")
    in_memory = port_params(params, cfg)
    assert len(loaded["blocks"]) == cfg.n_layers
    for got, want in zip(loaded["blocks"], in_memory["blocks"]):
        assert got.keys() == want.keys() == {"norm1", "attn", "norm2", "moe"}
        for group in want:
            assert got[group].keys() == want[group].keys()
            for leaf in want[group]:
                assert got[group][leaf].dtype == want[group][leaf].dtype
                assert torch.equal(got[group][leaf], want[group][leaf])
    assert loaded["blocks"][0]["moe"]["w1"].dtype == getattr(torch, dtype)
    assert loaded["blocks"][0]["moe"]["router"].dtype == torch.float32
    model = TModel(port_model_config(cfg), ExecConfig(), device="cpu")
    toks = torch.from_numpy(np.arange(1, 11, dtype=np.int32)[None])
    a, _ = model.prefill(loaded, toks, model.init_cache(1, 16))
    b, _ = model.prefill(in_memory, toks, model.init_cache(1, 16))
    assert torch.equal(a, b)
    if dtype == "float32":
        rl, _ = RModel(cfg).prefill(params, jnp.asarray(toks.numpy()),
                                    RModel(cfg).init_cache(1, 16))
        np.testing.assert_allclose(a.numpy(), np.asarray(rl), atol=1e-4)
