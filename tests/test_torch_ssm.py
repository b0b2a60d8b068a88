"""The port's Mamba-2 (SSD) mixer against the reference's jitted
`repro.models.ssm.mamba`, on the same float32 inputs and weights, at
`tests/conftest.py` `tiny_config` size of mamba2-130m (d_model 64, 16 heads
of 8, state 16, chunk 8).

* Chunked prefill without a cache at lengths 1, 7, 8, 13 and 24 (shorter
  than one chunk, one chunk, not a multiple of it, three chunks), and into a
  cache followed by decode steps (the recurrent update), with the caches
  compared leaf by leaf; a 1-token prefill into a cache takes the recurrent
  step, as in the reference.
* ``ssm_groups`` 1 and 2: at 2 the B/C groups are repeated over heads in
  ``jnp.repeat``'s order (`repeat_interleave`); an order that tiles them
  would part here.
* Digital and raceit_q8 (resident int8 projections). The conv taps, D and
  the norm scale are drawn at random (the reference's init makes the conv an
  identity, which would hide a wrong tap order). In raceit_q8 the gated
  RMSNorm is pinned to the reference's jitted values (XLA's CPU rsqrt and
  torch's differ in the last bit, and the norm's output is quantized to
  int8 by ``out_proj``).
* Tolerance `ATOL` 1e-5 on outputs and states of magnitude up to about 5:
  float32 sums that XLA and torch order differently (the einsums, the
  cumulative sum) differ by a few ulps (at most 1.2e-6 on these inputs).
* Whole models in the port: tiny mamba2-130m and tiny jamba (one period of
  8 layers), prefill then
  decode steps, against the port's own full prefill's logits within 2e-3
  (the reference's rule, tests/test_models_smoke.py), and against the
  reference's logits within `MODEL_ATOL` 1e-4 (tests/test_torch_generate.py's
  digital-mode tolerance is 1e-5 over 2 layers; 16 layers of tiny jamba
  differed by up to 1.9e-5).
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ExecConfig  # noqa: E402
from repro.models import Model as RModel  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro.models.model import quantize_model_params as r_quantize  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.model import quantize_model_params as t_quantize  # noqa: E402

from _torch_helpers import (port_exec_config, port_model_config,  # noqa: E402
                            port_params)
from conftest import tiny_config  # noqa: E402

MODES = ("digital", "raceit_q8")
ATOL = 1e-5
# whole models (tiny jamba: 16 layers with attention, MoE and dense FFNs):
# tests/test_torch_generate.py's logits tolerance
MODEL_ATOL = 1e-4
_CACHE_LEAVES = ("state", "conv_x", "conv_B", "conv_C")


def _cfg(groups=1):
    return tiny_config(get_config("mamba2-130m")).replace(ssm_groups=groups)


def _exec(mode):
    return (ExecConfig.serving(mode="raceit") if mode == "raceit_q8"
            else ExecConfig(mode="digital"))


_PARAMS: dict = {}


def _params(groups, mode):
    """(reference params, port params) of one mixer; random conv taps, D and
    norm scale."""
    key = (groups, mode)
    if key not in _PARAMS:
        cfg = _cfg(groups)
        p = RS.init_mamba_with_out(jax.random.PRNGKey(groups), cfg,
                                   jnp.float32)
        p = {k: np.asarray(v) for k, v in p.items()}
        rng = np.random.default_rng(groups)
        for k in ("conv_x", "conv_B", "conv_C"):
            p[k] = rng.normal(0, 0.5, p[k].shape).astype(np.float32)
        for k in ("ssm_D", "norm_scale"):
            p[k] = rng.normal(1, 0.3, p[k].shape).astype(np.float32)
        rp = {k: jnp.asarray(v) for k, v in p.items()}
        tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
        if mode == "raceit_q8":
            rp, tp = r_quantize({"m": rp})["m"], t_quantize({"m": tp})["m"]
        _PARAMS[key] = (rp, tp)
    return _PARAMS[key]


def _ref_gated_norm(y, z, scale):
    """The reference's gated RMSNorm lines (ref ssm.py, the norm before
    out_proj), jitted."""
    g = y.astype(jnp.float32) * jax.nn.silu(z.astype(jnp.float32))
    g = g * jax.lax.rsqrt(jnp.mean(g * g, -1, keepdims=True) + 1e-6)
    return g * scale.astype(jnp.float32)


_REF_GATED_NORM = jax.jit(_ref_gated_norm)


@pytest.fixture
def reference_gated_norm(monkeypatch):
    def norm(y, z, scale, eps):
        assert eps == 1e-6  # the reference's
        out = _REF_GATED_NORM(*(jnp.asarray(t.numpy()) for t in (y, z, scale)))
        return torch.from_numpy(np.array(out))
    monkeypatch.setattr(TS, "gated_norm", norm)


_REF_MAMBA: dict = {}


def _ref_mamba(cfg, mode):
    key = (cfg, mode)
    if key not in _REF_MAMBA:
        _REF_MAMBA[key] = jax.jit(partial(RS.mamba, cfg=cfg, plan=_exec(mode)))
    return _REF_MAMBA[key]


def _zeros_cache(cfg, batch):
    W, GN = cfg.conv_width, cfg.ssm_groups * cfg.ssm_state
    return {"state": np.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim,
                               cfg.ssm_state), np.float32),
            "conv_x": np.zeros((batch, W - 1, cfg.d_inner), np.float32),
            "conv_B": np.zeros((batch, W - 1, GN), np.float32),
            "conv_C": np.zeros((batch, W - 1, GN), np.float32)}


def _both(cfg, mode, x, cache=None):
    """(reference out, cache), (port out, cache) on the same inputs."""
    rp, tp = _params(cfg.ssm_groups, mode)
    r_out, r_cache = _ref_mamba(cfg, mode)(
        rp, jnp.asarray(x),
        cache=None if cache is None else {k: jnp.asarray(v)
                                          for k, v in cache.items()})
    t_out, t_cache = TS.mamba(
        tp, torch.from_numpy(x), cfg=port_model_config(cfg),
        plan=port_exec_config(_exec(mode)),
        cache=None if cache is None else {k: torch.from_numpy(v.copy())
                                          for k, v in cache.items()})
    return (np.asarray(r_out), r_cache), (t_out.numpy(), t_cache)


def _close_caches(r_cache, t_cache):
    for k in _CACHE_LEAVES:
        assert t_cache[k].dtype == (torch.float32)
        np.testing.assert_allclose(t_cache[k].numpy(), np.asarray(r_cache[k]),
                                   rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("S", [1, 7, 8, 13, 24])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_chunked_prefill(mode, groups, S, request):
    if mode == "raceit_q8":
        request.getfixturevalue("reference_gated_norm")
    cfg = _cfg(groups)
    x = np.random.default_rng(S).normal(0, 1, (2, S, cfg.d_model)
                                        ).astype(np.float32)
    (r_out, _), (t_out, t_cache) = _both(cfg, mode, x)
    assert t_cache is None
    assert t_out.shape == (2, S, cfg.d_model)
    np.testing.assert_allclose(t_out, r_out, rtol=0, atol=ATOL)


@pytest.mark.parametrize("S", [13, 8])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_prefill_into_cache_then_decode(mode, groups, S, request):
    """A prefill into a zero cache, then three recurrent decode steps; each
    step's output and the caches after it."""
    if mode == "raceit_q8":
        request.getfixturevalue("reference_gated_norm")
    cfg = _cfg(groups)
    rng = np.random.default_rng(100 + S)
    x = rng.normal(0, 1, (2, S + 3, cfg.d_model)).astype(np.float32)
    (r_out, r_cache), (t_out, t_cache) = _both(cfg, mode, x[:, :S],
                                               _zeros_cache(cfg, 2))
    np.testing.assert_allclose(t_out, r_out, rtol=0, atol=ATOL)
    _close_caches(r_cache, t_cache)
    for t in range(S, S + 3):  # from the same (reference) cache each step
        cache = {k: np.asarray(v) for k, v in r_cache.items()}
        (r_out, r_cache), (t_out, t_cache) = _both(cfg, mode, x[:, t:t + 1],
                                                   cache)
        np.testing.assert_allclose(t_out, r_out, rtol=0, atol=ATOL)
        _close_caches(r_cache, t_cache)


@pytest.mark.parametrize("mode", MODES)
def test_one_token_prefill_takes_the_recurrent_step(mode, request,
                                                    monkeypatch):
    """``S == 1 and cache is not None`` is the recurrent branch in both
    packages, whether or not the call is a decode step."""
    if mode == "raceit_q8":
        request.getfixturevalue("reference_gated_norm")
    cfg = _cfg()
    x = np.random.default_rng(7).normal(0, 1, (2, 1, cfg.d_model)
                                        ).astype(np.float32)
    chunked = []
    inner = TS._ssd_chunked
    monkeypatch.setattr(TS, "_ssd_chunked",
                        lambda *a, **kw: chunked.append(1) or inner(*a, **kw))
    (r_out, r_cache), (t_out, t_cache) = _both(cfg, mode, x,
                                               _zeros_cache(cfg, 2))
    assert not chunked
    np.testing.assert_allclose(t_out, r_out, rtol=0, atol=ATOL)
    _close_caches(r_cache, t_cache)
    _both(cfg, mode, x)  # no cache: the chunked form
    assert chunked == [1]


def test_softplus_is_jax_formula():
    x = np.concatenate([np.linspace(-40, 40, 4001),
                        [-100.0, -20.5, 19.9, 20.1, 25.0, 88.0]]
                       ).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.softplus)(jnp.asarray(x)))
    got = TS.softplus(torch.from_numpy(x)).numpy()
    # XLA's CPU code flushes subnormal results to zero (softplus(-100))
    np.testing.assert_allclose(got, want, rtol=2e-7,
                               atol=np.finfo(np.float32).tiny)


def test_init_follows_the_reference():
    """Shapes and dtypes leaf for leaf; the deterministic leaves equal; dt
    log-uniform in [1e-3, 1e-1] behind its inverse softplus."""
    cfg = _cfg(2)
    want = RS.init_mamba_with_out(jax.random.PRNGKey(0), cfg, jnp.float32)
    got = TS.init_mamba_with_out(torch.Generator().manual_seed(0),
                                 port_model_config(cfg), "cpu",
                                 torch.float32)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
    for k in ("ssm_D", "conv_x", "conv_B", "conv_C", "norm_scale"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    # log(h % 15 + 1): XLA's float32 log and torch's part by an ulp
    np.testing.assert_allclose(got["A_log"].numpy(), np.asarray(want["A_log"]),
                               rtol=1.2e-7, atol=0)
    dt = TS.softplus(got["dt_bias"]).numpy()
    assert (dt > 0.99e-3).all() and (dt < 1.01e-1).all()
    for k in ("w_z", "w_dt", "out_proj"):  # N(0, 1/fan_in)
        fan_in = got[k].shape[0]
        assert abs(float(got[k].std()) * fan_in ** 0.5 - 1) < 0.1, k


# ------------------------------------------------------------ models

def _model_pair(name, mode):
    cfg = tiny_config(get_config(name))
    if cfg.n_layers > cfg.block_period:  # jamba: one period of 8 layers
        cfg = cfg.replace(n_layers=cfg.block_period)
    ec = _exec(mode)
    ref = RModel(cfg, ec)
    p0 = ref.init(jax.random.PRNGKey(1))
    tparams = port_params(p0, cfg)
    rparams = p0
    if mode == "raceit_q8":
        rparams, tparams = r_quantize(p0), t_quantize(tparams)
    port = TModel(port_model_config(cfg), port_exec_config(ec), device="cpu")
    return cfg, ref, rparams, port, tparams


@pytest.mark.parametrize("name", ["mamba2-130m", "jamba-v0.1-52b"])
def test_prefill_decode_matches_full_prefill(name):
    """tests/test_models_smoke.py's rule in the port: prefill(T0) and decode
    steps give the full prefill's logits within 2e-3."""
    cfg, _, _, port, tparams = _model_pair(name, "digital")
    B, S, T0 = 2, 12, 6
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    x, _ = port._trunk(tparams, tokens, port._positions(tokens), None)
    full = TL.unembed(tparams["embed"], x, port.cfg, port.plan)
    cache = port.init_cache(B, 32)
    lg, cache = port.prefill(tparams, tokens[:, :T0], cache)
    errs = [float((lg[:, 0] - full[:, T0 - 1]).abs().max())]
    for t in range(T0, S):
        lg, cache = port.decode_step(tparams, tokens[:, t:t + 1], cache)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 2e-3, errs


@pytest.mark.parametrize("name", ["mamba2-130m", "jamba-v0.1-52b"])
def test_model_logits_match_reference(name):
    """Digital prefill (a prompt past one chunk) and decode steps: the
    reference's logits within `MODEL_ATOL` (norms and sums in other
    orders)."""
    cfg, ref, rparams, port, tparams = _model_pair(name, "digital")
    B, S = 2, 11
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + 3)
                                            ).astype(np.int32)
    rcache = ref.init_cache(B, 32)
    tcache = port.init_cache(B, 32)
    r_lg, rcache = jax.jit(ref.prefill)(rparams, jnp.asarray(tok[:, :S]),
                                        rcache)
    t_lg, tcache = port.prefill(tparams, torch.from_numpy(tok[:, :S]), tcache)
    np.testing.assert_allclose(t_lg.numpy(), np.asarray(r_lg), rtol=0,
                               atol=MODEL_ATOL)
    decode = jax.jit(ref.decode_step)
    for t in range(S, S + 3):
        r_lg, rcache = decode(rparams, jnp.asarray(tok[:, t:t + 1]), rcache)
        t_lg, tcache = port.decode_step(tparams,
                                        torch.from_numpy(tok[:, t:t + 1]),
                                        tcache)
        np.testing.assert_allclose(t_lg.numpy(), np.asarray(r_lg), rtol=0,
                                   atol=MODEL_ATOL)


def test_quantize_model_params_of_the_mixer():
    """The five input projections and out_proj become resident int8 codes
    equal to the reference's; the conv taps, dt_bias, A_log, D and the norm
    scale stay float, and so does jamba's ``moe`` subtree."""
    cfg = tiny_config(get_config("jamba-v0.1-52b")).replace(n_layers=2)
    p0 = RModel(cfg).init(jax.random.PRNGKey(3))
    want = r_quantize(p0)
    got = t_quantize(port_params(p0, cfg))
    # 2 of a period of 8: both layers are the reference's unstacked tail
    mix, rmix = got["blocks"][0]["mamba"], want["blocks"]["tail"][0]["mamba"]
    for k in ("w_z", "w_x", "w_B", "w_C", "w_dt", "out_proj"):
        assert isinstance(mix[k], TL.QuantizedWeight), k
        np.testing.assert_array_equal(mix[k].codes.numpy(),
                                      np.asarray(rmix[k].codes))
        np.testing.assert_array_equal(mix[k].scale.numpy(),
                                      np.asarray(rmix[k].scale))
    for k in ("conv_x", "conv_B", "conv_C", "dt_bias", "A_log", "ssm_D",
              "norm_scale"):
        assert isinstance(mix[k], torch.Tensor) and mix[k].is_floating_point()
    moe = got["blocks"][1]["moe"]
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32
               for v in moe.values())
