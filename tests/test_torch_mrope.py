"""M-RoPE and qwen2-vl-2b in the port against the reference.

* `layers.apply_rope` under ``pos_emb="mrope"`` against the reference's on
  the same q, with **distinct** t/h/w position channels: at head dim 128
  with the published sections (16, 24, 24), and at the tiny head dim 16,
  where the reference rescales the sections to (2, 3, 3). Both within
  `ROPE_ATOL` (float32 sin and cos of two libraries). (B, S) positions are
  one channel broadcast to three; with equal channels M-RoPE is RoPE bit
  for bit, which is why such positions test nothing.
* The sinusoidal positions of `layers.embed` (``--set pos_emb=sinusoidal``)
  against the reference's.
* A tiny qwen2-vl (`tests/conftest.py` `tiny_config`: 2 layers, d_model 64,
  4 heads over 2 KV heads of 16, M-RoPE, qkv biases, tied embeddings)
  gives the reference's tokens and counters through the paged batcher, in
  digital and raceit_q8 mode (raceit_q8 with the port's norms returning the
  reference's jitted values: XLA's CPU rsqrt and torch's differ in the last
  bit); `Model.prefill` with (3, B, S) positions (a patch grid, then text)
  gives the reference's logits and cache within `ATOL`.
* The plans print the reference's lines; the launcher serves qwen2-vl paged
  with no further flag.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ExecConfig  # noqa: E402
from repro.exec import resolve_plan as r_resolve  # noqa: E402
from repro.models import Model as RModel  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.model import quantize_model_params as r_quantize  # noqa: E402
from repro.serve import ContinuousBatcher as RBatcher  # noqa: E402
from repro.serve import GenerationEngine as REngine  # noqa: E402
from repro.serve import Request as RRequest  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs.catalog import PORTED  # noqa: E402
from repro_torch.exec import resolve_plan as t_resolve  # noqa: E402
from repro_torch.launch import serve as t_launch  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.model import quantize_model_params as t_quantize  # noqa: E402
from repro_torch.serve import ContinuousBatcher as TBatcher  # noqa: E402
from repro_torch.serve import GenerationEngine as TEngine  # noqa: E402
from repro_torch.serve import Request as TRequest  # noqa: E402

from _torch_helpers import (port_exec_config, port_model_config,  # noqa: E402
                            port_params)
from conftest import tiny_config  # noqa: E402

NAME = "qwen2-vl-2b"
MODES = ("digital", "raceit_q8")
ROPE_ATOL = 2e-5  # |x| < 5, angles under 64 rad: float32 sin/cos
ATOL = 2e-5       # logits of about 1; float32 sums in other orders
MAX_LEN = 48
_PAGED_COUNTERS = ("requests_done", "prefills", "chunk_calls",
                   "decode_steps", "decode_tokens", "tokens_out",
                   "model_calls", "pages_peak_in_use", "pages_allocatable")

_ENGINES: dict = {}


def _t(a):
    return torch.from_numpy(np.array(a))


def _channels(B, S, seed):
    """Distinct t/h/w channels, each random in [0, 64)."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 64, (3, B, S)).astype(np.int32)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    return pos


def grid_positions(grid=(2, 3, 4), n_text=5, B=2):
    """(3, B, S) positions of a (t, h, w) patch grid followed by text at
    max + 1 + n in every channel (Qwen2-VL's layout)."""
    t, h, w = np.meshgrid(*(np.arange(n) for n in grid), indexing="ij")
    vis = np.stack([t.ravel(), h.ravel(), w.ravel()])
    text = vis.max() + 1 + np.arange(n_text)
    pos = np.concatenate([vis, np.broadcast_to(text, (3, n_text))], 1)
    return np.broadcast_to(pos[:, None], (3, B, pos.shape[1])
                           ).astype(np.int32).copy()


# ------------------------------------------------------------------ M-RoPE

def test_config_is_the_reference():
    assert NAME in PORTED
    assert port_model_config(get_config(NAME)) == t_get(NAME)


@pytest.mark.parametrize("hd,secs", [(128, (16, 24, 24)), (16, (2, 3, 3))])
def test_sections_follow_the_reference_rescale(hd, secs):
    cfg = t_get(NAME)
    assert tuple(TL.mrope_sections(cfg, hd)) == secs


@pytest.mark.parametrize("hd", [128, 16])
def test_apply_rope_mrope_with_distinct_channels(hd):
    cfg = get_config(NAME)
    rng = np.random.default_rng(hd)
    x = rng.normal(0, 1, (2, 7, 3, hd)).astype(np.float32)
    pos = _channels(2, 7, seed=hd)
    want = np.asarray(jax.jit(RL.apply_rope, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(pos), cfg))
    got = TL.apply_rope(_t(x), _t(pos), t_get(NAME)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ROPE_ATOL)
    # text-only channels give other values: the channels were used
    flat = TL.apply_rope(_t(x), _t(pos[0]), t_get(NAME)).numpy()
    assert np.abs(flat - got).max() > 1e-2


@pytest.mark.parametrize("hd", [128, 16])
def test_mrope_with_equal_channels_is_rope(hd):
    """(B, S) positions broadcast to three equal channels; then every band
    reads the same angles and M-RoPE is RoPE, bit for bit."""
    cfg = t_get(NAME)
    rng = np.random.default_rng(1)
    x = _t(rng.normal(0, 1, (2, 5, 2, hd)).astype(np.float32))
    pos = _t(rng.integers(0, 100, (2, 5)).astype(np.int32))
    mrope = TL.apply_rope(x, pos, cfg)
    assert torch.equal(mrope, TL.apply_rope(
        x, torch.stack([pos] * 3), cfg))
    assert torch.equal(mrope, TL.apply_rope(x, pos,
                                            cfg.replace(pos_emb="rope")))
    want = np.asarray(RL.apply_rope(jnp.asarray(x.numpy()),
                                    jnp.asarray(pos.numpy()),
                                    get_config(NAME)))
    np.testing.assert_allclose(mrope.numpy(), want, rtol=0, atol=ROPE_ATOL)


def test_sinusoidal_embed_matches_the_reference():
    cfg = tiny_config(get_config("bert-base")).replace(pos_emb="sinusoidal")
    p = RL.init_embeddings(jax.random.PRNGKey(0), cfg, jnp.float32)
    assert "pos_emb" not in p
    tok = np.random.default_rng(0).integers(0, 256, (2, 9)).astype(np.int32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32) * 37, (2, 9)).copy()
    want = np.asarray(jax.jit(RL.embed, static_argnums=3)(
        p, jnp.asarray(tok), jnp.asarray(pos), cfg))
    got = TL.embed({"tok_emb": _t(p["tok_emb"])}, _t(tok), _t(pos),
                   port_model_config(cfg)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ROPE_ATOL)


# ------------------------------------------------------------- the model

def _exec(mode):
    return (ExecConfig.serving(mode="raceit") if mode == "raceit_q8"
            else ExecConfig(mode="digital"))


def _engines(mode):
    if mode not in _ENGINES:
        cfg = tiny_config(get_config(NAME))
        ec = _exec(mode)
        ref = REngine(cfg, None, ec, max_len=MAX_LEN)
        p0 = ref.model.init(jax.random.PRNGKey(4))
        tparams = port_params(p0, cfg)
        if mode == "raceit_q8":
            ref.params, tparams = r_quantize(p0), t_quantize(tparams)
        else:
            ref.params = p0
        port = TEngine(port_model_config(cfg), tparams, port_exec_config(ec),
                       max_len=MAX_LEN, device="cpu")
        _ENGINES[mode] = (ref, port)
    return _ENGINES[mode]


@pytest.fixture
def reference_norms(monkeypatch):
    """The port's norms return the reference's jitted values."""
    ref_norm = jax.jit(RL.apply_norm, static_argnums=2)

    def norm(p, x, cfg):  # the norm reads cfg.norm alone
        y = ref_norm({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                     jnp.asarray(x.numpy()), get_config(cfg.name))
        return torch.from_numpy(np.array(y))
    monkeypatch.setattr(TL, "apply_norm", norm)


@pytest.mark.parametrize("mode", MODES)
def test_paged_batcher_gives_the_reference_tokens(mode, reference_norms):
    """Three slots, 8-token pages, chunked prefill, five requests: the
    reference's retirements every step, tokens and counters."""
    ref, port = _engines(mode)
    assert TBatcher.pageable_reason(port) is None
    kw = dict(n_slots=3, page_size=8, n_pages=9)
    rb, tb = RBatcher(ref, **kw), TBatcher(port, **kw)
    assert rb.paged and tb.paged
    rng = np.random.default_rng(1)
    for rid, n in enumerate((7, 3, 12, 2, 6)):
        prompt = rng.integers(0, 255, n).astype(np.int32)
        rb.submit(RRequest(rid, prompt, n_new=5))
        tb.submit(TRequest(rid, prompt, n_new=5))
    steps = 0
    while rb.queue or any(s is not None for s in rb.slots):
        assert rb.step() == tb.step()
        steps += 1
        assert steps < 200
    assert sorted(tb.done) == sorted(rb.done)
    for rid, req in rb.done.items():
        assert req.error is None and tb.done[rid].error is None
        assert tb.done[rid].result.tolist() == req.result.tolist(), rid
    rs, ts = rb.summary(), tb.summary()
    assert {k: ts[k] for k in _PAGED_COUNTERS} == \
        {k: rs[k] for k in _PAGED_COUNTERS}
    assert tb.chunk_calls > 0


@pytest.mark.parametrize("mode", MODES)
def test_prefill_with_three_channel_positions(mode):
    """`Model.prefill` with (3, B, S) positions: a 2 x 3 x 4 patch grid
    then 5 text tokens. The logits and the cached keys (rotated by M-RoPE)
    are the reference's; the embedding reads channel 0."""
    ref, port = _engines(mode)
    cfg = ref.cfg
    pos = grid_positions()
    S = pos.shape[-1]
    tok = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, S)
                                            ).astype(np.int32)
    rl, rc = jax.jit(ref.model.prefill)(
        ref.params, jnp.asarray(tok), ref.model.init_cache(2, 32),
        positions=jnp.asarray(pos))
    tl, tc = port.model.prefill(port.params, _t(tok),
                                port.model.init_cache(2, 32),
                                positions=_t(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), rtol=0, atol=ATOL)
    rk = np.asarray(rc["scan"][0]["attn"]["k"][0])
    np.testing.assert_allclose(tc[0]["attn"]["k"].numpy(), rk, rtol=0,
                               atol=ATOL)
    text, _ = port.model.prefill(port.params, _t(tok),
                                 port.model.init_cache(2, 32),
                                 positions=_t(pos[0]))
    assert float((text - tl).abs().max()) > 1e-3


@pytest.mark.parametrize("which", ["serving-raceit", "serving", "digital"])
def test_plan_explain(which):
    ec = {"serving-raceit": ExecConfig.serving(mode="raceit"),
          "serving": ExecConfig.serving(),
          "digital": ExecConfig(mode="digital")}[which]
    cfg = tiny_config(get_config(NAME))
    want = r_resolve(cfg, ec).explain().splitlines()
    got = t_resolve(port_model_config(cfg), port_exec_config(ec))
    assert got.explain().splitlines() == want


def test_launcher_serves_qwen2_vl_paged(capsys):
    done = t_launch.main(["--arch", NAME, "--mode", "raceit_q8",
                          "--continuous", "--device", "cpu", "--requests",
                          "3", "--n-new", "3", "--max-len", "32",
                          "--page-size", "8", "--set", "n_layers=2",
                          "d_model=64", "n_heads=4", "n_kv_heads=2",
                          "head_dim=16", "d_ff=128", "vocab_size=256"])
    assert sorted(done) == [0, 1, 2]
    assert all(r.error is None and len(r.result) == 3 for r in done.values())
    assert "block-paged KV" in capsys.readouterr().out
