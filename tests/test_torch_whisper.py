"""The encoder-decoder of the port (whisper-tiny) against the reference, at a
tiny size: `tests/conftest.py` `tiny_config` (d_model 64, 4 heads of 16,
vocab 256, learned positions, LayerNorm, GELU, qkv biases, tied
embeddings) with **3 encoder layers and 2 decoder layers**, so that the two
stacks cannot be confused, and **40 encoder frames**, not a multiple of 32
(the row sums' run length). The audio frontend is a stub in the reference
too: the encoder reads frame embeddings ``enc_feats`` (B, 40, 64), made
from a seed with numpy.

* `Model.forward` against the reference's jitted forward on the same
  weights: digital logits within `ATOL`; raceit_q8 logits within `ATOL`
  with every attention call's int32 ``out`` and ``cmax`` bit-equal (3
  bidirectional encoder calls, 2 causal decoder calls, 2 cross calls).
* The reference's own rule (tests/test_models_smoke.py:54-72) in the port:
  prefill(T0) and decode steps within 2e-3 of `forward`.
* `GenerationEngine.generate(enc_feats=...)` gives the reference's greedy
  tokens in digital and raceit_q8 mode; without ``enc_feats`` the decoder
  attends to the zero cross keys and values `init_cache` made, as the
  reference's does (its tokens too); `BatchScheduler` serves left-padded
  buckets so (the reference's passes no ``enc_feats`` either).
* Slot pools refuse encoder-decoders: `init_slot_cache` raises with the
  reference's message, `pageable_reason` is the reference's.
* A reference checkpoint crosses over (``encoder``, ``enc_norm`` and
  ``decoder`` with ``cross`` and ``norm_x``); the launcher serves it
  bucketed.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import CheckpointManager  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.configs.base import ExecConfig  # noqa: E402
from repro.models import Model as RModel  # noqa: E402
from repro.models.model import quantize_model_params as r_quantize  # noqa: E402
from repro.serve import BatchScheduler as RScheduler  # noqa: E402
from repro.serve import ContinuousBatcher as RBatcher  # noqa: E402
from repro.serve import GenerationEngine as REngine  # noqa: E402
from repro.serve import Request as RRequest  # noqa: E402
from repro_torch.ckpt import load_reference_checkpoint  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs.catalog import PORTED  # noqa: E402
from repro_torch.launch import serve as t_launch  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models.model import quantize_model_params as t_quantize  # noqa: E402
from repro_torch.serve import BatchScheduler as TScheduler  # noqa: E402
from repro_torch.serve import ContinuousBatcher as TBatcher  # noqa: E402
from repro_torch.serve import GenerationEngine as TEngine  # noqa: E402
from repro_torch.serve import Request as TRequest  # noqa: E402

from _torch_helpers import (port_exec_config, port_model_config,  # noqa: E402
                            port_params)
from conftest import tiny_config  # noqa: E402
from test_torch_encoder import assert_codes_equal, capture_codes  # noqa: E402

NAME = "whisper-tiny"
MODES = ("digital", "raceit_q8")
ATOL = 2e-5      # logits of about 1; float32 sums in other orders
RULE = 2e-3      # prefill + decode against forward (the reference's rule)
MAX_LEN = 48
# the widest top-2 gap of the reference's logits at which raceit_q8 tokens
# may part (tests/test_torch_gemma3.py's rule)
NEAR_TIE = 0.05

_ENGINES: dict = {}


def _cfg():
    return tiny_config(get_config(NAME)).replace(
        n_encoder_layers=3, n_layers=2, encoder_len=40)


def _exec(mode):
    return (ExecConfig.serving(mode="raceit") if mode == "raceit_q8"
            else ExecConfig(mode="digital"))


def _feats(cfg, B=1, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)


def _engines(mode):
    """(reference engine, port engine) on the same weights, cached."""
    if mode not in _ENGINES:
        cfg = _cfg()
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


def _agree(want, got, logits, mode):
    """Rows of greedy tokens: equal in digital; in raceit_q8 equal up to a
    parting at a near tie of the reference's ``logits(row, step)``, where
    the port took the reference's second best."""
    for b, (w, g) in enumerate(zip(want, got)):
        part = next((i for i, (x, y) in enumerate(zip(w, g)) if x != y),
                    None)
        if part is None:
            continue
        assert mode == "raceit_q8", (b, w, g)
        lg = logits(b, part)
        top2 = np.argsort(-lg)[:2]
        assert g[part] == top2[1], (b, part, w, g)
        assert lg[top2[0]] - lg[top2[1]] < NEAR_TIE, (b, part)


def _recorded(eng, monkeypatch):
    """``eng``'s model calls, each recording its last-position logits."""
    logs = []
    for name in ("_prefill", "_decode"):
        def call(*a, _fn=getattr(eng, name), **kw):
            out = _fn(*a, **kw)
            logs.append(np.asarray(out[0])[:, -1])
            return out
        monkeypatch.setattr(eng, name, call)
    return logs


# ---------------------------------------------------------------- configs

def test_config_is_the_reference():
    assert NAME in PORTED
    assert port_model_config(get_config(NAME)) == t_get(NAME)
    cfg = t_get(NAME)
    assert (cfg.n_encoder_layers, cfg.n_layers, cfg.encoder_len) == \
        (4, 4, 1500)


# ---------------------------------------------------------------- forward

@pytest.mark.parametrize("mode", MODES)
def test_forward_matches_the_reference(mode, monkeypatch):
    cfg = _cfg()
    ref, port = _engines(mode)
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)
                                            ).astype(np.int32)
    feats = _feats(cfg, B=2, seed=1)
    ref_codes, port_codes = capture_codes(monkeypatch)
    want = np.asarray(jax.jit(
        lambda p, b: ref.model.forward(p, b, use_remat=False))(
            ref.params, {"tokens": jnp.asarray(tok),
                         "enc_feats": jnp.asarray(feats)}))
    got = port.model.forward(port.params, {
        "tokens": torch.from_numpy(tok),
        "enc_feats": torch.from_numpy(feats)}).numpy()
    assert got.shape == (2, 12, cfg.vocab_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if mode == "raceit_q8":
        assert_codes_equal(ref_codes, port_codes,
                           cfg.n_encoder_layers + 2 * cfg.n_layers)


def test_parameter_trees_have_two_stacks():
    cfg = _cfg()
    p = TModel(port_model_config(cfg), device="cpu").init(
        torch.Generator().manual_seed(0))
    assert sorted(p) == ["decoder", "embed", "enc_norm", "encoder",
                         "final_norm"]
    assert len(p["encoder"]) == 3 and len(p["decoder"]) == 2
    assert all("cross" not in lp for lp in p["encoder"])
    assert all({"cross", "norm_x"} <= set(lp) for lp in p["decoder"])


def test_prefill_decode_matches_forward():
    """The reference's rule in the port, on its default (digital) plan:
    prefill(T0) then decode steps against one forward of the whole
    sequence, within 2e-3. (In raceit_q8 a step's whole-tensor quantizer
    scales see other rows than the forward's, in both packages.)"""
    cfg = _cfg()
    _, port = _engines("digital")
    B, S, T0 = 2, 12, 6
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    feats = torch.from_numpy(_feats(cfg, B=B, seed=2))
    m = port.model
    full = m.forward(port.params, {"tokens": tok, "enc_feats": feats})
    lg, cache = m.prefill(port.params, tok[:, :T0], m.init_cache(B, 32),
                          enc_feats=feats)
    errs = [float((lg[:, 0] - full[:, T0 - 1]).abs().max())]
    for t in range(T0, S):
        lg, cache = m.decode_step(port.params, tok[:, t:t + 1], cache)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < RULE, errs


@pytest.mark.parametrize("mode", MODES)
def test_prefill_decode_logits_are_the_reference(mode):
    """Step by step against the reference's jitted prefill and decode
    steps: the same last-position logits within `ATOL`."""
    cfg = _cfg()
    ref, port = _engines(mode)
    B, S, T0 = 2, 10, 4
    tok = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, S)
                                            ).astype(np.int32)
    feats = _feats(cfg, B=B, seed=9)
    rl, rc = ref._prefill(ref.params, jnp.asarray(tok[:, :T0]),
                          ref.model.init_cache(B, 16),
                          enc_feats=jnp.asarray(feats))
    tl, tc = port.model.prefill(port.params, torch.from_numpy(tok[:, :T0]),
                                port.model.init_cache(B, 16),
                                enc_feats=torch.from_numpy(feats))
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), atol=ATOL)
    for t in range(T0, S):
        rl, rc = ref._decode(ref.params, jnp.asarray(tok[:, t:t + 1]), rc)
        tl, tc = port.model.decode_step(port.params,
                                        torch.from_numpy(tok[:, t:t + 1]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), atol=ATOL)


def test_cache_holds_cross_keys_after_prefill():
    """`init_cache` is the reference's ``{"dec", "enc_kv"}`` with zero
    cross k/v of (B, encoder_len, KV, hd); `prefill` with ``enc_feats``
    fills them with the reference's values."""
    cfg = _cfg()
    ref, port = _engines("digital")
    feats = _feats(cfg, seed=5)
    tok = np.arange(1, 6, dtype=np.int32)[None]
    tc = port.model.init_cache(1, 16)
    assert sorted(tc) == ["dec", "enc_kv"] and len(tc["enc_kv"]) == 2
    assert all(float(k.abs().max()) == 0 and tuple(k.shape) == (1, 40, 4, 16)
               for k, _ in tc["enc_kv"])
    _, tc = port.model.prefill(port.params, torch.from_numpy(tok), tc,
                               enc_feats=torch.from_numpy(feats))
    _, rc = ref.model.prefill(ref.params, jnp.asarray(tok),
                              ref.model.init_cache(1, 16),
                              enc_feats=jnp.asarray(feats))
    for (tk, tv), (rk, rv) in zip(tc["enc_kv"], rc["enc_kv"]):
        np.testing.assert_allclose(tk.numpy(), np.asarray(rk), atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(rv), atol=ATOL)
    assert int(port.model._cache_index(tc)) == 5


# --------------------------------------------------------------- generate

@pytest.mark.parametrize("mode", MODES)
def test_generate_with_enc_feats_gives_the_reference_tokens(mode,
                                                             monkeypatch):
    cfg = _cfg()
    ref, port = _engines(mode)
    logs = _recorded(ref, monkeypatch)
    rng = np.random.default_rng(3)
    for i, n in enumerate((5, 9, 14)):
        prompt = rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)
        feats = _feats(cfg, seed=10 + i)
        logs.clear()
        want = ref.generate(jnp.asarray(prompt), 8,
                            enc_feats=jnp.asarray(feats))
        got = port.generate(prompt, 8, enc_feats=torch.from_numpy(feats))
        _agree(want, got, lambda b, s: logs[s][b], mode)


@pytest.mark.parametrize("mode", MODES)
def test_generate_without_enc_feats_attends_to_zeros(mode, monkeypatch):
    """No ``enc_feats``: the decoder attends to the zero cross k/v, as the
    reference's does; its tokens differ from a run with features."""
    cfg = _cfg()
    ref, port = _engines(mode)
    logs = _recorded(ref, monkeypatch)
    prompt = np.arange(3, 10, dtype=np.int32)[None]
    want = ref.generate(jnp.asarray(prompt), 8)
    got = port.generate(prompt, 8)
    _agree(want, got, lambda b, s: logs[s][b], mode)
    m = port.model
    zeros, _ = m.prefill(port.params, torch.from_numpy(prompt),
                         m.init_cache(1, 16))
    feats, _ = m.prefill(port.params, torch.from_numpy(prompt),
                         m.init_cache(1, 16),
                         enc_feats=torch.from_numpy(_feats(cfg, seed=7)))
    assert float((zeros - feats).abs().max()) > 1e-3


@pytest.mark.parametrize("mode", MODES)
def test_bucketed_batching_gives_the_reference_tokens(mode, monkeypatch):
    """Left-padded buckets of 2 through `BatchScheduler` (no enc_feats, as
    the reference's scheduler passes none)."""
    cfg = _cfg()
    ref, port = _engines(mode)
    rng = np.random.default_rng(8)
    trace = [(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32))
             for i, n in enumerate((4, 11, 7, 9))]
    rs, ts = RScheduler(ref, bucket_size=2), TScheduler(port, bucket_size=2)
    for rid, prompt in trace:
        rs.submit(RRequest(rid, prompt, n_new=5))
        ts.submit(TRequest(rid, prompt, n_new=5))
    rdone, tdone = rs.run_all(), ts.run_all()
    assert sorted(rdone) == sorted(tdone)
    for rid in rdone:
        w, g = rdone[rid].result.tolist(), tdone[rid].result.tolist()
        if mode == "digital":
            assert g == w, rid
    if mode == "raceit_q8":  # counted: parting only at near ties
        same = sum(rdone[r].result.tolist() == tdone[r].result.tolist()
                   for r in rdone)
        assert same >= len(rdone) - 1


# ------------------------------------------------------- slot pools refuse

def test_slot_pools_refuse_encoder_decoders():
    ref, port = _engines("digital")
    why = RBatcher.pageable_reason(ref)
    assert why is not None and "encoder-decoder" in why
    assert TBatcher.pageable_reason(port) == why
    msg = ("slot-pool caches cover decoder-only stacks; encoder-decoder "
           "serving stays on bucketed batching")
    with pytest.raises(NotImplementedError, match=re.escape(msg)):
        port.model.init_slot_cache(2, 16)
    with pytest.raises(NotImplementedError, match=re.escape(msg)):
        port.model.init_slot_cache(2, 16, page_size=8, n_pages=5)
    with pytest.raises(NotImplementedError, match=re.escape(msg)):
        ref.model.init_slot_cache(2, 16)
    with pytest.raises(ValueError, match=re.escape(
            f"paged serving unsupported: {why}")):
        TBatcher(port, paged=True)


# ------------------------------------------------------------- checkpoint

def test_reference_checkpoint_crosses_over(tmp_path):
    cfg = _cfg()
    params = RModel(cfg).init(jax.random.PRNGKey(5))
    CheckpointManager(str(tmp_path)).save(1, params)
    tcfg = port_model_config(cfg)
    loaded = load_reference_checkpoint(tmp_path, tcfg, device="cpu")
    in_memory = port_params(params, cfg)
    assert len(loaded["encoder"]) == 3 and len(loaded["decoder"]) == 2
    for stack in ("encoder", "decoder"):
        for got, want in zip(loaded[stack], in_memory[stack]):
            assert sorted(got) == sorted(want)
            for group in want:
                for leaf in want[group]:
                    assert torch.equal(got[group][leaf], want[group][leaf])
    for leaf in in_memory["enc_norm"]:
        assert torch.equal(loaded["enc_norm"][leaf],
                           in_memory["enc_norm"][leaf])
    tok = np.arange(1, 9, dtype=np.int32)[None]
    feats = _feats(cfg, seed=6)
    batch = {"tokens": torch.from_numpy(tok),
             "enc_feats": torch.from_numpy(feats)}
    model = TModel(tcfg, device="cpu")
    a, b = model.forward(loaded, batch), model.forward(in_memory, batch)
    assert torch.equal(a, b)
    rl = RModel(cfg).forward(params, {"tokens": jnp.asarray(tok),
                                      "enc_feats": jnp.asarray(feats)},
                             use_remat=False)
    np.testing.assert_allclose(a.numpy(), np.asarray(rl), rtol=0, atol=ATOL)


def test_launcher_serves_whisper_bucketed(capsys):
    done = t_launch.main(["--arch", NAME, "--mode", "raceit_q8", "--device",
                          "cpu", "--requests", "3", "--n-new", "3",
                          "--slots", "2", "--set", "n_layers=2",
                          "n_encoder_layers=3", "encoder_len=40",
                          "d_model=64", "n_heads=4", "n_kv_heads=4",
                          "head_dim=16", "d_ff=128", "vocab_size=256"])
    assert len(done) == 3 and all(r.error is None for r in done.values())
    assert "bucketed batching" in capsys.readouterr().out
