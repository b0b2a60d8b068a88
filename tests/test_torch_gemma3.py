"""gemma3-4b (5:1 sliding-window : global attention, ring caches, head dim
320) in the port, against the reference, at `tests/conftest.py`
`tiny_config` size (13 layers: two scan periods of 5 local + 1 global and a
local tail; window 8; heads of 16).

* The configuration is the reference's field for field, and in `PORTED`.
* Serving: the contiguous slot pool at ``prefill_len`` 8 (the window) and 12
  (past it: the left-padded prompt overflows the rings), `BatchScheduler`
  and solo `generate` give the reference's greedy tokens and counters, in
  digital and raceit_q8. In raceit_q8 the port's norms return the
  reference's float values, as in tests/test_torch_generate.py: XLA's CPU
  rsqrt and torch's differ in the last bit, and at an int8 rounding
  boundary that ulp moves a code. Thirteen layers of int8 requantization
  leave more such boundaries than the norms: RoPE's sin and cos, and the
  float sums XLA fuses across a layer, differ in the last bit too (each
  layer alone is within 2e-6 of the reference's jitted layer, and its
  integer attention pipeline is exact, tests/test_torch_local.py), so one
  flipped code can move later logits by a few 1e-2. Where `BatchScheduler`
  and `generate` tokens part in raceit_q8, they must part at a near tie of
  the reference's logits (its two best within `NEAR_TIE`), the port taking
  the reference's second best; every token before is the reference's.
* The pool against solo runs: in digital mode the pool gives each request
  its solo tokens while the pinned width is at most the window, and not
  past it (the reference drops the decode pad mask of a layer whose ring
  the prompt overflowed); the port shows the reference's counts.
* The resolved plans, with and without the staged recipe for local layers
  (`ExecConfig.layer_overrides`), print the reference's lines, and the
  recipe serves the reference's tokens.
* Paged serving refuses the model with the reference's reason; weights
  cross over through a reference checkpoint (scan periods plus a tail);
  the launcher serves it from the contiguous pool.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import CheckpointManager  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.configs.base import ExecConfig  # noqa: E402
from repro.exec import resolve_plan as r_resolve  # noqa: E402
from repro.exec.plan import layer_plan as r_layer_plan  # noqa: E402
from repro.models import Model as RModel  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.model import quantize_model_params as r_quantize  # noqa: E402
from repro.serve import BatchScheduler as RScheduler  # noqa: E402
from repro.serve import ContinuousBatcher as RBatcher  # noqa: E402
from repro.serve import GenerationEngine as REngine  # noqa: E402
from repro.serve import Request as RRequest  # noqa: E402
from repro_torch.ckpt import load_reference_checkpoint  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs.base import ExecConfig as TExecConfig  # noqa: E402
from repro_torch.configs.catalog import PORTED  # noqa: E402
from repro_torch.exec import resolve_plan as t_resolve  # noqa: E402
from repro_torch.exec.plan import layer_plan as t_layer_plan  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.model import quantize_model_params as t_quantize  # noqa: E402
from repro_torch.serve import BatchScheduler as TScheduler  # noqa: E402
from repro_torch.serve import ContinuousBatcher as TBatcher  # noqa: E402
from repro_torch.serve import GenerationEngine as TEngine  # noqa: E402
from repro_torch.serve import Request as TRequest  # noqa: E402

from _torch_helpers import (port_exec_config, port_model_config,  # noqa: E402
                            port_params)
from conftest import tiny_config  # noqa: E402

NAME = "gemma3-4b"
MAX_LEN = 64
MODES = ("digital", "raceit_q8")
# the standard recipe for mixed local/global stacks (repro.exec.plan
# layer_plan): staged attention on sliding-window layers, fused on global
STAGED_LOCAL = (("attn_local", (("attention_prefill", "raceit_staged"),
                                ("attention_decode", "raceit_staged"))),)
_COUNTERS = ("requests_done", "prefills", "decode_steps", "decode_tokens",
             "tokens_out", "model_calls", "router_policy", "router_rejected",
             "queue_depths", "ttft_p50", "tpl_p50")

# the widest top-2 gap of the reference's logits at which raceit_q8 tokens
# may part (the logits of these random tiny models span a few tenths; a
# flipped int8 code moved them by up to 0.12 in the traces here)
NEAR_TIE = 0.05

_ENGINES: dict = {}


def _exec(mode, layer_overrides=()):
    if mode == "raceit_q8":
        return ExecConfig.serving(mode="raceit",
                                  layer_overrides=layer_overrides)
    return ExecConfig(mode="digital")


def _engines(mode, layer_overrides=()):
    """(reference engine, port engine) on the same weights, cached."""
    key = (mode, layer_overrides)
    if key not in _ENGINES:
        cfg = tiny_config(get_config(NAME))
        ec = _exec(mode, layer_overrides)
        ref = REngine(cfg, None, ec, max_len=MAX_LEN)
        p0 = ref.model.init(jax.random.PRNGKey(4))
        tparams = port_params(p0, cfg)
        if mode == "raceit_q8":
            ref.params = r_quantize(p0)
            tparams = t_quantize(tparams)
        else:
            ref.params = p0
        tec = port_exec_config(ec)
        if layer_overrides:
            tec = dataclasses.replace(tec, layer_overrides=layer_overrides)
        port = TEngine(port_model_config(cfg), tparams, tec,
                       max_len=MAX_LEN, device="cpu")
        _ENGINES[key] = (ref, port)
    return _ENGINES[key]


@pytest.fixture
def reference_norms(monkeypatch):
    """The port's norms return the reference's jitted values."""
    ref_norm = jax.jit(RL.apply_norm, static_argnums=2)

    def norm(p, x, cfg):  # the norm reads cfg.norm alone
        y = ref_norm({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                     jnp.asarray(x.numpy()), get_config(cfg.name))
        return torch.from_numpy(np.array(y))
    monkeypatch.setattr(TL, "apply_norm", norm)


def _trace(seed=0):
    """Prompts of 3, 8, 6 and 5 tokens, 10 new tokens
    each, so the 8-column rings wrap while decoding."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 255, n).astype(np.int32), 10)
            for i, n in enumerate((3, 8, 6, 5))]


def _run_both(ref, port, trace, **kw):
    """Both batchers on one trace, step by step: the same retirements every
    step, then the same tokens and counters."""
    rb, tb = RBatcher(ref, **kw), TBatcher(port, **kw)
    assert not rb.paged and not tb.paged
    for rid, prompt, n_new in trace:
        rb.submit(RRequest(rid, prompt, n_new=n_new))
        tb.submit(TRequest(rid, prompt, n_new=n_new))
    steps = 0
    while rb.queue or any(s is not None for s in rb.slots):
        assert rb.step() == tb.step()
        steps += 1
        assert steps < 200
    assert not tb.queue and all(s is None for s in tb.slots)
    for rid, req in rb.done.items():
        assert req.error is None and tb.done[rid].error is None
        assert tb.done[rid].result.tolist() == req.result.tolist(), rid
    rs, ts = rb.summary(), tb.summary()
    assert {k: ts[k] for k in _COUNTERS} == {k: rs[k] for k in _COUNTERS}
    return rb, tb


# ---------------------------------------------------------------- config

def test_gemma3_config_is_the_reference():
    assert NAME in PORTED
    cfg = t_get(NAME)
    assert cfg == port_model_config(get_config(NAME))
    mixers = [cfg.layer_spec(i)[0] for i in range(cfg.n_layers)]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.window) \
        == (34, 2560, 8, 4, 320, 10240, 262144, 1024)
    assert mixers.count("attn_local") == 29 and mixers.count("attn") == 5
    assert (cfg.activation, cfg.glu, cfg.norm, cfg.pos_emb, cfg.rope_theta,
            cfg.tie_embeddings) == ("gelu", True, "rmsnorm", "rope", 1e6,
                                    True)


# --------------------------------------------------------------- serving

@pytest.mark.parametrize("prefill_len", [8, 12])
@pytest.mark.parametrize("mode", MODES)
def test_pool_matches_reference(mode, prefill_len, reference_norms):
    """The contiguous slot pool (two slots, four requests): the reference's
    tokens and counters, the rings wrapping while decoding; at 12 the
    admission prefill overflows every local ring."""
    ref, port = _engines(mode)
    _, tb = _run_both(ref, port, _trace(), n_slots=2,
                      prefill_len=prefill_len)
    assert tb.prefills == 4 and tb.chunk_calls == 0


@pytest.mark.parametrize("prefill_len,same", [(8, 4), (12, 0)])
def test_pool_against_solo_digital(prefill_len, same):
    """In digital mode the pool gives every request its
    solo tokens while the pinned width is at most the window (8); past it
    (12) the reference's softening parts every request from its solo run
    in this trace, and the port counts as the reference does."""
    ref, port = _engines("digital")
    counts = []
    for eng, Batcher, Req in ((ref, RBatcher, RRequest),
                              (port, TBatcher, TRequest)):
        cb = Batcher(eng, n_slots=2, prefill_len=prefill_len)
        for rid, p, n in _trace():
            cb.submit(Req(rid, p, n_new=n))
        done = cb.run_all()
        counts.append(sum(
            eng.generate(p[None, :], n)[0].tolist() == done[rid].result.tolist()
            for rid, p, n in _trace()))
    assert counts == [same, same]


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


def _bucket_trace():
    """Two buckets of two: prompts of 12 (past the window) and 4 tokens,
    then 9 and 7; 5 new tokens each."""
    rng = np.random.default_rng(6)
    return [(i, rng.integers(0, 255, n).astype(np.int32), 5)
            for i, n in enumerate((12, 4, 9, 7))]


@pytest.mark.parametrize("mode", MODES)
def test_batch_scheduler_matches_reference(mode, reference_norms,
                                           monkeypatch):
    """Left-padded buckets whose long prompt overflows the rings: the
    reference's tokens (raceit_q8: up to a near tie) and counters."""
    ref, port = _engines(mode)
    logs = _recorded(ref, monkeypatch)
    rs, ts = RScheduler(ref, bucket_size=2), TScheduler(port, bucket_size=2)
    for rid, p, n in _bucket_trace():
        rs.submit(RRequest(rid, p, n_new=n))
        ts.submit(TRequest(rid, p, n_new=n))
    rd, td = rs.run_all(), ts.run_all()
    assert sorted(td) == sorted(rd) == [0, 1, 2, 3]
    # two buckets of two rows, five model calls each
    _agree([rd[r].result for r in rd], [td[r].result for r in rd],
           lambda r, i: logs[5 * (r // 2) + i][r % 2], mode)
    for k in ("model_calls", "tokens_out", "decode_steps", "decode_tokens"):
        assert getattr(ts, k) == getattr(rs, k), k


@pytest.mark.parametrize("plen", [5, 8, 12, 20])
@pytest.mark.parametrize("mode", MODES)
def test_generate_matches_reference(mode, plen, reference_norms,
                                    monkeypatch):
    """Solo `generate` of two rows: prompts shorter than, as long as and
    past the window (a 20-token prompt keeps its last 8 columns in every
    ring); the reference's tokens (raceit_q8: up to a near tie)."""
    ref, port = _engines(mode)
    logs = _recorded(ref, monkeypatch)
    prompts = np.random.default_rng(plen).integers(0, 255, (2, plen)
                                                   ).astype(np.int32)
    want = ref.generate(prompts, 10)
    got = port.generate(prompts, 10)
    assert (got[:, 0] == want[:, 0]).all()  # the prefill's token
    _agree(want, got, lambda b, i: logs[i][b], mode)


def test_generate_takes_the_q_blocked_prefill(monkeypatch):
    """A digital solo prompt of two windows takes the q-blocked local
    prefill in every local layer and gives the reference's tokens."""
    ref, port = _engines("digital")
    calls = []
    inner = TL._local_block_attention
    monkeypatch.setattr(TL, "_local_block_attention",
                        lambda *a: calls.append(a[0].shape) or inner(*a))
    prompts = np.random.default_rng(3).integers(0, 255, (1, 16)
                                                ).astype(np.int32)
    np.testing.assert_array_equal(port.generate(prompts, 6),
                                  ref.generate(prompts, 6))
    local = sum(port.cfg.layer_spec(i)[0] == "attn_local"
                for i in range(port.cfg.n_layers))
    assert len(calls) == local == 11


def test_bucket_first_token_exact_with_local_ring_overflow():
    """tests/test_serve_batching.py:203 on the port: a mixed bucket whose
    long prompt overflows the window still prefills exactly, so the first
    generated token of each request matches its solo run; and the tokens
    are the reference's."""
    ref, port = _engines("digital")
    rng = np.random.default_rng(4)
    long_p = rng.integers(0, 255, 12).astype(np.int32)
    short_p = rng.integers(0, 255, 4).astype(np.int32)
    solo = [port.generate(p[None, :], 2)[0] for p in (long_p, short_p)]
    done = {}
    for eng, Sched, Req in ((ref, RScheduler, RRequest),
                            (port, TScheduler, TRequest)):
        sched = Sched(eng, bucket_size=2)
        sched.submit(Req(0, long_p, n_new=2))
        sched.submit(Req(1, short_p, n_new=2))
        done[Sched] = sched.run_all()
    for i in range(2):
        got = done[TScheduler][i].result
        assert got[0] == solo[i][0], (i, got, solo[i])
        assert got.tolist() == done[RScheduler][i].result.tolist()


# ------------------------------------------------------------------ plans

_PLANS = {
    "serving-raceit": (ExecConfig.serving(mode="raceit"), ()),
    "serving": (ExecConfig.serving(), ()),
    "digital": (ExecConfig(mode="digital"), ()),
    "staged-local": (ExecConfig.serving(mode="raceit"), STAGED_LOCAL),
}


@pytest.mark.parametrize("which", list(_PLANS))
def test_plan_explain(which):
    """The resolved plan of tiny gemma3, and each mixer kind's plan under
    the staged-local recipe, print the reference's lines."""
    ec, lo = _PLANS[which]
    ec = dataclasses.replace(ec, layer_overrides=lo)
    cfg = tiny_config(get_config(NAME))
    tec = dataclasses.replace(port_exec_config(ec), layer_overrides=lo)
    rplan = r_resolve(cfg, ec)
    tplan = t_resolve(port_model_config(cfg), tec)
    assert tplan.explain().splitlines() == rplan.explain().splitlines()
    for kind in ("attn_local", "attn"):
        want = r_layer_plan(rplan, kind).explain().splitlines()
        assert t_layer_plan(tplan, kind).explain().splitlines() == want
    if lo:
        local = t_layer_plan(tplan, "attn_local")
        assert local.op("attention_prefill").backend == "raceit_staged"
        assert t_layer_plan(tplan, "attn") is tplan


def test_staged_local_recipe_serves_the_reference(reference_norms,
                                                  monkeypatch):
    """The recipe end to end through `generate`: the staged pipeline in
    the 11 local layers, the fused kernel in the 2 global ones, at prefill
    and at each decode step; the reference's tokens (up to a near tie)."""
    ref, port = _engines("raceit_q8", STAGED_LOCAL)
    logs = _recorded(ref, monkeypatch)
    seen = {"staged": 0, "fused": 0, "fused_decode": 0}
    for name, key in (("_raceit_staged_attention", "staged"),
                      ("_raceit_fused_attention", "fused"),
                      ("_raceit_gqa_decode", "fused_decode")):
        def call(*a, _fn=getattr(TL, name), _k=key, **kw):
            seen[_k] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(TL, name, call)
    prompts = np.random.default_rng(9).integers(0, 255, (2, 11)
                                                ).astype(np.int32)
    want = ref.generate(prompts, 6)
    got = port.generate(prompts, 6)
    assert (got[:, 0] == want[:, 0]).all()
    _agree(want, got, lambda b, i: logs[i][b], "raceit_q8")
    # the staged decode is float scores + ACAM softmax (no pipeline call)
    assert seen == {"staged": 11, "fused": 2, "fused_decode": 2 * 5}


# --------------------------------------------------- paged serving refuses

def test_paged_serving_refused_with_the_reference_reason():
    ref, port = _engines("digital")
    why = RBatcher.pageable_reason(ref)
    assert why is not None and "paged cache form" in why
    assert TBatcher.pageable_reason(port) == why
    with pytest.raises(ValueError,
                       match=re.escape(f"paged serving unsupported: {why}")):
        TBatcher(port, paged=True)
    assert not TBatcher(port).paged  # the default serves contiguous


# ------------------------------------------------------------- checkpoints

@pytest.mark.parametrize("n_layers", [13, 34])
def test_checkpoint_crosses_over(tmp_path, n_layers):
    """A reference checkpoint of tiny gemma3 (13 layers: 2 scan periods of
    6 and a tail of 1; 34 layers, gemma3-4b's depth: 5 periods and a tail
    of 4) loads into the port's layout leaf for leaf and gives the same
    prefill logits as the in-memory crossing."""
    cfg = tiny_config(get_config(NAME)).replace(n_layers=n_layers)
    assert (n_layers // cfg.block_period, n_layers % cfg.block_period) == \
        {13: (2, 1), 34: (5, 4)}[n_layers]
    params = RModel(cfg).init(jax.random.PRNGKey(5))
    CheckpointManager(str(tmp_path)).save(1, params)
    loaded = load_reference_checkpoint(tmp_path, port_model_config(cfg),
                                       device="cpu")
    in_memory = port_params(params, cfg)
    assert len(loaded["blocks"]) == n_layers
    for got, want in zip(loaded["blocks"], in_memory["blocks"]):
        for group in want:
            for leaf in want[group]:
                assert torch.equal(got[group][leaf], want[group][leaf])
    model = TModel(port_model_config(cfg), TExecConfig(), device="cpu")
    toks = torch.from_numpy(np.arange(1, 11, dtype=np.int32)[None])
    a, _ = model.prefill(loaded, toks, model.init_cache(1, 16))
    b, _ = model.prefill(in_memory, toks, model.init_cache(1, 16))
    assert torch.equal(a, b)
    rl, _ = RModel(cfg).prefill(params, jnp.asarray(toks.numpy()),
                                RModel(cfg).init_cache(1, 16))
    np.testing.assert_allclose(a.numpy(), np.asarray(rl), atol=1e-4)


# --------------------------------------------------------------- launcher

def test_launcher_serves_gemma3_from_the_pool(capsys):
    """`--arch gemma3-4b --continuous` picks the contiguous slot pool with
    no further flag, as the reference's launcher does."""
    from repro_torch.launch.serve import main
    done = main(["--arch", NAME, "--mode", "raceit_q8", "--continuous",
                 "--device", "cpu", "--requests", "3", "--n-new", "3",
                 "--max-len", "32", "--set", "n_layers=7", "d_model=64",
                 "n_heads=4", "n_kv_heads=2", "head_dim=16", "d_ff=128",
                 "vocab_size=256", "window=8"])
    assert sorted(done) == [0, 1, 2]
    assert all(r.error is None and len(r.result) == 3 for r in done.values())
    out = capsys.readouterr().out
    assert "contiguous slot KV" in out and "[serve] block-paged" not in out
    assert "0 chunk calls" in out and "3 prefills" in out
