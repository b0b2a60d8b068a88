"""Serving the two SSM models of the port against the reference, at
`tests/conftest.py` `tiny_config` size (d_model 64, 16 SSM heads of 8, state
16, chunk 8): mamba2-130m (2 Mamba layers, no attention, no FFN) and jamba
(one period of 8 layers: 7 Mamba and 1 attention layer, dense and MoE FFNs
in turn; 16 layers, two scan periods, for the checkpoint).

* The configurations are the reference's field for field, and in `PORTED`.
* The contiguous slot pool (2 slots, 4 requests whose prompts cross chunk
  boundaries, admission pinned at 20 = two and a half chunks), step by step:
  the reference's retirements, tokens and counters, in digital and raceit_q8
  mode; `BatchScheduler` and solo `generate` likewise. In raceit_q8 the
  port's norms (the RMSNorms and the mixer's gated norm) return the
  reference's jitted float values (XLA's CPU rsqrt and torch's differ in the
  last bit); where tokens part there, they must part at a near tie of the
  reference's logits (gap under `NEAR_TIE`, tests/test_torch_gemma3.py's
  rule), the port taking the reference's second best.
* Pool tokens against solo tokens, in digital mode: counted, not held. The
  SSM scans the admission prefill's left pads (the state a request starts
  from depends on its pad count), and jamba's expert capacity counts pad
  rows and idle slots; the port counts what the reference counts.
* The resolved plans print the reference's lines (mamba2-130m has no heads:
  the GQA predicate gives the reference's reason, no division by zero).
* Paged serving refuses both with the reference's reason; a reference
  checkpoint crosses over (a layer with no FFN gets no norm2); the launcher
  serves both from the contiguous pool.

Each test that takes a model runs mamba2-130m here; its jamba cases run
from tests/test_torch_ssm_serving_jamba.py, under the same names.
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
from repro.exec import resolve_plan as r_resolve  # noqa: E402
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
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.model import quantize_model_params as t_quantize  # noqa: E402
from repro_torch.serve import BatchScheduler as TScheduler  # noqa: E402
from repro_torch.serve import ContinuousBatcher as TBatcher  # noqa: E402
from repro_torch.serve import GenerationEngine as TEngine  # noqa: E402
from repro_torch.serve import Request as TRequest  # noqa: E402

from _torch_helpers import (port_exec_config, port_model_config,  # noqa: E402
                            port_params)
from conftest import tiny_config  # noqa: E402

MAMBA, JAMBA = "mamba2-130m", "jamba-v0.1-52b"
MODELS = (MAMBA, JAMBA)
# the per-model tests run mamba2-130m here and jamba, the heavier, from
# tests/test_torch_ssm_serving_jamba.py (pytest-xdist's --dist loadfile
# gives each file to one worker)
SERVED = (MAMBA,)
MODES = ("digital", "raceit_q8")
MAX_LEN = 64
PREFILL_LEN = 20
# the widest top-2 gap of the reference's logits at which raceit_q8 tokens
# may part (tests/test_torch_gemma3.py's rule)
NEAR_TIE = 0.05
_COUNTERS = ("requests_done", "prefills", "decode_steps", "decode_tokens",
             "tokens_out", "model_calls", "router_policy", "router_rejected",
             "queue_depths", "ttft_p50", "tpl_p50")

_ENGINES: dict = {}


def _tiny(name):
    cfg = tiny_config(get_config(name))
    return cfg.replace(n_layers=8) if name == JAMBA else cfg


def _exec(mode):
    return (ExecConfig.serving(mode="raceit") if mode == "raceit_q8"
            else ExecConfig(mode="digital"))


def _engines(name, mode):
    """(reference engine, port engine) on the same weights, cached."""
    key = (name, mode)
    if key not in _ENGINES:
        cfg = _tiny(name)
        ec = _exec(mode)
        ref = REngine(cfg, None, ec, max_len=MAX_LEN)
        p0 = ref.model.init(jax.random.PRNGKey(4))
        tparams = port_params(p0, cfg)
        if mode == "raceit_q8":
            ref.params = r_quantize(p0)
            tparams = t_quantize(tparams)
        else:
            ref.params = p0
        port = TEngine(port_model_config(cfg), tparams, port_exec_config(ec),
                       max_len=MAX_LEN, device="cpu")
        _ENGINES[key] = (ref, port)
    return _ENGINES[key]


_REF_NORM = jax.jit(RL.apply_norm, static_argnums=2)


@jax.jit
def _ref_gated_norm(y, z, scale):
    """The reference's gated RMSNorm lines (ref ssm.py, before out_proj)."""
    g = y.astype(jnp.float32) * jax.nn.silu(z.astype(jnp.float32))
    g = g * jax.lax.rsqrt(jnp.mean(g * g, -1, keepdims=True) + 1e-6)
    return g * scale.astype(jnp.float32)


@pytest.fixture
def reference_norms(monkeypatch):
    """The port's norms return the reference's jitted values."""
    def norm(p, x, cfg):  # the norm reads cfg.norm alone
        y = _REF_NORM({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                      jnp.asarray(x.numpy()), get_config(cfg.name))
        return torch.from_numpy(np.array(y))

    def gated(y, z, scale, eps):
        assert eps == 1e-6  # the reference's
        out = _ref_gated_norm(*(jnp.asarray(t.numpy()) for t in (y, z, scale)))
        return torch.from_numpy(np.array(out))
    monkeypatch.setattr(TL, "apply_norm", norm)
    monkeypatch.setattr(TS, "gated_norm", gated)


def _trace(seed=0, lens=(3, 9, 17, 6), n_new=5):
    """More requests than slots; prompts shorter than a chunk, one past a
    chunk and two past."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 255, n).astype(np.int32), n_new)
            for i, n in enumerate(lens)]


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
    assert sorted(tb.done) == sorted(rb.done)
    for rid, req in rb.done.items():
        assert req.error is None and tb.done[rid].error is None
        assert tb.done[rid].result.tolist() == req.result.tolist(), rid
    rs, ts = rb.summary(), tb.summary()
    assert {k: ts[k] for k in _COUNTERS} == {k: rs[k] for k in _COUNTERS}
    return rb, tb


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


# ---------------------------------------------------------------- configs

def test_configs_are_the_reference():
    for name in MODELS:
        assert name in PORTED
        assert t_get(name) == port_model_config(get_config(name))
    m, j = t_get(MAMBA), t_get(JAMBA)
    assert (m.n_layers, m.d_model, m.d_inner, m.ssm_heads, m.ssm_headdim,
            m.ssm_state, m.ssm_chunk, m.vocab_size, m.tie_embeddings) == (
        24, 768, 1536, 24, 64, 128, 128, 50280, True)
    assert {m.layer_spec(i) for i in range(24)} == {("mamba", "none")}
    assert (j.d_model, j.n_heads, j.n_kv_heads, j.resolved_head_dim,
            j.d_inner, j.ssm_heads, j.n_experts, j.top_k, j.d_ff,
            j.vocab_size, j.pos_emb, j.block_period) == (
        4096, 32, 8, 128, 8192, 128, 16, 2, 14336, 65536, "none", 8)
    spec = [j.layer_spec(i) for i in range(8)]
    assert [s[0] for s in spec].count("attn") == 1 and spec[4][0] == "attn"
    assert [s[1] for s in spec] == ["dense", "moe"] * 4


# ---------------------------------------------------------------- serving

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SERVED)
def test_pool_matches_reference(name, mode, reference_norms):
    """The contiguous slot pool: the reference's tokens and counters; every
    decode step updates every slot's state, idle ones included."""
    ref, port = _engines(name, mode)
    _, tb = _run_both(ref, port, _trace(), n_slots=2, prefill_len=PREFILL_LEN)
    assert tb.prefills == 4 and tb.chunk_calls == 0
    layer0 = tb.cache[0]
    assert "mamba" in layer0 and "attn" not in layer0
    if name == JAMBA:
        assert tb.cache[4]["attn"]["idx"].shape == (2,)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SERVED)
def test_generate_matches_reference(name, mode, reference_norms, monkeypatch):
    """Solo `generate` of two rows, prompts of one token (the recurrent step
    at prefill) and past two chunks: the reference's tokens (raceit_q8: up
    to a near tie)."""
    ref, port = _engines(name, mode)
    logs = _recorded(ref, monkeypatch)
    for plen in (1, 19):
        logs.clear()
        prompts = np.random.default_rng(plen).integers(0, 255, (2, plen)
                                                       ).astype(np.int32)
        want = ref.generate(prompts, 6)
        got = port.generate(prompts, 6)
        assert (got[:, 0] == want[:, 0]).all()  # the prefill's token
        _agree(want, got, lambda b, i: logs[i][b], mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SERVED)
def test_batch_scheduler_matches_reference(name, mode, reference_norms,
                                           monkeypatch):
    """Left-padded buckets of two (the SSM scans the pads, as in the
    reference): the reference's tokens (raceit_q8: up to a near tie) and
    counters."""
    ref, port = _engines(name, mode)
    logs = _recorded(ref, monkeypatch)
    rs, ts = RScheduler(ref, bucket_size=2), TScheduler(port, bucket_size=2)
    trace = _trace(6, lens=(12, 4, 9, 7), n_new=5)
    for rid, p, n in trace:
        rs.submit(RRequest(rid, p, n_new=n))
        ts.submit(TRequest(rid, p, n_new=n))
    rd, td = rs.run_all(), ts.run_all()
    assert sorted(td) == sorted(rd) == [0, 1, 2, 3]
    # two buckets of two rows, five model calls each
    _agree([rd[r].result for r in rd], [td[r].result for r in rd],
           lambda r, i: logs[5 * (r // 2) + i][r % 2], mode)
    for k in ("model_calls", "tokens_out", "decode_steps", "decode_tokens"):
        assert getattr(ts, k) == getattr(rs, k), k


@pytest.mark.parametrize("name", SERVED)
def test_pool_against_solo_digital(name):
    """Digital pool tokens against solo `generate` tokens: counted, not
    held (the SSM scans the admission prefill's left pads; jamba's expert
    capacity counts pad rows and idle slots). The port counts what the
    reference counts."""
    ref, port = _engines(name, "digital")
    counts = []
    for eng, Batcher, Req in ((ref, RBatcher, RRequest),
                              (port, TBatcher, TRequest)):
        cb = Batcher(eng, n_slots=2, prefill_len=PREFILL_LEN)
        for rid, p, n in _trace():
            cb.submit(Req(rid, p, n_new=n))
        done = cb.run_all()
        counts.append(sum(
            eng.generate(p[None, :], n)[0].tolist() == done[rid].result.tolist()
            for rid, p, n in _trace()))
    assert counts[0] == counts[1]


# ------------------------------------------------------------------ plans

@pytest.mark.parametrize("which", ["serving-raceit", "serving", "digital"])
@pytest.mark.parametrize("name", SERVED)
def test_plan_explain(name, which):
    ec = {"serving-raceit": ExecConfig.serving(mode="raceit"),
          "serving": ExecConfig.serving(),
          "digital": ExecConfig(mode="digital")}[which]
    cfg = _tiny(name)
    want = r_resolve(cfg, ec).explain().splitlines()
    got = t_resolve(port_model_config(cfg), port_exec_config(ec))
    assert got.explain().splitlines() == want
    if name == MAMBA and which == "serving-raceit":
        assert any("n_kv_heads=0 == n_heads=0" in line for line in want)


# --------------------------------------------------- paged serving refuses

@pytest.mark.parametrize("name", SERVED)
def test_paged_serving_refused_with_the_reference_reason(name):
    ref, port = _engines(name, "digital")
    why = RBatcher.pageable_reason(ref)
    assert why is not None and "paged cache form" in why
    assert TBatcher.pageable_reason(port) == why
    with pytest.raises(ValueError,
                       match=re.escape(f"paged serving unsupported: {why}")):
        TBatcher(port, paged=True)
    assert not TBatcher(port).paged  # the default serves contiguous
    with pytest.raises(NotImplementedError, match="state layout"):
        port.model.init_slot_cache(2, 32, page_size=8, n_pages=9)


# ------------------------------------------------------------- checkpoints

@pytest.mark.parametrize("name", SERVED)
def test_checkpoint_crosses_over(tmp_path, name):
    """A reference checkpoint (mamba2: 2 layers, 2 scan periods of 1;
    jamba: 16 layers, 2 scan periods of 8) loads into the port's layout leaf
    for leaf, with no norm2 where a layer has no FFN, and gives the same
    prefill logits as the in-memory crossing and the reference's."""
    cfg = tiny_config(get_config(name))
    params = RModel(cfg).init(jax.random.PRNGKey(5))
    CheckpointManager(str(tmp_path)).save(1, params)
    tcfg = port_model_config(cfg)
    loaded = load_reference_checkpoint(tmp_path, tcfg, device="cpu")
    in_memory = port_params(params, cfg)
    assert len(loaded["blocks"]) == cfg.n_layers == {MAMBA: 2, JAMBA: 16}[name]
    for i, (got, want) in enumerate(zip(loaded["blocks"], in_memory["blocks"])):
        assert sorted(got) == sorted(want)
        assert ("norm2" in got) == (cfg.layer_spec(i)[1] != "none")
        for group in want:
            for leaf in want[group]:
                assert torch.equal(got[group][leaf], want[group][leaf])
    model = TModel(tcfg, TExecConfig(), device="cpu")
    toks = torch.from_numpy(np.arange(1, 12, dtype=np.int32)[None])
    a, _ = model.prefill(loaded, toks, model.init_cache(1, 16))
    b, _ = model.prefill(in_memory, toks, model.init_cache(1, 16))
    assert torch.equal(a, b)
    rl, _ = RModel(cfg).prefill(params, jnp.asarray(toks.numpy()),
                                RModel(cfg).init_cache(1, 16))
    np.testing.assert_allclose(a.numpy(), np.asarray(rl), atol=1e-4)


# --------------------------------------------------------------- launcher

@pytest.mark.parametrize("name", SERVED)
def test_launcher_serves_from_the_pool(name, capsys):
    """`--continuous` serves both models from the contiguous slot pool with
    no further flag; ``--prefill-len`` pins the admission width."""
    from repro_torch.launch.serve import main
    argv = ["--arch", name, "--mode", "raceit_q8", "--continuous",
            "--device", "cpu", "--requests", "3", "--n-new", "3",
            "--max-len", "32", "--prefill-len", "12", "--set", "d_model=64",
            "vocab_size=256", "ssm_state=16", "ssm_headdim=8", "ssm_chunk=8"]
    argv += (["n_layers=2"] if name == MAMBA else
             ["n_layers=8", "n_heads=4", "n_kv_heads=2", "head_dim=16",
              "d_ff=128", "n_experts=4"])
    done = main(argv)
    assert sorted(done) == [0, 1, 2]
    assert all(r.error is None and len(r.result) == 3 for r in done.values())
    out = capsys.readouterr().out
    assert "contiguous slot KV" in out and "[serve] block-paged" not in out
    assert "0 chunk calls" in out and "3 prefills" in out
    assert "admission prefill width 12" in out
