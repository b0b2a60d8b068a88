"""Serving the two MoE models of the port against the reference, at
`tests/conftest.py` `tiny_config` size (2 layers, d_model 64, 4 experts,
window 8), in digital and raceit_q8 mode, at capacity factors 8.0 (no
drops) and 1.25 (choices drop, and the capacity counts every row of a call:
pad rows and idle slots too).

* mixtral-8x22b (sliding-window layers, top-2) through the contiguous slot
  pool at ``prefill_len`` 8 (the window) and 12 (past it), step by step:
  the reference's retirements, tokens and counters; and through solo
  `generate`. llama4-scout (global layers, 40 of 48 heads real, top-1)
  through the paged batcher. In raceit_q8 the port's norms return the
  reference's float values, as in tests/test_torch_generate.py (XLA's CPU
  rsqrt and torch's differ in the last bit). Where `generate` tokens part
  in raceit_q8, they part at a near tie of the reference's logits (gap
  under `NEAR_TIE`, tests/test_torch_gemma3.py's rule), the port taking
  the reference's second best.
* Pool tokens against solo tokens, in digital mode: counted, not held. The
  capacity of an expert counts the pool's pad rows and idle slots, so a
  request's routing depends on its batch-mates; the port counts as the
  reference does.
* Paged serving refuses mixtral with the reference's reason and serves
  llama4-scout by default; the launcher serves both on the CPU.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ExecConfig  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.model import quantize_model_params as r_quantize  # noqa: E402
from repro.serve import ContinuousBatcher as RBatcher  # noqa: E402
from repro.serve import GenerationEngine as REngine  # noqa: E402
from repro.serve import Request as RRequest  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.model import quantize_model_params as t_quantize  # noqa: E402
from repro_torch.serve import ContinuousBatcher as TBatcher  # noqa: E402
from repro_torch.serve import GenerationEngine as TEngine  # noqa: E402
from repro_torch.serve import Request as TRequest  # noqa: E402

from _torch_helpers import (port_exec_config, port_model_config,  # noqa: E402
                            port_params)
from conftest import tiny_config  # noqa: E402

MIXTRAL, LLAMA4 = "mixtral-8x22b", "llama4-scout-17b-a16e"
MAX_LEN = 64
MODES = ("digital", "raceit_q8")
FACTORS = (8.0, 1.25)
# the widest top-2 gap of the reference's logits at which raceit_q8 tokens
# may part (tests/test_torch_gemma3.py's rule)
NEAR_TIE = 0.05
_COUNTERS = ("requests_done", "prefills", "decode_steps", "decode_tokens",
             "tokens_out", "model_calls", "router_policy", "router_rejected",
             "queue_depths", "ttft_p50", "tpl_p50")
_PAGED_COUNTERS = _COUNTERS + ("chunk_calls", "pages_in_use", "pages_shared",
                               "pages_leaked", "pages_free",
                               "pages_peak_in_use", "prefix_hit_pages",
                               "prefix_promotions")

_ENGINES: dict = {}


def _engines(name, mode, cf):
    """(reference engine, port engine) on the same weights, cached."""
    key = (name, mode, cf)
    if key not in _ENGINES:
        cfg = tiny_config(get_config(name)).replace(capacity_factor=cf)
        ec = (ExecConfig.serving(mode="raceit") if mode == "raceit_q8"
              else ExecConfig(mode="digital"))
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


@pytest.fixture
def reference_norms(monkeypatch):
    """The port's norms return the reference's jitted values."""
    ref_norm = jax.jit(RL.apply_norm, static_argnums=2)

    def norm(p, x, cfg):  # the norm reads cfg.norm alone
        y = ref_norm({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                     jnp.asarray(x.numpy()), get_config(cfg.name))
        return torch.from_numpy(np.array(y))
    monkeypatch.setattr(TL, "apply_norm", norm)


@pytest.fixture
def dropped(monkeypatch):
    """Counts the (token, choice) pairs the port's routing drops."""
    seen = []
    inner = TM.route

    def route(*a, **kw):
        r = inner(*a, **kw)
        seen.append(int((~r.keep).sum()))
        return r
    monkeypatch.setattr(TM, "route", route)
    return seen


def _trace(seed=0, lens=(3, 8, 6, 5), n_new=10):
    """More requests than slots, 10 new tokens each, so the 8-column rings
    wrap while decoding."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 255, n).astype(np.int32), n_new)
            for i, n in enumerate(lens)]


def _run_both(ref, port, trace, counters=_COUNTERS, **kw):
    """Both batchers on one trace, step by step: the same retirements every
    step, then the same tokens and counters."""
    rb, tb = RBatcher(ref, **kw), TBatcher(port, **kw)
    assert rb.paged == tb.paged
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
    assert {k: ts[k] for k in counters} == {k: rs[k] for k in counters}
    return rb, tb


# ----------------------------------------------------------- mixtral pool

@pytest.mark.parametrize("prefill_len", [8, 12])
@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("mode", MODES)
def test_mixtral_pool_matches_reference(mode, cf, prefill_len,
                                        reference_norms, dropped):
    """The contiguous slot pool (two slots, four requests): the reference's
    tokens and counters; at 1.25 the pool's calls drop choices."""
    ref, port = _engines(MIXTRAL, mode, cf)
    _, tb = _run_both(ref, port, _trace(), n_slots=2,
                      prefill_len=prefill_len)
    assert not tb.paged and tb.prefills == 4 and tb.chunk_calls == 0
    assert (sum(dropped) > 0) == (cf == 1.25)


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


def _agree(want, got, logs, mode):
    """Rows of greedy tokens: equal in digital; in raceit_q8 equal up to a
    parting at a near tie of the reference's logits, where the port took
    the reference's second best."""
    for b, (w, g) in enumerate(zip(want, got)):
        part = next((i for i, (x, y) in enumerate(zip(w, g)) if x != y),
                    None)
        if part is None:
            continue
        assert mode == "raceit_q8", (b, w, g)
        lg = logs[part][b]
        top2 = np.argsort(-lg)[:2]
        assert g[part] == top2[1], (b, part, w, g)
        assert lg[top2[0]] - lg[top2[1]] < NEAR_TIE, (b, part)


@pytest.mark.parametrize("plen", [5, 12])
@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("mode", MODES)
def test_mixtral_generate_matches_reference(mode, cf, plen, reference_norms,
                                            monkeypatch):
    """Solo `generate` of two rows, prompts inside and past the window:
    the reference's tokens (raceit_q8: up to a near tie)."""
    ref, port = _engines(MIXTRAL, mode, cf)
    logs = _recorded(ref, monkeypatch)
    prompts = np.random.default_rng(plen).integers(0, 255, (2, plen)
                                                   ).astype(np.int32)
    want = ref.generate(prompts, 8)
    got = port.generate(prompts, 8)
    assert (got[:, 0] == want[:, 0]).all()  # the prefill's token
    _agree(want, got, logs, mode)


@pytest.mark.parametrize("cf,same", [(8.0, 4), (1.25, 1)])
def test_mixtral_pool_against_solo_digital(cf, same):
    """Digital pool tokens against solo `generate` tokens: counted, not
    held. At 8.0 nothing drops and every request gets its solo tokens; at
    1.25 a request's routing depends on its batch-mates (pad rows and idle
    slots count toward the capacity), and the port counts what the
    reference counts."""
    ref, port = _engines(MIXTRAL, "digital", cf)
    counts = []
    for eng, Batcher, Req in ((ref, RBatcher, RRequest),
                              (port, TBatcher, TRequest)):
        cb = Batcher(eng, n_slots=2, prefill_len=8)
        for rid, p, n in _trace():
            cb.submit(Req(rid, p, n_new=n))
        done = cb.run_all()
        counts.append(sum(
            eng.generate(p[None, :], n)[0].tolist() == done[rid].result.tolist()
            for rid, p, n in _trace()))
    assert counts == [same, same]


def test_mixtral_paged_refused_with_the_reference_reason():
    ref, port = _engines(MIXTRAL, "digital", 8.0)
    why = RBatcher.pageable_reason(ref)
    assert why is not None and "paged cache form" in why
    assert TBatcher.pageable_reason(port) == why
    with pytest.raises(ValueError,
                       match=re.escape(f"paged serving unsupported: {why}")):
        TBatcher(port, paged=True)
    assert not TBatcher(port).paged  # the default serves contiguous


# ---------------------------------------------------------- llama4 paged

@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("mode", MODES)
def test_llama4_paged_matches_reference(mode, cf, reference_norms, dropped):
    """The paged batcher (three slots, 8-token pages, chunked prefill) over
    padded heads (4 real of 6): the reference's tokens and counters."""
    ref, port = _engines(LLAMA4, mode, cf)
    assert TBatcher.pageable_reason(port) is None
    _, tb = _run_both(ref, port, _trace(1, lens=(7, 3, 12, 2, 6), n_new=5),
                      _PAGED_COUNTERS, n_slots=3, page_size=8, n_pages=9)
    assert tb.paged and tb.chunk_calls > 0
    assert (sum(dropped) > 0) == (cf == 1.25)


# --------------------------------------------------------------- launcher

@pytest.mark.parametrize("name", [MIXTRAL, LLAMA4])
def test_launcher_serves_tiny_moe(name, capsys):
    """`--continuous` serves mixtral from the contiguous pool and
    llama4-scout block-paged, with no further flag."""
    from repro_torch.launch.serve import main
    argv = ["--arch", name, "--mode", "raceit_q8", "--continuous",
            "--device", "cpu", "--requests", "3", "--n-new", "3",
            "--max-len", "32", "--set", "n_layers=2", "d_model=64",
            "n_heads=4", "n_kv_heads=2", "head_dim=16", "d_ff=128",
            "vocab_size=256", "window=8", "n_experts=4"]
    if name == LLAMA4:
        argv += ["head_pad_to=6", "--page-size", "8"]
    done = main(argv)
    assert sorted(done) == [0, 1, 2]
    assert all(r.error is None and len(r.result) == 3 for r in done.values())
    out = capsys.readouterr().out
    if name == MIXTRAL:
        assert "contiguous slot KV" in out and "[serve] block-paged" not in out
        assert "0 chunk calls" in out and "3 prefills" in out
    else:
        assert "block-paged KV" in out
