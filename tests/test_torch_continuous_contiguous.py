"""The contiguous slot pool of the port's continuous batcher, and the two
dense decoders added with it, against the reference.

* The contiguous cases of tests/test_serve_continuous.py (``paged=False``,
  an explicit ``prefill_len``, the jointly infeasible queue, the fully
  quarantined pool): the same tokens, errors and counters as the
  reference's batcher. The reference makes its decode faults with its noise
  model, which the port does not have; the port's decode step is made to
  return non-finite logits on the same rows.
* raceit_q8 serving of tiny gpt2-large, command-r-35b, olmo-1b
  (non-parametric LayerNorm, tied embeddings, SiLU-GLU, RoPE) and
  starcoder2-15b (qkv biases, GQA, GELU) through the contiguous pool and
  the paged batcher: the reference's tokens and counters. The port's norms
  return the reference's float values there, as in
  tests/test_torch_generate.py: XLA's CPU rsqrt and torch's differ in the
  last bit, and at an int8 rounding boundary that ulp moves a code (olmo-1b
  on the paged trace of seed 10 meets one). In digital mode a request's
  tokens equal serving it alone.
* The two models' resolved plans print the reference's lines, and their
  weights cross over through a reference checkpoint.
* The launcher's ``--prefill-len`` picks the contiguous pool.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import CheckpointManager  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.configs.base import ExecConfig  # noqa: E402
from repro.models import Model as RModel  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.model import quantize_model_params as r_quantize  # noqa: E402
from repro.serve import ContinuousBatcher as RBatcher  # noqa: E402
from repro.serve import GenerationEngine as REngine  # noqa: E402
from repro.serve import Request as RRequest  # noqa: E402
from repro_torch.ckpt import load_reference_checkpoint  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.model import quantize_model_params as t_quantize  # noqa: E402
from repro_torch.serve import ContinuousBatcher as TBatcher  # noqa: E402
from repro_torch.serve import GenerationEngine as TEngine  # noqa: E402
from repro_torch.serve import Request as TRequest  # noqa: E402

from _torch_helpers import (port_exec_config, port_model_config,  # noqa: E402
                            port_params)
from conftest import tiny_config  # noqa: E402

MAX_LEN = 64
MODELS = ("gpt2-large", "command-r-35b", "olmo-1b", "starcoder2-15b")
NEW_MODELS = ("olmo-1b", "starcoder2-15b")
_COUNTERS = ("requests_done", "prefills", "decode_steps", "decode_tokens",
             "tokens_out", "model_calls", "router_policy", "router_rejected",
             "queue_depths", "ttft_p50", "tpl_p50")
_PAGED_COUNTERS = _COUNTERS + ("chunk_calls", "pages_in_use", "pages_shared",
                               "pages_leaked", "pages_free",
                               "pages_peak_in_use", "prefix_hit_pages",
                               "prefix_promotions")

_ENGINES: dict = {}


def _engines(name, mode):
    """(reference engine, port engine) on the same weights, cached."""
    key = (name, mode)
    if key not in _ENGINES:
        cfg = tiny_config(get_config(name))
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


def _trace(seed, n=5):
    """Mixed prompt lengths and n_new, more requests than slots."""
    rng = np.random.default_rng(seed)
    lens = (7, 3, 5, 2, 6, 4, 8)[:n]
    nnew = (4, 2, 6, 1, 3, 5, 2)[:n]
    return [(i, rng.integers(0, 255, ln).astype(np.int32), nn)
            for i, (ln, nn) in enumerate(zip(lens, nnew))]


def _run_both(ref, port, trace, counters=_COUNTERS, **kw):
    """Both batchers on one trace, step by step: the same retirements every
    step, then the same tokens, errors and counters."""
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
        got = tb.done[rid]
        assert (req.error is None) == (got.error is None), rid
        if req.error is None:
            assert got.result.tolist() == req.result.tolist(), rid
    rs, ts = rb.summary(), tb.summary()
    assert {k: ts[k] for k in counters} == {k: rs[k] for k in counters}
    assert ("chunk_calls" in ts) == ("chunk_calls" in rs)
    return rb, tb


@pytest.mark.parametrize("kw", [dict(paged=False), dict(prefill_len=8)],
                         ids=["paged-False", "prefill_len-8"])
@pytest.mark.parametrize("name", MODELS)
def test_contiguous_pool_matches_reference(name, kw, reference_norms):
    """raceit_q8 on the contiguous pool (the serving decode backends on a
    per-slot kv_len vector, the left-padded admission prefill): the
    reference's tokens and counters, two slots, five requests."""
    ref, port = _engines(name, "raceit_q8")
    rb, tb = _run_both(ref, port, _trace(3), n_slots=2, **kw)
    assert not tb.paged and tb.prefill_len == (kw.get("prefill_len") or 7)
    assert tb.summary()["model_calls"] == tb.decode_steps + tb.prefills


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", NEW_MODELS)
def test_paged_serving_of_the_new_models(name, seed, reference_norms):
    """The two new decoders through the paged batcher (8-token pages)."""
    ref, port = _engines(name, "raceit_q8")
    rb, tb = _run_both(ref, port, _trace(10 + seed), _PAGED_COUNTERS,
                       n_slots=3, page_size=8, n_pages=9)
    assert tb.paged and tb.chunk_calls > 0


@pytest.mark.parametrize("name", ["gpt2-large", "olmo-1b"])
def test_contiguous_pool_matches_solo_digital(name):
    """Digital greedy: every request's tokens equal serving it alone, and
    the pinned width takes one prefill per request."""
    _, port = _engines(name, "digital")
    trace = _trace(5)
    solo = [port.generate(p[None, :], n)[0] for _, p, n in trace]
    cb = TBatcher(port, n_slots=2, paged=False)
    for rid, p, n in trace:
        cb.submit(TRequest(rid, p, n_new=n))
    done = cb.run_all()
    for (rid, _, _), want in zip(trace, solo):
        np.testing.assert_array_equal(done[rid].result, want)
    assert cb.prefills == len(trace) and cb.chunk_calls == 0


def test_prompt_longer_than_pinned_width_rejected():
    """tests/test_serve_continuous.py:151: a prompt past prefill_len, and a
    pinned width plus n_new past max_len, are refused at submit."""
    _, port = _engines("gpt2-large", "digital")
    cb = TBatcher(port, n_slots=2, prefill_len=4)
    assert not cb.paged
    with pytest.raises(ValueError, match="prefill_len=4"):
        cb.submit(TRequest(0, np.arange(9, dtype=np.int32), n_new=2))
    with pytest.raises(ValueError, match="max_len"):
        cb.submit(TRequest(1, np.arange(3, dtype=np.int32), n_new=61))
    with pytest.raises(ValueError, match="prefill_len pins"):
        TBatcher(port, paged=True, prefill_len=4)
    with pytest.raises(ValueError, match="prefix cache"):
        TBatcher(port, paged=False, prefix_cache=True)


def test_jointly_infeasible_queue_fails_fast_with_state_intact():
    """tests/test_serve_continuous.py:158: the width locks to the longest
    queued prompt at the first admission; requests that cannot all fit it
    fail there, with nothing admitted and the queue intact."""
    ref, port = _engines("gpt2-large", "digital")
    batchers = (RBatcher(ref, n_slots=2, paged=False),
                TBatcher(port, n_slots=2, paged=False))
    for cb, Req in zip(batchers, (RRequest, TRequest)):
        cb.submit(Req(0, np.arange(4, dtype=np.int32), n_new=60))
        cb.submit(Req(1, np.arange(8, dtype=np.int32), n_new=1))
        with pytest.raises(ValueError, match="jointly infeasible"):
            cb.run_all()
        assert len(cb.queue) == 2 and all(s is None for s in cb.slots)
        assert cb.prefill_len is None


def _faulting_decode(port, rows):
    """The port engine's decode step returning NaN logits on ``rows``."""
    inner = port._decode

    def decode(*a, **kw):
        logits, cache = inner(*a, **kw)
        logits = logits.clone()
        logits[list(rows)] = float("nan")
        return logits, cache
    return decode


def test_all_slots_quarantined_drains_queue(monkeypatch):
    """tests/test_serve_continuous.py:296: with every decode row faulting,
    the one slot is quarantined at its first decode step and the rest of
    the queue retires with admit-stage errors; the same errors, dead slots
    and counters as the reference's noisy fault run."""
    import dataclasses

    from repro.hw.noise import NoiseConfig
    nz = dataclasses.replace(NoiseConfig.preset("worst_case", seed=1),
                             fault_rate=1.0)
    ec = ExecConfig(mode="digital", noise=nz).with_ops(
        attention_decode="raceit_noisy_staged")
    cfg = tiny_config(get_config("gpt2-large"))
    ref = REngine(cfg, RModel(cfg, ec).init(jax.random.PRNGKey(0)), ec,
                  max_len=MAX_LEN)
    _, port = _engines("gpt2-large", "digital")
    monkeypatch.setattr(port, "_decode", _faulting_decode(port, [0]))
    rng = np.random.default_rng(8)
    trace = [(rid, rng.integers(0, 255, 5).astype(np.int32), 4)
             for rid in range(3)]
    rb, tb = _run_both(ref, port, trace, n_slots=1, prefill_len=5)
    for cb in (rb, tb):
        assert cb.dead_slots == {0}
        assert all(cb.done[r].error is not None
                   and cb.done[r].result is None for r in cb.done)
    assert [tb.done[r].error.stage for r in range(3)] == \
        [rb.done[r].error.stage for r in range(3)] == \
        ["decode", "admit", "admit"]


def test_decode_writes_past_the_buffer_are_dropped():
    """An empty slot's write index keeps counting across decode steps; past
    the buffer its writes are dropped (as the reference's scatter drops
    them) and every other row is written as before."""
    _, port = _engines("gpt2-large", "digital")
    model = port.model
    cache = model.init_slot_cache(3, 8)
    for layer in cache:
        layer["attn"]["idx"].copy_(torch.tensor([2, 8, 11]))
    before = [layer["attn"]["k"].clone() for layer in cache]
    tok = torch.tensor([[5], [6], [7]], dtype=torch.int32)
    _, cache = model.decode_step(port.params, tok, cache,
                                 slot_lens=torch.tensor([3, 0, 0]))
    for layer, old in zip(cache, before):
        k = layer["attn"]["k"]
        assert not torch.equal(k[0, 2], old[0, 2])
        assert torch.equal(k[1:], old[1:])
        assert layer["attn"]["idx"].tolist() == [3, 9, 12]


@pytest.mark.parametrize("name", NEW_MODELS)
def test_plan_explain_of_the_new_models(name):
    from repro.exec import resolve_plan as r_resolve
    from repro_torch.exec import resolve_plan as t_resolve
    cfg = tiny_config(get_config(name))
    for ec in (ExecConfig.serving(mode="raceit"), ExecConfig.serving(),
               ExecConfig(mode="digital")):
        want = r_resolve(cfg, ec).explain()
        got = t_resolve(port_model_config(cfg), port_exec_config(ec)
                        ).explain()
        assert got.splitlines() == want.splitlines()


@pytest.mark.parametrize("name", NEW_MODELS)
def test_new_models_at_published_width(name):
    """The port's catalog holds the reference's configuration field for
    field."""
    from repro_torch.configs import get_config as t_get
    from repro_torch.configs.catalog import PORTED
    assert name in PORTED
    assert t_get(name) == port_model_config(get_config(name))


@pytest.mark.parametrize("name", NEW_MODELS)
def test_new_models_cross_over_through_a_checkpoint(tmp_path, name):
    """olmo-1b's LayerNorms have no parameters (empty dicts, which a
    checkpoint does not store) and its unembedding is the token embedding;
    starcoder2-15b has q/k/v biases: the port reads them all back."""
    cfg = tiny_config(get_config(name))
    params = RModel(cfg).init(jax.random.PRNGKey(5))
    CheckpointManager(str(tmp_path)).save(1, params)
    loaded = load_reference_checkpoint(tmp_path, port_model_config(cfg),
                                       device="cpu")
    in_memory = port_params(params, cfg)
    assert loaded.keys() == in_memory.keys()
    assert len(loaded["blocks"]) == cfg.n_layers
    for got, want in zip(loaded["blocks"], in_memory["blocks"]):
        assert got.keys() == want.keys()
        for group in got:
            assert got[group].keys() == want[group].keys(), group
            for leaf in got[group]:
                assert torch.equal(got[group][leaf], want[group][leaf])
    if name == "olmo-1b":
        assert loaded["final_norm"] == {} and "unembed" not in loaded["embed"]
    else:
        assert {"bq", "bk", "bv"} <= loaded["blocks"][0]["attn"].keys()
    eng = TEngine(port_model_config(cfg), loaded, ExecConfig(),
                  max_len=MAX_LEN, device="cpu")
    out = eng.generate(np.arange(1, 6, dtype=np.int32)[None], 3)
    assert out.shape == (1, 3)


@pytest.mark.parametrize("prefill_len", [None, 16])
def test_launcher_prefill_len_picks_the_contiguous_pool(capsys, prefill_len):
    """`--continuous` alone serves paged; `--prefill-len` pins the
    contiguous pool, as in the reference."""
    from repro_torch.launch.serve import main
    argv = ["--arch", "olmo-1b", "--mode", "raceit_q8", "--continuous",
            "--device", "cpu", "--requests", "3", "--n-new", "3",
            "--page-size", "8", "--set", "n_layers=2", "d_model=64",
            "n_heads=4", "n_kv_heads=4", "d_ff=128", "vocab_size=256"]
    if prefill_len:
        argv += ["--prefill-len", str(prefill_len)]
    done = main(argv)
    assert sorted(done) == [0, 1, 2]
    assert all(r.error is None and len(r.result) == 3 for r in done.values())
    out = capsys.readouterr().out
    if prefill_len:
        assert "contiguous slot KV" in out and "width 16" in out
        assert "0 chunk calls" in out and "[serve] block-paged" not in out
    else:
        assert "block-paged KV" in out
    with pytest.raises(SystemExit):
        main(argv[:4] + argv[5:] + ["--prefill-len", "8"])
