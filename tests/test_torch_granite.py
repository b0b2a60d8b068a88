"""IBM Granite 4.0-H (`granite-4.0-h-small`) in the port, on the CPU at
`tests/conftest.py` `tiny_config` size with the published 10-layer period
(Mamba-2 at positions 0-4 and 6-9, attention at 5), 8 experts at top-2
beside a shared expert, and every µP scalar set; the weights randomized
past the port's init (norm scales, conv taps and biases, ``D``) so that a
dropped or misplaced one shows.

* The configuration: published widths, the port's own (in neither of the
  reference's lists), paging refused with the reference's reason.
* The contiguous pool's prefill and decode, with left pads, in digital
  mode at a capacity that drops nothing, against the plain reference's
  (`bench/reference/granite.py`) full forward of each unpadded sequence:
  every served logit row within `TOL`. With the pad skip off (the SSM
  scanning the pads, as the reference's pool does) it fails `TOL`.
* raceit_q8 pool calls against the per-call RACE-IT reference
  (`bench/reference/hybrid.py`): logits and written states to float32
  rounding.
* The shared expert and the four scalars each move the logits past `TOL`.
* The spans ``ssm.mixer``, ``ssm.scan``, ``moe.shared`` and the counter
  ``ssm.pad_rows``.
* mixtral and jamba, which set none of the new fields, run the launches
  and produce the outputs they did before the fields existed.
"""
import numpy as np
import pytest
import torch

import _torch_helpers  # noqa: F401  (one torch thread a worker)
from conftest import tiny_config

from bench.reference import granite as RG
from bench.reference.hybrid import Hybrid, reference_call
from repro_torch import trace
from repro_torch.configs import get_config
from repro_torch.configs.base import ExecConfig
from repro_torch.configs.catalog import ASSIGNED, PAPER_OWN, PORTED
from repro_torch.models import Model, quantize_model_params
from repro_torch.serve import ContinuousBatcher, GenerationEngine, Request

NAME = "granite-4.0-h-small"
CPU = torch.device("cpu")
# served logits against the reference's full forward, over each row's
# standard deviation across the vocabulary: float32 reordering alone (the
# pool's chunk boundaries fall elsewhere than the full sequence's, the
# routed sums run in another order) moves them by under 1e-5; a pad step
# scanned into the state moves them by more than 1
TOL = 1e-4
PREFILL = 20


def _cfg(**kw):
    cfg = tiny_config(get_config(NAME)).replace(
        n_layers=10, n_experts=8, top_k=2, shared_d_ff=48)
    return cfg.replace(**kw)


def _spec(cfg) -> dict:
    """The benchmark's model description of ``cfg``."""
    return {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
            "vocab_size": cfg.vocab_size, "norm": cfg.norm,
            "norm_eps": cfg.norm_eps, "activation": cfg.activation,
            "n_experts": cfg.n_experts,
            "top_k": cfg.top_k, "capacity_factor": cfg.capacity_factor,
            "shared_d_ff": cfg.shared_d_ff,
            "mixer_pattern": list(cfg.mixer_pattern),
            "ssm_heads": cfg.ssm_heads, "ssm_headdim": cfg.ssm_headdim,
            "ssm_state": cfg.ssm_state, "ssm_groups": cfg.ssm_groups,
            "conv_width": cfg.conv_width, "ssm_chunk": cfg.ssm_chunk,
            "embedding_multiplier": cfg.embedding_multiplier,
            "residual_multiplier": cfg.residual_multiplier,
            "logits_scaling": cfg.logits_scaling,
            "attention_multiplier": cfg.attention_multiplier}


_PARAMS: dict = {}


def _params(cfg):
    """Seeded weights: the port's init, then norm scales 1 + 0.1 N, conv
    taps N(0, 1/4), conv biases and ``D - 1`` 0.1 N."""
    key = (cfg.d_model, cfg.n_layers, cfg.shared_d_ff)
    if key not in _PARAMS:
        gen = torch.Generator().manual_seed(5)
        p = Model(cfg, device=CPU).init(gen)
        noise = lambda t, dev: torch.randn(t.shape, generator=gen) * dev

        def walk(tree):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v)
                elif k in ("scale", "norm_scale", "ssm_D"):
                    v.add_(noise(v, 0.1))
                elif k.startswith("conv_"):
                    v.copy_(noise(v, 0.1 if k.endswith("_bias") else 0.5))
        walk(p)
        for lp in p["blocks"]:
            walk(lp)
        _PARAMS[key] = p
    return _PARAMS[key]


def _requests(n=5, seed=7):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(1, 256, int(rng.integers(4, PREFILL + 1))
                               ).astype(np.int32), int(rng.integers(3, 7)))
            for rid in range(n)]


def _serve(cfg, params, exec_cfg, reqs, capture=None):
    """Serve ``reqs`` on 2 contiguous slots; with ``capture``, each model
    call's logits by (rid, index of the token it samples)."""
    eng = GenerationEngine(cfg, params, exec_cfg, max_len=PREFILL + 8,
                           device=CPU)
    b = ContinuousBatcher(eng, n_slots=2, paged=False, prefill_len=PREFILL)
    if capture is not None:
        prompts = {r[1].tobytes(): r[0] for r in reqs}
        pre, dec = eng._prefill, eng._decode

        def prefill(params, tokens, cache, pad_lens=None, enc_feats=None):
            out = pre(params, tokens, cache, pad_lens=pad_lens)
            real = tokens[0, int(pad_lens[0]):].numpy().astype(np.int32)
            capture[(prompts[real.tobytes()], 0)] = out[0][0, -1].clone()
            return out

        def decode(params, token, cache, *a, **kw):
            who = [(s.req.rid, len(s.tokens)) if s is not None else None
                   for s in b.slots]
            out = dec(params, token, cache, *a, **kw)
            for row, w in enumerate(who):
                if w is not None:
                    capture[w] = out[0][row, -1].clone()
            return out
        eng._prefill, eng._decode = prefill, decode
    for rid, prompt, n in reqs:
        b.submit(Request(rid, prompt, n_new=n))
    return b.run_all()


def _pool_gap(cfg):
    """The largest gap of a served logit row from the reference's full
    forward of its sequence, over the row's standard deviation."""
    params = _params(cfg)
    got = {}
    reqs = _requests()
    done = _serve(cfg, params, ExecConfig(), reqs, got)
    spec = _spec(cfg)
    worst = 0.0
    for rid, prompt, _ in reqs:
        toks = done[rid].result
        seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]])).long()
        ref = RG.forward(spec, params, seq)
        for i in range(len(toks)):
            want = ref[len(prompt) - 1 + i]
            gap = (got[(rid, i)] - want).abs().amax() / want.std()
            worst = max(worst, float(gap))
    return worst


def test_configuration_at_published_widths():
    cfg = get_config(NAME)
    assert NAME not in PORTED + ASSIGNED + PAPER_OWN
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.vocab_size) == (40, 4096, 32, 8, 128,
                                                       100352)
    assert (cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
            cfg.ssm_groups, cfg.conv_width, cfg.ssm_chunk) == (
        8192, 128, 64, 128, 1, 4, 256)
    assert (cfg.n_experts, cfg.top_k, cfg.d_ff, cfg.shared_d_ff) == (
        72, 10, 768, 1536)
    assert (cfg.embedding_multiplier, cfg.residual_multiplier,
            cfg.logits_scaling, cfg.attention_multiplier) == (
        12.0, 0.22, 16.0, 0.0078125)
    assert [i for i in range(40) if cfg.layer_spec(i)[0] == "attn"] == [
        5, 15, 25, 35]
    assert {cfg.layer_spec(i)[1] for i in range(40)} == {"moe"}
    assert cfg.pos_emb == "none" and cfg.tie_embeddings and cfg.conv_bias \
        and cfg.ssm_skip_pads and cfg.norm_eps == 1e-5


def test_port_own_fields_named_and_kept_off_the_model_axis():
    """Granite sets every field of the port's own; the reference's
    configurations set none; the model axis refuses a layer that uses
    them."""
    from repro_torch.configs.base import PORT_OWN
    from repro_torch.models import blocks
    assert get_config(NAME).port_own == PORT_OWN
    assert all(get_config(n).port_own == () for n in PORTED + ASSIGNED)
    with pytest.raises(NotImplementedError, match="shared_d_ff"):
        blocks.apply_layer_tp({}, [], cfg=_cfg(), plan=ExecConfig(),
                              mixer="mamba", ffn_kind="moe", positions=[],
                              group=None, sp=False)


def test_paged_serving_refused_with_the_reference_reason():
    cfg = _cfg()
    eng = GenerationEngine(cfg, _params(cfg), ExecConfig(), max_len=32,
                           device=CPU)
    assert "SSM state" in ContinuousBatcher.pageable_reason(eng)
    with pytest.raises(ValueError, match="paged serving unsupported"):
        ContinuousBatcher(eng, n_slots=2, paged=True)


def test_pool_matches_the_full_forward():
    """Digital, a capacity that drops nothing (C = T): every served row of
    prefill and decode within TOL of the unpadded full forward."""
    cfg = _cfg(capacity_factor=8 / 2)
    assert _pool_gap(cfg) < TOL


def test_pool_without_the_pad_skip_fails():
    """The same with the pads scanned into the state: past TOL."""
    cfg = _cfg(capacity_factor=8 / 2, ssm_skip_pads=False)
    assert _pool_gap(cfg) > 100 * TOL


def test_raceit_calls_match_the_per_call_reference():
    """raceit_q8 pool calls (the solo admissions and the decode steps):
    logits and the written SSM states as the per-call reference computes
    them from the pool each call read."""
    cfg = _cfg()
    params = _params(cfg)
    eng = GenerationEngine(cfg, quantize_model_params(params),
                           ExecConfig.serving(mode="raceit"),
                           max_len=PREFILL + 8, device=CPU)
    b = ContinuousBatcher(eng, n_slots=2, paged=False, prefill_len=PREFILL)
    from bench.entries.serve_hybrid import Capture
    cap = Capture(eng, 4, 2)
    for rid, prompt, n in _requests():
        b.submit(Request(rid, prompt, n_new=n))
    b.run_all()
    cap.remove()
    ref = Hybrid(_spec(cfg), params)
    kinds = set()
    for rec in cap.calls:
        logits, written, states, real, _ = reference_call(ref, rec)
        kinds.add(rec["kind"])
        lg = rec["logits"][real]
        assert (lg - logits[real]).abs().amax() <= 1e-4 * logits.std()
        for p, r in zip(rec["states"], states):
            assert torch.allclose(p[0][real], r[0][real], rtol=1e-4,
                                  atol=1e-6)
        for (pk, pv), (rk, rv) in zip(rec["written"], written):
            assert torch.allclose(pk.reshape(rk.shape), rk, atol=1e-5)
    assert kinds == {"decode", "prefill"}


@pytest.mark.parametrize("scalar", ["shared", "embedding_multiplier",
                                    "residual_multiplier",
                                    "attention_multiplier",
                                    "logits_scaling"])
def test_each_scalar_matters(scalar):
    """The port's full forward equals the reference's within TOL; with the
    shared expert or one scalar left out of the reference, it does not."""
    cfg = _cfg(capacity_factor=8 / 2)
    params = _params(cfg)
    toks = torch.as_tensor(np.random.default_rng(3).integers(1, 256, 14))
    got = Model(cfg, device=CPU).forward(params, {"tokens": toks[None]})[0]
    spec = _spec(cfg)
    gap = lambda want: float((got - want).abs().amax() / want.std())
    assert gap(RG.forward(spec, params, toks)) < TOL
    if scalar == "shared":
        params = dict(params, blocks=[{k: v for k, v in lp.items()
                                       if k != "shared"}
                                      for lp in params["blocks"]])
    elif scalar == "attention_multiplier":
        spec[scalar] = cfg.resolved_head_dim ** -0.5
    else:
        spec[scalar] = 1.0
    assert gap(RG.forward(spec, params, toks)) > 100 * TOL


def test_spans_and_pad_counter():
    """On: ``ssm.mixer`` (with ``ssm.scan`` inside) once a Mamba layer a
    call, ``moe.shared`` once a layer a call, all carrying the layer; the
    counter ``ssm.pad_rows`` holds each Mamba layer's pad steps, the
    admissions' pads summed. Off: the same tokens and an empty log."""
    cfg = _cfg()
    params = quantize_model_params(_params(cfg))
    ec = ExecConfig.serving(mode="raceit")
    reqs = _requests(3)
    off = _serve(cfg, params, ec, reqs)
    with trace.tracing():
        on = _serve(cfg, params, ec, reqs)
        snap = trace.snapshot()
    assert {r: d.result.tolist() for r, d in on.items()} == {
        r: d.result.tolist() for r, d in off.items()}
    spans = snap["spans"]
    calls = sum(e["name"] in ("engine.prefill", "engine.decode")
                for e in spans)
    mamba = [i for i in range(cfg.n_layers)
             if cfg.layer_spec(i)[0] == "mamba"]
    mixers = [e for e in spans if e["name"] == "ssm.mixer"]
    assert len(mixers) == calls * len(mamba)
    assert sorted({e["layer"] for e in mixers}) == mamba
    for name in ("ssm.scan",):
        inner = [e for e in spans if e["name"] == name]
        assert len(inner) == len(mixers)
        assert all(spans[e["parent"]]["name"] == "ssm.mixer" for e in inner)
    shared = [e for e in spans if e["name"] == "moe.shared"]
    assert len(shared) == calls * cfg.n_layers
    assert sorted({e["layer"] for e in shared}) == list(range(cfg.n_layers))
    pads = sum(PREFILL - len(p) for _, p, _ in reqs)
    assert snap["counters"]["ssm.pad_rows"] == {li: pads for li in mamba}
    trace.enable()
    trace.disable()
    _serve(cfg, params, ec, reqs)
    assert trace.snapshot()["spans"] == []


# recorded on the tree before the new fields existed: aten operations
# dispatched while 3 requests are served on 2 contiguous raceit_q8 slots
# (after a first, uncounted serving of the same: no one-time set-up), the
# tokens, and the sum of every decode call's logits
BEFORE = {"mixtral-8x22b": (11771, [[20, 156, 33, 189], [65, 88, 246, 13],
                                    [146, 187, 187, 31]],
                            -15.896752051368821),
          "jamba-v0.1-52b": (58813, [[189, 128, 162, 47], [165, 33, 25, 195],
                                     [15, 180, 48, 194]],
                             -64.91045595455216)}


def _serve_counted(name, count):
    """(aten operations dispatched, tokens, the decode logits' sum)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    cfg = tiny_config(get_config(name))
    p = Model(cfg, device=CPU).init(torch.Generator().manual_seed(2))
    eng = GenerationEngine(cfg, quantize_model_params(p),
                           ExecConfig.serving(mode="raceit"), max_len=32,
                           device=CPU)
    b = ContinuousBatcher(eng, n_slots=2, paged=False, prefill_len=16)
    rng = np.random.default_rng(1)
    for rid in range(3):
        b.submit(Request(rid, rng.integers(1, 256, int(rng.integers(4, 17))
                                           ).astype(np.int32), n_new=4))
    sums, dec = [], eng._decode

    def decode(*a, **kw):
        out = dec(*a, **kw)
        sums.append(out[0].double().sum().item())
        return out
    eng._decode = decode
    if count:
        with Count():
            done = b.run_all()
    else:
        done = b.run_all()
    return Count.n, [done[r].result.tolist() for r in sorted(done)], sum(sums)


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_models_without_the_new_fields_unchanged(name):
    """mixtral and jamba (no shared expert, no pad skip, no conv bias, no
    scalar) dispatch the operations and produce the outputs they did."""
    _serve_counted(name, False)
    ops, tokens, total = _serve_counted(name, True)
    want = BEFORE[name]
    assert (ops, tokens) == want[:2]
    assert total == pytest.approx(want[2], rel=1e-12)
