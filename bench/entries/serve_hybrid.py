"""Serving cells of a hybrid Mamba-2 and attention model (IBM Granite
4.0-H): the port's `ContinuousBatcher` over its contiguous slot pool,
driven in a closed loop.

The loop, its window metrics, the bench's spans and the capture are
`serve`'s; what differs is the model's:

* the weights (`bench.weights_hybrid`) and the port's registered
  configuration, checked against the bench's model description key by
  key before anything is drawn;
* each model call's work is counted by `bench.yardstick.cost_hybrid`
  (the Mamba-2 mixers and the shared experts included), and the mixers
  run inside a bench span ``ssm`` (the MoE span ``moe`` covers the routed
  experts alone: the shared expert runs outside `moe.moe`);
* a captured call keeps each Mamba layer's SSM state and conv history as
  it read and wrote them, beside the attention layer's keys and values,
  and each layer's inputs;
* the check recomputes each captured call with `bench.reference.hybrid`:
  the whole call for ``logit_gap_mean``; each layer from the program's own
  input to it for ``kv_median_l1`` (the attention layer's keys and
  values), ``state_median_l1`` (each Mamba layer's written SSM state) and
  ``moe_median_l1`` (each layer's routed experts' output), so that a
  rounding in one layer is not carried through the SSM states of the
  next. Each is a per-row error (the norm of the difference over the
  norm of the reference's), its median over the real rows of each kind of
  call (decode; admission prefill), the largest over the kinds and the
  layers.
"""
from __future__ import annotations

import gc
import time

import torch

from .. import harness, weights_hybrid
from ..reference.hybrid import Hybrid, layer_calls, reference_call
from ..traffic import generate
from ..yardstick import cost_hybrid, peaks
from . import serve as S

def _field(cfg, key):
    """The port's value of a key of the bench's model description."""
    v = getattr(cfg, "resolved_head_dim" if key == "head_dim" else key)
    return list(v) if isinstance(v, tuple) else v


def port_config(config: dict, spec: dict):
    """The port's registered configuration at the cell's depth, in float32,
    checked against every key of the model description its file states;
    then at ``spec``'s sizes where they differ from the file's (the CPU
    tests' tiny cell)."""
    from repro_torch.configs import get_config
    port, model = config["port"], dict(config["model"])
    model.pop("family")
    cfg = get_config(port["arch"]).replace(
        param_dtype="float32", compute_dtype="float32",
        n_layers=port["n_layers"])
    got = {k: _field(cfg, k) for k in model}
    if got != model:
        raise RuntimeError(f"the port's {port['arch']} is {got}, the "
                           f"bench's configuration {model}")
    kw = {k: spec[k] for k in model if spec[k] != model[k]}
    if not kw:
        return cfg
    kw.pop("ssm_heads", None)
    if "mixer_pattern" in kw:
        kw["mixer_pattern"] = tuple(kw["mixer_pattern"])
    return cfg.replace(**kw, ssm_expand=spec["ssm_heads"]
                       * spec["ssm_headdim"] // spec["d_model"])


def build(ctx, cfg, params):
    from repro_torch.configs.base import ExecConfig
    from repro_torch.models import quantize_model_params
    from repro_torch.serve import ContinuousBatcher, GenerationEngine
    sv = ctx.workload["serve"]
    engine = GenerationEngine(cfg, quantize_model_params(params),
                              ExecConfig.serving(mode="raceit"),
                              max_len=sv["max_len"], device=ctx.device)
    batcher = ContinuousBatcher(engine, n_slots=sv["slots"], paged=False,
                                prefill_len=sv["prefill_len"])
    return engine, batcher


# ----------------------------------------------------------- traced work
class Tracer(S.Tracer):
    """`serve.Tracer` with each call's work counted by `cost_hybrid` and
    a span ``ssm`` round every Mamba-2 mixer."""

    def install(self):
        super().install()
        from repro_torch.models import ssm as ssm_mod
        for obj, name, orig in list(self._undo):
            if obj is self.engine:
                kind = name.lstrip("_")
                setattr(obj, name, self._counted(kind, orig))

        def mamba(orig):
            def call(*a, **kw):
                with self.spans("ssm", timed=False):
                    return orig(*a, **kw)
            return call
        self._patch(ssm_mod, "mamba", mamba)

    def _counted(self, kind, orig):
        def call(*a, **kw):
            work = cost_hybrid.call_work(self.spec, kind, a, kw)
            self.current = work
            with self.spans(kind):
                out = orig(*a, **kw)
            self.calls.append(work)
            return out
        return call


# ------------------------------------------------------------- captured
def _host(t):
    """A host copy of a captured tensor: the captures of a call at the
    cell's size (the pool it read, each layer's inputs) would not fit on
    the card beside the reference's weights and work."""
    return t.to("cpu", copy=True)


def _to(tree, dev):
    """A captured call's tensors on ``dev``, for the check."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _layer(c):
    """A layer cache's leaves the check reads: (k, v) of an attention
    layer, (SSM state, conv_x, conv_B, conv_C) of a Mamba layer."""
    if "attn" in c:
        return c["attn"]["k"], c["attn"]["v"]
    m = c["mamba"]
    return m["state"], m["conv_x"], m["conv_B"], m["conv_C"]


class Capture(S.Capture):
    """`serve.Capture` over a contiguous pool of attention and Mamba
    layers: the pool as a call read it (each layer's leaves copied), the
    attention layers' keys and values and the Mamba layers' states as it
    wrote them, and each layer's inputs: every mixer's normed input
    (``mixer_in``) and every MoE's normed input and routed output
    (``moe_io``), all kept on the host."""

    def __init__(self, engine, want_decode: int, want_prefill: int):
        super().__init__(engine, want_decode, want_prefill)
        from repro_torch.models import layers, moe, ssm
        self._layer_fns = [(ssm, "mamba", ssm.mamba),
                           (layers, "attention", layers.attention),
                           (moe, "moe", moe.moe)]

        def mixer(orig):
            def call(p, x, *a, **kw):
                if self._rec is not None:
                    self._rec["mixer_in"].append(_host(x))
                return orig(p, x, *a, **kw)
            return call

        def routed(orig):
            def call(p, x, *a, **kw):
                y = orig(p, x, *a, **kw)
                if self._rec is not None:
                    self._rec["moe_io"].append((_host(x), _host(y)))
                return y
            return call
        ssm.mamba = mixer(ssm.mamba)
        layers.attention = mixer(layers.attention)
        moe.moe = routed(moe.moe)

    def remove(self):
        super().remove()
        for mod, name, orig in self._layer_fns:
            setattr(mod, name, orig)

    def _pool(self, cache, bt=None, live=None, ps=None):
        return [tuple(_host(t) for t in _layer(c)) for c in cache]

    def _decode(self, params, token, cache, slot_lens=None, block_table=None,
                page_size=None, pad_lens=None, pad_prompt_len=None):
        rec = None
        if self._room("decode"):
            rec = {"kind": "decode", "tokens": token.clone(),
                   "lens": slot_lens.clone(), "pad": pad_lens.clone(),
                   "pool": self._pool(cache), "routes": [], "mixer_in": [],
                   "moe_io": []}
        self._rec = rec
        out = self._orig["_decode"](params, token, cache, slot_lens,
                                    block_table, page_size, pad_lens=pad_lens,
                                    pad_prompt_len=pad_prompt_len)
        self._rec = None
        if rec is not None:
            rec["logits"] = _host(out[0][:, -1].float())
            col = (rec["lens"].long() - 1).clamp(min=0)[:, None]
            rows = torch.arange(col.shape[0], device=col.device)[:, None]
            rec["written"], rec["states"] = [], []
            for c in out[1]:
                leaves = _layer(c)
                if "attn" in c:
                    L = leaves[0].shape[1]
                    rec["written"].append(tuple(_host(t[rows, col % L])
                                                for t in leaves))
                else:
                    rec["states"].append(tuple(_host(t) for t in leaves))
            self.calls.append(rec)
        return out

    def _prefill(self, params, tokens, cache, pad_lens=None, enc_feats=None):
        self._rec = ({"routes": [], "mixer_in": [], "moe_io": []}
                     if self._room("prefill") else None)
        out = self._orig["_prefill"](params, tokens, cache, pad_lens=pad_lens,
                                     enc_feats=enc_feats)
        if self._rec is not None:
            S_ = tokens.shape[1]
            self.calls.append({
                **self._rec, "kind": "prefill", "tokens": tokens.clone(),
                "pad": pad_lens.clone(),
                "logits": _host(out[0][:, -1].float()),
                "written": [tuple(_host(t[:, :S_]) for t in _layer(c))
                            for c in out[1] if "attn" in c],
                "states": [tuple(_host(t) for t in _layer(c))
                           for c in out[1] if "mamba" in c]})
        self._rec = None
        return out


# ------------------------------------------------------------ the check
class RowGaps:
    """Rows of one kind of tensor a layer writes against the reference's,
    each recomputed from the program's own input to that layer: each real
    row's error (the norm of its difference over the norm of the
    reference's), by kind of call and layer. ``name`` is the reading: the
    largest over the kinds of call (decode; admission prefill) and the
    layers of the median over their rows."""

    def __init__(self, name: str):
        self.name, self.rows = name, {}  # (kind, layer) -> [row errors]

    def add(self, kind, got, want, real):
        for li, (p, r) in enumerate(zip(got, want)):
            d = (p.float() - r.float())[real].flatten(1).double()
            n = r.float()[real].flatten(1).double()
            err = d.norm(dim=1) / n.norm(dim=1).clamp_min(1e-30)
            self.rows.setdefault(("decode" if kind == "decode"
                                  else "prefill", li), []).append(err.cpu())

    def readings(self) -> dict:
        med = {key: float(torch.cat(v).median())
               for key, v in self.rows.items()}
        by = {kind: [med[k] for k in sorted(med) if k[0] == kind]
              for kind in ("decode", "prefill")}
        return {self.name: max(med.values(), default=0.0),
                self.name.replace("_median_l1", "_row_median_layers"): by}


class Sides:
    """A side's numbers: `serve.Gaps` over the whole call's logits and the
    attention layer's keys and values, ``state_median_l1`` over the Mamba
    layers' written SSM states and ``moe_median_l1`` over the routed
    experts' output rows (the real tokens), the last three each layer
    from the program's own input to it."""

    def __init__(self):
        self.gaps = S.Gaps()
        self.states = RowGaps("state_median_l1")
        self.moe = RowGaps("moe_median_l1")

    def add(self, rec, written, tokens, logits, layers, ref_layers, real,
            new_at):
        self.gaps.add(written, tokens, logits, ref_layers["written"], real,
                      new_at)
        self.states.add(rec["kind"], [st[0] for st in layers["states"]],
                        [st[0] for st in ref_layers["states"]], real)
        toks = real[:, None].expand(*rec["tokens"].shape)
        if rec["kind"] != "decode":
            ar = torch.arange(toks.shape[1], device=toks.device)[None]
            toks = toks & (ar >= rec["pad"].long()[:, None])
        self.moe.add(rec["kind"], [y[toks] for y in layers["moe"]],
                     [y[toks] for y in ref_layers["moe"]],
                     slice(None))

    def readings(self) -> dict:
        return {**self.gaps.readings(), **self.states.readings(),
                **self.moe.readings()}


def variants(control: bool) -> dict:
    """With ``control``, the reference's variants read in the program's
    place: (keyword arguments of `Hybrid`, sound)."""
    if not control:
        return {}
    return {"apart": ({"order": "apart"}, True),
            "int4": ({"bits": 4}, False),
            "tf32_experts": ({"experts": "tf32"}, False),
            "pads_scanned": ({"skip_pads": False}, False)}


def _program_layers(rec) -> dict:
    return {"written": rec["written"], "states": rec["states"],
            "moe": [y for _, y in rec["moe_io"]]}


def check(ctx, captured: list, params) -> tuple:
    """(the program's readings over the captured calls, each variant's
    readings by name, each with ``sound``)."""
    ref = Hybrid(ctx.spec, params, bits=8)
    sides = {}
    for name, (kw, sound) in variants(ctx.control).items():
        d = Hybrid(ctx.spec, params, **kw)
        if d.bits == ref.bits:
            d.codes = ref.codes
        sides[name] = (d, Sides(), sound)
    prog, detail = Sides(), []
    dev, n = params["embed"]["tok_emb"].device, len(captured)
    while captured:
        rec = _to(captured.pop(0), dev)
        if "sampled" not in rec:
            raise RuntimeError(f"no sampled tokens seen for a {rec['kind']} "
                               f"call")
        logits, _, _, real, new_at = reference_call(ref, rec)
        want = layer_calls(ref, rec)
        prog.add(rec, rec["written"], rec["sampled"], logits,
                 _program_layers(rec), want, real, new_at)
        detail.append({"kind": rec["kind"], "rows": int(real.sum()),
                       "logit_diff": float((rec["logits"][real]
                                            - logits[real]).abs().amax())})
        for d, side, _ in sides.values():
            lv, _, _, _, _ = reference_call(d, rec)
            got = layer_calls(d, rec)
            side.add(rec, got["written"], lv.argmax(-1), logits, got, want,
                     real, new_at)
            del lv, got
        del rec, logits, want
    out = {**prog.readings(), "calls": n,
           "rows": prog.gaps.rows, "detail": detail}
    var = {name: {**side.readings(), "sound": sound}
           for name, (_, side, sound) in sides.items()}
    return out, var


# ------------------------------------------------------------------ run
def run(ctx) -> dict:
    dev = ctx.device
    sv, mix = ctx.workload["serve"], ctx.mix
    cfg = port_config(ctx.config, ctx.spec)  # a port without it stops here
    params = weights_hybrid.make(ctx.spec, ctx.seed, dev)
    engine, batcher = build(ctx, cfg, params)
    stream = generate.requests(mix, ctx.seed, ctx.spec["vocab_size"])
    spans = harness.Spans(dev)
    loop = S.ClosedLoop(batcher, stream, mix["clients"])
    first = list(loop.recs)
    if ctx.fault is not None:
        ctx.fault(engine, batcher)
    # warm-up: every client's first request completes, so every slot has
    # turned over and both call shapes have run
    steps = 0
    while not loop.completed(first) or steps < 2:
        loop.step()
        steps += 1
    spans.sync()
    t0 = time.perf_counter()
    setup_s = harness.process_age()
    c0 = (batcher.decode_steps, batcher.decode_tokens)
    prof, tracer, trace_wall = None, None, None
    n = 0
    while True:
        if ctx.trace and n == 0:
            tracer = Tracer(engine, batcher, ctx.spec, spans)
            tracer.install()
            spans.on = True
            prof = S.profiler(dev)
            prof.__enter__()
            tw0 = time.perf_counter()
        now = loop.step()
        n += 1
        if tracer is not None and n == ctx.workload["trace_steps"]:
            spans.sync()
            trace_wall = time.perf_counter() - tw0
            prof.__exit__(None, None, None)
            spans.on = False
            tracer.remove()
        if now - t0 >= ctx.seconds and (tracer is None
                                        or trace_wall is not None):
            break
    spans.sync()
    t1 = time.perf_counter()
    m = S.window_metrics(loop, t0, t1)
    m["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    counters = {"decode_steps": batcher.decode_steps - c0[0],
                "decode_tokens": batcher.decode_tokens - c0[1],
                "slots": sv["slots"], "steps": n}
    chk = ctx.workload["check"]
    cap = Capture(engine, chk["steps"], chk["prefills"])
    for _ in range(400):
        if cap.done():
            break
        loop.step()
    cap.remove()
    captured = cap.calls
    calls = tracer.calls if tracer is not None else []
    del loop, batcher, engine, cap, tracer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings, var = check(ctx, captured, params)
    out = {"e2e": m, "readings": readings, "variants": var,
           "memory_peak_bytes": peak, "counters": counters,
           "attempted": m["attempted"], "failed": m["failed"]}
    if prof is not None:
        out["trace"] = {"profile": harness.read_profile(prof),
                        "wall_s": trace_wall, "spans": spans.log,
                        "calls": calls, "counters": counters,
                        "peaks": peaks.PEAKS, "spec": ctx.spec,
                        "workload": ctx.workload}
    return out
