"""Serving cells: the port's `ContinuousBatcher` over its `GenerationEngine`,
driven in a closed loop.

Each client holds one request in flight and sends the next as soon as the
last one completes, so the pool stays full. A request's tokens are timed
on the host when the batcher's step that produced them returns.

Order of a run: build the engine from the seed's weights; warm up until
every client has completed a request (every slot turned over, every call
shape built); measure for ``seconds``; read the peak memory; then run a
few more steps of the same loop with the calls captured, free the
program, and recompute each captured call with the plain reference
(`bench.reference.decoder`) on the rows it ran.
"""
from __future__ import annotations

import gc
import time

import torch

from .. import harness, weights
from ..reference.decoder import Decoder
from ..traffic import generate
from ..yardstick import cost, peaks


# ----------------------------------------------------------------- build
def port_config(config: dict, spec: dict):
    """The port's configuration of the cell, checked against the bench's
    model description field by field."""
    from repro_torch.configs import get_config
    port = config["port"]
    cfg = get_config(port["arch"]).replace(
        param_dtype="float32", compute_dtype="float32",
        n_layers=spec["n_layers"], d_model=spec["d_model"],
        n_heads=spec["n_heads"], n_kv_heads=spec["n_kv_heads"],
        head_dim=spec["head_dim"], d_ff=spec["d_ff"],
        vocab_size=spec["vocab_size"])
    if spec.get("n_experts"):
        cfg = cfg.replace(n_experts=spec["n_experts"], top_k=spec["top_k"],
                          capacity_factor=spec["capacity_factor"],
                          window=spec["window"])
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.norm,
           cfg.pos_emb, cfg.activation, cfg.tie_embeddings, cfg.qkv_bias)
    want = (spec["n_layers"], spec["d_model"], spec["n_heads"],
            spec["n_kv_heads"], spec["head_dim"], spec["d_ff"],
            spec["vocab_size"], spec["norm"], spec["pos_emb"],
            spec["activation"], spec["tie_embeddings"], spec["qkv_bias"])
    if got != want:
        raise RuntimeError(f"the port's {port['arch']} is {got}, the "
                           f"bench's configuration {want}")
    return cfg


def build(ctx, params):
    from repro_torch.configs.base import ExecConfig
    from repro_torch.models import quantize_model_params
    from repro_torch.serve import ContinuousBatcher, GenerationEngine
    cfg = port_config(ctx.config, ctx.spec)
    sv = ctx.workload["serve"]
    engine = GenerationEngine(cfg, quantize_model_params(params),
                              ExecConfig.serving(mode="raceit"),
                              max_len=sv["max_len"], device=ctx.device)
    if sv["paged"]:
        batcher = ContinuousBatcher(engine, n_slots=sv["slots"], paged=True,
                                    page_size=sv["page_size"],
                                    prefill_chunk=sv["prefill_chunk"])
    else:
        batcher = ContinuousBatcher(engine, n_slots=sv["slots"], paged=False,
                                    prefill_len=sv["prefill_len"])
    return engine, batcher


# ----------------------------------------------------------- closed loop
class ClosedLoop:
    """``clients`` clients over one batcher, each sending its next request
    when its last one completes; requests come from ``stream`` in order."""

    def __init__(self, batcher, stream: list, clients: int):
        self.b, self.stream, self.next = batcher, stream, 0
        self.recs: dict = {}
        for _ in range(clients):
            self.submit(time.perf_counter())

    def submit(self, now: float):
        from repro_torch.serve import Request
        prompt, n_new = self.stream[self.next % len(self.stream)]
        rid = self.next
        self.next += 1
        self.recs[rid] = rec = {"t": now, "times": [], "done": None,
                                "error": None}
        req = Request(rid, prompt, n_new=n_new)
        self.b.submit(req)
        if req.error is not None:
            rec["error"], rec["done"] = req.error, now

    def step(self) -> float:
        retired = self.b.step()
        now = time.perf_counter()
        for st in self.b.slots:
            if st is not None:
                rec = self.recs[st.req.rid]
                rec["times"] += [now] * (len(st.tokens) - len(rec["times"]))
        for rid in retired:
            req, rec = self.b.done[rid], self.recs[rid]
            n = len(req.result) if req.result is not None else 0
            rec["times"] += [now] * max(0, n - len(rec["times"]))
            rec["done"], rec["error"] = now, req.error
            self.submit(now)
        return now

    def completed(self, rids) -> bool:
        return all(self.recs[r]["done"] is not None for r in rids)


def window_metrics(loop: ClosedLoop, t0: float, t1: float) -> dict:
    """Tokens over the whole window; TTFT of every request submitted in it
    (one still waiting counts at its elapsed time); every gap between two
    tokens of a request inside it."""
    tokens, ttft, itl, attempted, failed = 0, [], [], 0, 0
    for rec in loop.recs.values():
        times = [t for t in rec["times"] if t0 < t <= t1]
        tokens += len(times)
        itl += [1e3 * (b - a) for a, b in zip(times, times[1:])]
        if t0 <= rec["t"] < t1:
            attempted += 1
            failed += rec["error"] is not None
            first = rec["times"][0] if rec["times"] else None
            ttft.append((first if first is not None and first <= t1
                         else t1) - rec["t"])
    return {"tokens": tokens, "window_s": t1 - t0,
            "tokens_per_s": tokens / (t1 - t0),
            "ttft_p95_s": harness.percentile(ttft, 95) if ttft else None,
            "itl_p95_ms": harness.percentile(itl, 95) if itl else None,
            "attempted": attempted, "failed": failed}


# ----------------------------------------------------------- traced work
class Tracer:
    """The bench's spans around the batcher's step, the engine's calls, the
    attention backends and the MoE FFN, with each model call's work
    counted from its arguments (`yardstick.cost`)."""

    def __init__(self, engine, batcher, spec, spans):
        self.engine, self.batcher, self.spec, self.spans = (
            engine, batcher, spec, spans)
        self.calls: list = []
        self.current = None
        self._undo: list = []

    def _patch(self, obj, name, make):
        orig = getattr(obj, name)
        setattr(obj, name, make(orig))
        self._undo.append((obj, name, orig))

    def install(self):
        from repro_torch.exec.plan import ExecPlan
        from repro_torch.models import moe as moe_mod
        sp, eng = self.spans, self.engine

        def engine_call(kind):
            def make(orig):
                def call(*a, **kw):
                    work = cost.call_work(self.spec, kind, a, kw)
                    self.current = work
                    with sp(kind):
                        out = orig(*a, **kw)
                    self.calls.append(work)
                    return out
                return call
            return make

        for kind, name in (("decode", "_decode"),
                           ("prefill_chunk", "_prefill_chunk"),
                           ("prefill", "_prefill")):
            self._patch(eng, name, engine_call(kind))

        def step(orig):
            def call(*a, **kw):
                with sp("step"):
                    return orig(*a, **kw)
            return call
        self._patch(self.batcher, "step", step)

        def attention(orig):
            def call(plan, *a, **kw):
                with sp("attention", timed=False):
                    return orig(plan, *a, **kw)
            return call
        for name in ("attention_decode", "attention_prefill"):
            self._patch(ExecPlan, name, attention)

        def route(orig):
            def call(logits, *a, **kw):
                r = orig(logits, *a, **kw)
                w = self.current
                if w is not None and w.get("real") is not None:
                    real = w["real"].to(r.expert.device)
                    keep = r.keep.reshape(r.expert.shape)[real]
                    w["moe_touched"].append(int(torch.unique(
                        r.expert[real][keep]).numel()))
                return r
            return call
        self._patch(moe_mod, "route", route)

        def moe(orig):
            def call(*a, **kw):
                with sp("moe", timed=False):
                    return orig(*a, **kw)
            return call
        self._patch(moe_mod, "moe", moe)

    def remove(self):
        for obj, name, orig in reversed(self._undo):
            if obj is self.engine or obj is self.batcher:
                delattr(obj, name)
            else:
                setattr(obj, name, orig)
        self._undo.clear()


# ------------------------------------------------------------- captured
class PageStore:
    """The pages of a paged pool that captured calls read, each content a
    page had kept once: a page that no call wrote between two captures is
    shared by both, so a dozen captured calls hold a few times the live
    cache and not a dozen copies of the pool."""

    def __init__(self):
        self.kept = {}  # page id -> (layers, 2, page_size, KV, hd)

    def snap(self, cache, bt, live, ps) -> dict:
        """Page id -> content of every page holding one of the first
        ``live[b]`` positions of row ``b``."""
        n = (live.long() + ps - 1) // ps
        cols = torch.arange(bt.shape[1], device=bt.device)[None]
        ids = torch.unique(bt.long()[cols < n[:, None]]).tolist()
        out = {}
        for i in range(0, len(ids), 32):
            chunk = ids[i:i + 32]
            idx = torch.tensor(chunk, device=cache[0]["attn"]["k"].device)
            cur = torch.stack([torch.stack((c["attn"]["k"][idx],
                                            c["attn"]["v"][idx]), 1)
                               for c in cache], 1)
            for j, pid in enumerate(chunk):
                old = self.kept.get(pid)
                if old is None or not torch.equal(old, cur[j]):
                    old = self.kept[pid] = cur[j].clone()
                out[pid] = old
            del cur
        return out


class Capture:
    """Each engine call of the check steps: its inputs, the cache it read
    (copied before the call: the whole contiguous pool, or the paged
    pool's live pages), its logits, the tokens sampled from them and the
    keys and values it wrote."""

    def __init__(self, engine, want_decode: int, want_prefill: int):
        self.engine, self.calls = engine, []
        self.store = PageStore()
        self.want = {"decode": want_decode, "prefill": want_prefill}
        self._orig, self._rec = {}, None
        for name in ("_decode", "_prefill_chunk", "_prefill", "_sample"):
            self._orig[name] = getattr(engine, name)
            setattr(engine, name, getattr(self, name))
        from repro_torch.models import moe as moe_mod
        self._moe, self._route = moe_mod, moe_mod.route

        def route(*a, **kw):
            r = self._route(*a, **kw)
            if self._rec is not None:
                self._rec["routes"].append((r.expert.clone(),
                                            r.keep.clone()))
            return r
        moe_mod.route = route

    def remove(self):
        for name in self._orig:
            delattr(self.engine, name)
        self._moe.route = self._route

    def done(self) -> bool:
        have = {"decode": 0, "prefill": 0}
        for c in self.calls:
            have["decode" if c["kind"] == "decode" else "prefill"] += 1
        return all(have[k] >= v for k, v in self.want.items())

    def _room(self, kind) -> bool:
        key = "decode" if kind == "decode" else "prefill"
        n = sum(1 for c in self.calls
                if ("decode" if c["kind"] == "decode" else "prefill") == key)
        return n < self.want[key]

    def _pool(self, cache, bt=None, live=None, ps=None):
        if bt is None:
            return [(c["attn"]["k"].clone(), c["attn"]["v"].clone())
                    for c in cache]
        return self.store.snap(cache, bt, live, ps)

    def _decode(self, params, token, cache, slot_lens=None, block_table=None,
                page_size=None, pad_lens=None, pad_prompt_len=None):
        rec = None
        if self._room("decode"):
            rec = {"kind": "decode", "tokens": token.clone(),
                   "lens": slot_lens.clone(),
                   "pool": self._pool(cache, block_table, slot_lens,
                                      page_size),
                   "bt": None if block_table is None else block_table.clone(),
                   "ps": page_size,
                   "pad": None if pad_lens is None else pad_lens.clone(),
                   "routes": []}
        self._rec = rec
        out = self._orig["_decode"](params, token, cache, slot_lens,
                                    block_table, page_size, pad_lens=pad_lens,
                                    pad_prompt_len=pad_prompt_len)
        self._rec = None
        if rec is not None:
            rec["logits"] = out[0][:, -1].float().clone()
            rec["written"] = written_decode(out[1], rec)
            self.calls.append(rec)
        return out

    def _prefill_chunk(self, params, tokens, cache, offs, feeds, bt, ps):
        rec = None
        if self._room("prefill_chunk"):
            rec = {"kind": "prefill_chunk", "tokens": tokens.clone(),
                   "offs": offs.clone(), "feeds": feeds.clone(),
                   "bt": bt.clone(), "ps": ps,
                   "pool": self._pool(cache, bt, offs + feeds, ps),
                   "routes": []}
        self._rec = rec
        out = self._orig["_prefill_chunk"](params, tokens, cache, offs, feeds,
                                           bt, ps)
        self._rec = None
        if rec is not None:
            rec["logits"] = out[0][:, -1].float().clone()
            rec["written"] = written_chunk(out[1], rec)
            self.calls.append(rec)
        return out

    def _prefill(self, params, tokens, cache, pad_lens=None, enc_feats=None):
        self._rec = {"routes": []} if self._room("prefill") else None
        out = self._orig["_prefill"](params, tokens, cache, pad_lens=pad_lens,
                                     enc_feats=enc_feats)
        if self._rec is not None:
            self.calls.append({
                "kind": "prefill", "tokens": tokens.clone(),
                "pad": pad_lens.clone(), "routes": self._rec["routes"],
                "logits": out[0][:, -1].float().clone(),
                "written": [(c["attn"]["k"][:, :tokens.shape[1]].clone(),
                             c["attn"]["v"][:, :tokens.shape[1]].clone())
                            for c in out[1]]})
        return out

    def _sample(self, logits, gen=None):
        tok = self._orig["_sample"](logits, gen)
        if self.calls and "sampled" not in self.calls[-1] \
                and self.calls[-1]["logits"].shape[0] == logits.shape[0]:
            self.calls[-1]["sampled"] = tok.long().clone()
        return tok


def _paged_rows(bt, cols, ps):
    rows = torch.arange(bt.shape[0], device=bt.device)[:, None]
    cols = cols.clamp(min=0)
    return bt.long()[rows, cols // ps], cols % ps


def written_chunk(cache, rec):
    C = rec["tokens"].shape[1]
    cols = rec["offs"].long()[:, None] + torch.arange(C, device=rec[
        "offs"].device)[None]
    page, slot = _paged_rows(rec["bt"], cols, rec["ps"])
    return [(c["attn"]["k"][page, slot].clone(),
             c["attn"]["v"][page, slot].clone()) for c in cache]


def written_decode(cache, rec):
    col = (rec["lens"].long() - 1).clamp(min=0)[:, None]
    if rec["bt"] is not None:
        page, slot = _paged_rows(rec["bt"], col, rec["ps"])
        return [(c["attn"]["k"][page, slot].clone(),
                 c["attn"]["v"][page, slot].clone()) for c in cache]
    rows = torch.arange(col.shape[0], device=col.device)[:, None]
    out = []
    for c in cache:
        L = c["attn"]["k"].shape[1]
        out.append((c["attn"]["k"][rows, col % L].clone(),
                    c["attn"]["v"][rows, col % L].clone()))
    return out


# ------------------------------------------------------------ reference
class _Gathered:
    """Each layer's keys and values in every row's logical order, from a
    copied contiguous pool or from the captured pages of a paged one (a
    position on no captured page reads 0; it lies past its row's live
    length)."""

    def __init__(self, pool, bt):
        self.pool, self.bt = pool, bt

    def __getitem__(self, li):
        if isinstance(self.pool, dict):
            return self._paged(li)
        k, v = self.pool[li]
        if self.bt is None:
            return k, v
        B, mp = self.bt.shape
        idx = self.bt.long()
        return (k[idx].reshape(B, mp * k.shape[1], *k.shape[2:]),
                v[idx].reshape(B, mp * v.shape[1], *v.shape[2:]))

    def _paged(self, li):
        ids = list(self.pool)
        bt = self.bt.long()
        pages = torch.stack([self.pool[p][li] for p in ids])
        pages = torch.cat([pages, torch.zeros_like(pages[:1])])
        lut = torch.full((max(ids + [int(bt.max())]) + 1,), len(ids),
                         dtype=torch.long, device=bt.device)
        lut[torch.tensor(ids, device=bt.device)] = torch.arange(
            len(ids), device=bt.device)
        g = pages[lut[bt]]  # (B, pages a row, 2, page_size, KV, hd)
        B, mp, _, ps = g.shape[:4]
        return (g[:, :, 0].reshape(B, mp * ps, *g.shape[4:]),
                g[:, :, 1].reshape(B, mp * ps, *g.shape[4:]))


def reference_call(ref: Decoder, rec: dict):
    """(logits (B, V), written [(k, v)], real rows (B,) bool, new_at) of a
    captured call, recomputed by the reference."""
    toks = rec["tokens"].long()
    B, S = toks.shape
    dev = toks.device
    ar = torch.arange(S, device=dev)[None]
    if rec["kind"] == "prefill_chunk":
        offs, feeds = rec["offs"].long(), rec["feeds"].long()
        lens = offs + feeds
        pos = offs[:, None] + ar
        new_at = torch.where(ar < feeds[:, None], pos, -1)
        Lk = rec["bt"].shape[1] * rec["ps"]
        qmask = (torch.arange(Lk, device=dev)[None, None]
                 <= pos[:, :, None])
        ctx, last, real = (_Gathered(rec["pool"], rec["bt"]),
                           (feeds - 1).clamp(min=0), feeds > 0)
    elif rec["kind"] == "decode":
        lens = rec["lens"].long()
        pad = rec["pad"].long() if rec["pad"] is not None else 0 * lens
        pos = ((lens - 1).clamp(min=0) - pad).clamp(min=0)[:, None]
        new_at = torch.where(lens > 0, lens - 1, -1)[:, None]
        ctx = _Gathered(rec["pool"], rec["bt"])
        Lk = ctx[0][0].shape[1]
        lens = lens.clamp(max=Lk)
        qmask = None
        if rec["pad"] is not None:
            qmask = (torch.arange(Lk, device=dev)[None, None]
                     >= pad[:, None, None])
        last, real = torch.zeros_like(lens), lens > 0
    else:  # a solo admission prefill, left-padded, on a fresh cache
        pad = rec["pad"].long()
        pos = (ar - pad[:, None]).clamp(min=0)
        lens = torch.full((B,), S, device=dev)
        new_at = ar.expand(B, S)
        kv = ref.spec["n_kv_heads"], ref.spec["head_dim"]
        ctx = [(torch.zeros(B, S, *kv, device=dev),) * 2] * ref.spec[
            "n_layers"]
        i, c = ar[0][:, None], ar[0][None, :]
        window = ref.spec.get("window") or S + 1
        qmask = ((c <= i) & (c > i - window))[None] & (
            c[None] >= pad[:, None, None])
        last, real = torch.full((B,), S - 1, device=dev), torch.ones(
            B, dtype=torch.bool, device=dev)
    logits, written = ref.call(toks, pos, ctx, lens, new_at, qmask, True,
                               last)
    return logits, written, real, new_at


class Gaps:
    """The numbers of a side (the program, or a variant of the reference in
    its place) against the reference, over every captured call; the cell's
    ``check.limits`` name those compared, the rest are reported:

    * ``logit_gap``: the widest gap of a served token's logit below the
      reference's best, over the real rows, in units of the row's standard
      deviation over the vocabulary; ``logit_gap_mean``: the mean of that
      gap over every call's real rows (0 where the served token is the
      reference's best);
    * ``kv_err``: the written keys' and values' largest error over the
      reference's largest entry, the worst layer and call;
    * ``kv_mean_err``: their mean absolute error over the reference's mean
      absolute entry, over every call's written entries, the worst layer;
    * ``kv_median_l1``: each written row's error (the norm of its keys'
      and values' difference over the norm of the reference's), its median
      over every call's rows, in the second layer, the first that reads
      another layer's output (``kv_row_median_layers``: that median in
      every layer);
    * ``rows_off``: the share of real rows whose served token is not the
      reference's best."""

    def __init__(self):
        self.gap, self.kv, self.rows, self.off = 0.0, 0.0, 0, 0
        self.err_sum, self.ref_sum, self.row_err = {}, {}, {}
        self.layers, self.row_gaps = [], []

    def add(self, written, tokens, ref_logits, ref_written, real, new_at):
        lg = ref_logits[real]
        served = lg.gather(1, tokens[real][:, None])[:, 0]
        gaps = (lg.amax(-1) - served) / lg.std(-1)
        self.gap = max(self.gap, float(gaps.amax()))
        self.row_gaps.append(gaps.float().cpu())
        self.rows += int(real.sum())
        self.off += int((served < lg.amax(-1)).sum())
        put = new_at >= 0
        self.layers = []
        for li, ((pk, pv), (rk, rv)) in enumerate(zip(written, ref_written)):
            dn = rn = 0.0
            for p, r in ((pk, rk), (pv, rv)):
                d = (p.float()[put] - r.float()[put]).flatten(1)
                dn = dn + (d.double() ** 2).sum(1)
                rn = rn + (r.float()[put].flatten(1).double() ** 2).sum(1)
            self.row_err.setdefault(li, []).append(
                (dn.sqrt() / rn.sqrt().clamp_min(1e-30)).cpu())
            err = 0.0
            for p, r in ((pk, rk), (pv, rv)):
                r = r.float()[put]
                d = (p.float()[put] - r).abs()
                err = max(err, float(d.amax()
                                     / r.abs().amax().clamp_min(1e-30)))
                self.err_sum[li] = self.err_sum.get(li, 0.0) + float(
                    d.double().sum())
                self.ref_sum[li] = self.ref_sum.get(li, 0.0) + float(
                    r.abs().double().sum())
            self.layers.append(err)
        self.kv = max([self.kv] + self.layers)

    def readings(self) -> dict:
        mean = max((self.err_sum[li] / max(self.ref_sum[li], 1e-30)
                    for li in self.err_sum), default=0.0)
        med = [float(torch.cat(self.row_err[li]).median())
               for li in sorted(self.row_err)]
        g = torch.cat(self.row_gaps) if self.row_gaps else torch.zeros(1)
        return {"logit_gap": self.gap, "logit_gap_mean": float(g.mean()),
                "kv_err": self.kv, "kv_mean_err": mean,
                "kv_median_l1": med[min(1, len(med) - 1)] if med else 0.0,
                "kv_row_median_layers": med,
                "rows_off": self.off / max(self.rows, 1)}


def variants(spec: dict, control: bool) -> dict:
    """With ``control``, the reference's variants to read in the program's
    place, by name: (keyword arguments of `Decoder`, sound). A sound
    variant is the same computation in another float32 order; the others
    are the controls, a step down in precision."""
    if not control:
        return {}
    out = {"apart": ({"order": "apart"}, True),
           "int4": ({"bits": 4}, False)}
    if spec.get("n_experts"):
        out.update(tf32_experts=({"experts": "tf32"}, False),
                   bf16_experts=({"experts": "bfloat16"}, False))
    return out


def check(ctx, captured: list, params) -> tuple:
    """(the program's readings over the captured calls, each variant's
    readings by name, each with ``sound``)."""
    ref = Decoder(ctx.spec, params, bits=8)
    sides = {}
    for name, (kw, sound) in variants(ctx.spec, ctx.control).items():
        d = Decoder(ctx.spec, params, **kw)
        if d.bits == ref.bits:
            d.codes = ref.codes  # the same int8 codes of the same weights
        sides[name] = (d, Gaps(), sound)
    prog, detail = Gaps(), []
    for rec in captured:
        if "sampled" not in rec:
            raise RuntimeError(f"no sampled tokens seen for a {rec['kind']} "
                               f"call")
        logits, written, real, new_at = reference_call(ref, rec)
        prog.add(rec["written"], rec["sampled"], logits, written, real,
                 new_at)
        routes = sum(int(((pe != re_).reshape(-1)
                          | (pk.reshape(-1) != rk.reshape(-1))).sum())
                     for (pe, pk), (re_, rk) in zip(rec["routes"],
                                                    ref.routes))
        detail.append({"kind": rec["kind"], "rows": int(real.sum()),
                       "kv_layers": [float(f"{x:.3g}") for x in prog.layers],
                       "logit_diff": float((rec["logits"][real]
                                            - logits[real]).abs().amax()),
                       "route_diff": routes})
        for d, gaps, _ in sides.values():
            lv, wv, _, _ = reference_call(d, rec)
            gaps.add(wv, lv.argmax(-1), logits, written, real, new_at)
            del lv, wv
        del logits, written
    out = {**prog.readings(), "calls": len(captured), "rows": prog.rows,
           "detail": detail}
    var = {name: {**g.readings(), "sound": sound}
           for name, (_, g, sound) in sides.items()}
    return out, var


# ------------------------------------------------------------------ run
def run(ctx) -> dict:
    dev = ctx.device
    sv, mix = ctx.workload["serve"], ctx.mix
    params = weights.make(ctx.spec, ctx.seed, dev)
    engine, batcher = build(ctx, params)
    stream = generate.requests(mix, ctx.seed, ctx.spec["vocab_size"])
    spans = harness.Spans(dev)
    loop = ClosedLoop(batcher, stream, mix["clients"])
    first = list(loop.recs)
    if ctx.fault is not None:
        ctx.fault(engine, batcher)
    # warm-up: every client's first request completes, so every slot has
    # turned over and every call shape has run
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
            prof = profiler(dev)
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
    m = window_metrics(loop, t0, t1)
    m["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    counters = {"decode_steps": batcher.decode_steps - c0[0],
                "decode_tokens": batcher.decode_tokens - c0[1],
                "slots": sv["slots"], "steps": n}
    # the check: the same loop, its calls captured
    n_dec = ctx.workload["check"]["steps"]
    cap = Capture(engine, n_dec, 1)
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
           "memory_peak_bytes": peak,
           "counters": counters, "attempted": m["attempted"],
           "failed": m["failed"]}
    if prof is not None:
        out["trace"] = {"profile": harness.read_profile(prof),
                        "wall_s": trace_wall, "spans": spans.log,
                        "calls": calls, "counters": counters,
                        "peaks": peaks.PEAKS, "spec": ctx.spec,
                        "workload": ctx.workload}
    return out


def profiler(dev):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)
