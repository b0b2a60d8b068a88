"""Plain reference of one served call of a hybrid Mamba-2 and attention
model (IBM Granite 4.0-H) under RACE-IT numerics.

It follows `decoder`'s numerics and row coupling (resident int8 products
with one activation scale over the whole call, the Compute-ACAM SiLU and
router softmax, float32 experts, the Fig.-12 integer attention), and adds
what Granite's layers hold:

* a Mamba-2 layer reads its slot rows' SSM state and conv history and
  writes them back: the five projections and ``out_proj`` resident; the
  depthwise causal conv with its bias, SiLU, softplus and the scan in
  float32 (over a prompt `granite.ssd_chunked`, the Mamba-2 paper's
  minimal SSD; the recurrent step at decode); ``D``; the gated RMSNorm.
  ``order="apart"`` scans a prompt step by step (`granite.ssd_sequential`)
  besides `Decoder`'s other sound order;
* a left-padded admission's pad steps are held out of the recurrence
  (zeroed x, B and C before the conv, dt = 0), as the configuration
  states; ``skip_pads=False`` scans them, as the JAX reference's pool does
  (a control);
* attention has no positions, and q is scaled by ``attention_multiplier *
  sqrt(d)`` before the Fig.-12 pipeline's 1/sqrt(d), as the program folds
  it;
* each MoE layer adds a resident SiLU-GLU shared expert to the routed
  experts;
* the µP scalars: the embedding times ``embedding_multiplier``, each
  branch times ``residual_multiplier``, the tied float32 head's logits over
  ``logits_scaling``; every RMSNorm at ``norm_eps``.

A prompt's SSM state integrates thousands of steps, and under the
call-wide int8 requantization and top-10 routing on a coarse probability
grid a flipped last bit anywhere grows, layer by layer, into differences
as large as a lower precision's. So besides the whole call
(`reference_call`), `layer_calls` recomputes each layer's mixer and
routed experts from the inputs the program gave that layer: one layer's
rounding stays in that layer.

Resident codes are cached as int8 and widened to float64 for each exact
product. A long prefill's attention runs in blocks of queries, in two
passes (the call-wide probability scale first), the same numbers in less
memory. Nothing of the measured program is imported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import acam, granite
from .decoder import Decoder

Q_BLOCK = 512  # queries a block of a long prefill's attention


class Hybrid(Decoder):
    """``spec`` the benchmark's model description with the hybrid keys
    (``mixer_pattern``, the SSM sizes, ``shared_d_ff``, the µP scalars);
    ``params`` the float weight tree in the port's layout."""

    def __init__(self, spec: dict, params: dict, bits: int = 8,
                 experts: str = "float32", order: str = "block",
                 skip_pads: bool = True):
        super().__init__(spec, params, bits, experts, order)
        self.skip_pads = skip_pads

    def _w(self, key, w):
        if key not in self.codes:
            wc, ws = acam.weight_codes(w, self.bits)
            self.codes[key] = (wc.to(torch.int8), ws)
        wc, ws = self.codes[key]
        return wc.double(), ws

    def mixer(self, i: int) -> str:
        pat = self.spec["mixer_pattern"]
        return pat[i % len(pat)]

    def norm(self, p, x):
        """RMSNorm at the model's ``norm_eps``."""
        x = x.float()
        eps = self.spec["norm_eps"]
        if self.order == "apart":
            return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) \
                * p["scale"].float()
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
            * p["scale"].float()

    # ------------------------------------------------------------ pieces
    def attend(self, q, k, v, lens, qmask, per_row):
        B, Sq, H, _ = q.shape
        if Sq <= Q_BLOCK:
            return super().attend(q, k, v, lens, qmask, per_row)
        return self._attend_blocked(q, k, v, lens, qmask, per_row)

    def _attend_blocked(self, q, k, v, lens, qmask, per_row):
        """`Decoder.attend` a block of queries at a time."""
        t, bits = self.t, self.bits
        B, Sq, H, hd = q.shape
        Lk, KV = k.shape[1], k.shape[2]
        valid = torch.arange(Lk, device=q.device)[None, :] < lens[:, None]
        vk = valid[:, :, None, None]
        qc, _, qa = acam.quantize(q.float(), bits)
        kc, _, ka = acam.quantize(k.float(), bits, vk)
        vc, _, va = acam.quantize(v.float(), bits, vk)
        kc = kc.repeat_interleave(H // KV, 2)
        vc = vc.repeat_interleave(H // KV, 2)
        live = valid[:, None, None, :]
        sp = acam.scales_product(qa, ka, bits)
        blocks = [(s, min(s + Q_BLOCK, Sq)) for s in range(0, Sq, Q_BLOCK)]

        def codes(s0, s1):
            r = torch.einsum("bqhd,bkhd->bhqk", qc[:, s0:s1], kc)
            xc = acam.logit_codes(r.float() * sp)
            if qmask is not None:
                xc = torch.where(qmask[:, None, s0:s1], xc,
                                 torch.full_like(xc, acam.LOGIT_MIN))
            return xc

        lgs, cmax = [], None
        for s0, s1 in blocks:
            xc = codes(s0, s1)
            s = torch.where(live, t.exp_val[xc + 128],
                            torch.zeros((), device=q.device)).sum(-1)
            xmax = torch.where(live, xc, torch.full_like(
                xc, acam.LOGIT_MIN)).amax(-1)
            lg = t.log[acam.pot_encode(s)]
            c_row = t.prob[torch.clamp(xmax - (lg << acam.LOG_SHIFT),
                                       acam.LOGIT_MIN, acam.LOGIT_MAX) + 128]
            if per_row:
                c_row = torch.where((lens > 0)[:, None, None], c_row,
                                    torch.zeros_like(c_row))
            m = c_row.amax()
            cmax = m if cmax is None else torch.maximum(cmax, m)
            lgs.append(lg)
            del xc, s
        cmax = cmax.float() * acam.PROB_SCALE
        req = torch.clamp_min(cmax, 1e-12) * acam.inv(bits)
        qm = acam.qmax(bits)
        table = torch.clamp(torch.round(t.prob.float() * acam.PROB_SCALE
                                        / req), -qm - 1, qm)
        out = []
        for (s0, s1), lg in zip(blocks, lgs):
            xc = codes(s0, s1)
            d = torch.clamp(xc - (lg << acam.LOG_SHIFT)[..., None],
                            acam.LOGIT_MIN, acam.LOGIT_MAX)
            pc = torch.where(live, table[d + 128],
                             torch.zeros((), device=q.device))
            out.append(torch.einsum("bhqk,bkhd->bqhd", pc.double(),
                                    vc).float())
            del xc, d, pc
        return torch.cat(out, 1) * acam.scales_product(
            torch.clamp_min(cmax, 1e-12), va, bits)

    def glu(self, p, x, key):
        """A resident SiLU-GLU FFN (the shared expert)."""
        h = self.linear(x, key + ("w1",), p["w1"])
        h = acam.activation(self.t, h, self.spec["activation"])
        h = h * self.linear(x, key + ("w3",), p["w3"])
        return self.linear(h, key + ("w2",), p["w2"])

    def _conv(self, p, name, x, hist):
        """The depthwise causal conv of one of x, B, C over (B, S, C) with
        its history (B, W-1, C): (output, the last W-1 inputs)."""
        w = p[name].float()
        W = w.shape[0]
        ctx = torch.cat([hist.float(), x], 1)
        S = x.shape[1]
        y = sum(ctx[:, i:i + S] * w[i] for i in range(W))
        return y + p[name + "_bias"].float(), ctx[:, -(W - 1):]

    def mamba(self, p, x, li, state, pad):
        """One Mamba-2 mixer over the normed x (B, S, D). ``state``: the
        rows' (ssm (B, H, P, N), conv_x, conv_B, conv_C), or None for a
        fresh one; ``pad`` (B,) left pads of a prefill, or None. Returns
        (output, (ssm, conv_x, conv_B, conv_C) after the call)."""
        s = self.spec
        B, S, _ = x.shape
        H, P, N, G = (s["ssm_heads"], s["ssm_headdim"], s["ssm_state"],
                      s["ssm_groups"])
        W = s["conv_width"]
        z = self.linear(x, (li, "w_z"), p["w_z"])
        proj = [self.linear(x, (li, k), p[k]) for k in ("w_x", "w_B", "w_C")]
        dt = self.linear(x, (li, "w_dt"), p["w_dt"]).float()
        keep = None
        if self.skip_pads and pad is not None and S > 1:
            keep = (torch.arange(S, device=x.device)[None, :]
                    >= pad[:, None])[..., None].float()
            proj = [t * keep for t in proj]
        if state is None:
            hist = [torch.zeros(B, W - 1, t.shape[-1], device=x.device)
                    for t in proj]
            ssm = torch.zeros(B, H, P, N, device=x.device)
        else:
            ssm, hist = state[0], list(state[1:])
        conv = [self._conv(p, k, t, h0) for k, t, h0 in
                zip(("conv_x", "conv_B", "conv_C"), proj, hist)]
        xs, Bv, Cv = (F.silu(c) for c, _ in conv)
        xh = xs.reshape(B, S, H, P)
        rep = H // G
        Bm = Bv.reshape(B, S, G, N).repeat_interleave(rep, 2)
        Cm = Cv.reshape(B, S, G, N).repeat_interleave(rep, 2)
        dt = granite.softplus(dt + p["dt_bias"].float())
        if keep is not None:
            dt = dt * keep
        A = -torch.exp(p["A_log"].float())
        if S == 1 and state is not None:
            s1 = (ssm.float() * torch.exp(dt[:, 0] * A)[..., None, None]
                  + (dt[:, 0, :, None] * xh[:, 0])[..., None]
                  * Bm[:, 0, :, None, :])
            y = torch.einsum("bhn,bhpn->bhp", Cm[:, 0], s1)[:, None]
            new = s1
        else:
            ys, news = [], []
            for b in range(B):
                if self.order == "apart":
                    y, f = granite.ssd_sequential(xh[b], dt[b], A, Bm[b],
                                                  Cm[b], ssm[b])
                else:
                    y, f = granite.ssd_chunked(xh[b], dt[b], A, Bm[b], Cm[b],
                                               s["ssm_chunk"], ssm[b])
                ys.append(y)
                news.append(f)
            y, new = torch.stack(ys), torch.stack(news)
        y = (y + xh * p["ssm_D"].float()[:, None]).reshape(B, S, H * P)
        g = self.norm({"scale": p["norm_scale"]}, y * F.silu(z.float()))
        out = self.linear(g, (li, "out_proj"), p["out_proj"])
        return out, (new, *(c for _, c in conv))

    # ------------------------------------------------------------- a call
    @torch.no_grad()
    def call(self, tokens, pad, ctx, lens, new_at, qmask, last):
        """One model call: tokens (B, S); ``pad`` (B,) a prefill's left pads
        or None; ``ctx`` a list over layers: an attention layer's (k, v),
        each (B, Lk, KV, hd) in logical order, a Mamba layer's state tuple
        or None (fresh); ``lens``, ``new_at``, ``qmask``, ``last`` as in
        `Decoder.call`. Returns (logits (B, V), [(k, v) written by each
        attention layer], [state tuple written by each Mamba layer])."""
        s, p = self.spec, self.p
        self.routes = []
        B, S = tokens.shape
        hd, H = s["head_dim"], s["n_heads"]
        r = s["residual_multiplier"]
        x = p["embed"]["tok_emb"][tokens].float() * s["embedding_multiplier"]
        rows = torch.arange(B, device=x.device)[:, None].expand(B, S)
        put = new_at >= 0
        written, states = [], []
        for li, lp in enumerate(p["blocks"]):
            h = self.norm(lp["norm1"], x)
            if self.mixer(li) == "mamba":
                m, st = self.mamba(lp["mamba"], h, li, ctx[li], pad)
                states.append(st)
            else:
                a = lp["attn"]
                q = self.linear(h, (li, "wq"), a["wq"])
                k = self.linear(h, (li, "wk"), a["wk"])
                v = self.linear(h, (li, "wv"), a["wv"])
                q = q * (s["attention_multiplier"] * math.sqrt(hd))
                kk, vv = (c.float().clone() for c in ctx[li])
                kk[rows[put], new_at[put]] = k[put]
                vv[rows[put], new_at[put]] = v[put]
                written.append((k, v))
                o = self.attend(q * (1.0 / math.sqrt(hd)), kk, vv, lens,
                                qmask, True)
                del kk, vv
                m = self.linear(o.reshape(B, S, H * hd), (li, "wo"),
                                a["wo"].reshape(H * hd, -1))
            x = x + m * r
            h = self.norm(lp["norm2"], x)
            y = self.moe(lp["moe"], h, li)
            if "shared" in lp:
                y = y + self.glu(lp["shared"], h, (li, "shared"))
            x = x + y * r
        x = self.norm(p["final_norm"], x)
        xl = x[torch.arange(B, device=x.device), last][:, None]
        logits = torch.einsum("bsd,dv->bsv", xl.float(),
                              p["embed"]["tok_emb"].T.float())
        return logits[:, 0] / s["logits_scaling"], written, states


def reference_call(ref: Hybrid, rec: dict):
    """(logits (B, V), written [(k, v)] of the attention layers, written
    states of the Mamba layers, real rows (B,) bool, new_at) of a captured
    contiguous-pool call (``decode`` or the solo admission ``prefill``),
    recomputed by the reference from the pool it read."""
    toks = rec["tokens"].long()
    B, S = toks.shape
    dev = toks.device
    ar = torch.arange(S, device=dev)[None]
    pad = rec["pad"].long()
    if rec["kind"] == "decode":
        lens = rec["lens"].long()
        new_at = torch.where(lens > 0, lens - 1, -1)[:, None]
        ctx = rec["pool"]
        Lk = next(c[0].shape[1] for c in ctx if len(c) == 2)
        lens = lens.clamp(max=Lk)
        qmask = (torch.arange(Lk, device=dev)[None, None]
                 >= pad[:, None, None])
        last, real = torch.zeros_like(lens), lens > 0
        pads = None
    else:  # the solo admission prefill, left-padded, on a fresh cache
        lens = torch.full((B,), S, device=dev)
        new_at = ar.expand(B, S)
        kv = ref.spec["n_kv_heads"], ref.spec["head_dim"]
        ctx = [(torch.zeros(B, S, *kv, device=dev),) * 2
               if ref.mixer(i) != "mamba" else None
               for i in range(ref.spec["n_layers"])]
        i, c = ar[0][:, None], ar[0][None, :]
        qmask = (c <= i)[None] & (c[None] >= pad[:, None, None])
        last = torch.full((B,), S - 1, device=dev)
        real = torch.ones(B, dtype=torch.bool, device=dev)
        pads = pad
    logits, written, states = ref.call(toks, pads, ctx, lens, new_at, qmask,
                                       last)
    return logits, written, states, real, new_at


@torch.no_grad()
def layer_calls(ref: Hybrid, rec: dict) -> dict:
    """Each layer of a captured call recomputed by the reference from the
    inputs the program gave it (``rec["mixer_in"]``: each mixer's normed
    input; ``rec["moe_io"]``: each MoE's normed input and routed output):
    ``written``, the (k, v) each attention layer wrote; ``states``, the
    state tuple each Mamba layer wrote (from the pool's state the call read,
    or a fresh one at an admission, its left pads held out); ``moe``, each
    layer's routed experts' output."""
    prefill = rec["kind"] != "decode"
    pad = rec["pad"].long() if prefill else None
    out = {"written": [], "states": [], "moe": []}
    for li, lp in enumerate(ref.p["blocks"]):
        h = rec["mixer_in"][li]
        if ref.mixer(li) == "mamba":
            state = None if prefill else rec["pool"][li]
            _, st = ref.mamba(lp["mamba"], h, li, state, pad)
            out["states"].append(st)
        else:
            a = lp["attn"]
            out["written"].append((ref.linear(h, (li, "wk"), a["wk"]),
                                   ref.linear(h, (li, "wv"), a["wv"])))
        ref.routes = []
        out["moe"].append(ref.moe(lp["moe"], rec["moe_io"][li][0], li))
    return out
