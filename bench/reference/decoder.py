"""Plain reference of one served model call under RACE-IT numerics.

A call is what the serving loop hands the model at one step: a batch of
token rows at their positions, with each row's keys and values from earlier
calls. The reference recomputes it from the float weights the benchmark
made, deriving its own int8 codes, and returns the logits the call samples
from and the keys and values it writes. Its numerics are those the
configuration states (RACE-IT, Fig. 12 and Section IV):

* every weight matrix but the MoE's is resident: int8 codes with one
  max-abs scale a column; its input is quantized with one scale over the
  whole call, the product is exact in integers, then both scales;
* the FFN activation and the MoE router's softmax are Compute-ACAM tables
  (`acam`); the experts are float32 products;
* attention quantizes q (times 1/sqrt(d)) over the call, and k and v over
  every live key of the call, forms LOGIT codes of q.k, exponentiates on
  the power-of-two grid, takes the log of each row's sum, and turns the
  difference into probability codes, requantized to int8 at the largest
  probability code of the call before the product with v;
* masked keys within a row's live length sit at the LOGIT minimum.

The scales couple every row of a call, so a call is judged with all its
rows, as the serving loop ran it. ``bits`` below 8 is the lower-precision
control of the resident parts, ``experts`` ``"tf32"`` or ``"bfloat16"``
that of the float32 experts. ``order="apart"`` is the same computation in
another sound float32 order: each expert's rows taken apart from the
others, the norms through `torch.nn.functional`'s kernels, the two scales
of a resident product applied one after the other. Its distance from the
reference is what float32 rounding alone moves the compared numbers by.
The reference imports nothing of the measured program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import acam


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest, ties to
    even, as a tensor core reads it."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + (0xFFF + ((i >> 13) & 1))) & -0x2000
    return i.view(torch.float32)


def _mm(a, b, experts: str):
    """An expert product, batched or not, in the precision ``experts``."""
    mm = torch.bmm if a.dim() == 3 else torch.mm
    if experts == "float32":
        return mm(a, b)
    if experts == "tf32":
        return mm(tf32(a), tf32(b))
    if experts == "bfloat16":
        return mm(a.bfloat16(), b.bfloat16()).float()
    raise ValueError(f"unknown expert precision {experts!r}")


class Decoder:
    """``spec`` is the benchmark's model description (``bench/configs``'s
    ``model`` entry); ``params`` the float weight tree (`bench.weights`)."""

    def __init__(self, spec: dict, params: dict, bits: int = 8,
                 experts: str = "float32", order: str = "block"):
        if order not in ("block", "apart"):
            raise ValueError(f"unknown order {order!r}")
        self.spec, self.p, self.bits = spec, params, bits
        self.experts, self.order = experts, order
        dev = params["embed"]["tok_emb"].device
        self.t = acam.Tables(dev)
        self.codes = {}
        self.routes = []  # the last call's (experts, kept) a MoE layer

    # ------------------------------------------------------------ pieces
    def _w(self, key, w):
        if key not in self.codes:
            self.codes[key] = acam.weight_codes(w, self.bits)
        return self.codes[key]

    def linear(self, x, key, w, bias=None):
        """A resident crossbar product: x (..., K) -> (..., N...)."""
        wc, ws = self._w(key, w)
        xc, xs, _ = acam.quantize(x.float(), self.bits)
        y = (xc.reshape(-1, wc.shape[0]) @ wc).float()
        y = y * xs * ws if self.order == "apart" else y * (xs * ws)
        y = y.reshape(*x.shape[:-1], *w.shape[1:])
        return y if bias is None else y + bias.float()

    def norm(self, p, x):
        x = x.float()
        if self.order == "apart":
            if self.spec["norm"] == "rmsnorm":
                return x / torch.sqrt((x * x).mean(-1, keepdim=True) + 1e-6) \
                    * p["scale"].float()
            return F.layer_norm(x, x.shape[-1:], p["scale"].float(),
                                p["bias"].float(), 1e-6)
        if self.spec["norm"] == "rmsnorm":
            return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) \
                * p["scale"].float()
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-6) * p["scale"].float() \
            + p["bias"].float()

    def rope(self, x, pos):
        hd = x.shape[-1]
        freqs = 1.0 / torch.pow(torch.tensor(float(self.spec["rope_theta"]),
                                             device=x.device),
                                torch.arange(0, hd, 2, device=x.device,
                                             dtype=torch.float32) / hd)
        ang = pos[..., None].float() * freqs
        cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
        a, b = torch.chunk(x.float(), 2, dim=-1)
        return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)

    def attend(self, q, k, v, lens, qmask, per_row):
        """q (B, Sq, H, hd) already times 1/sqrt(d); k, v (B, Lk, KV, hd)
        each row's keys in logical order; ``lens`` (B,) live keys a row;
        ``qmask`` (B, Sq, Lk) or None. Returns (B, Sq, H, hd)."""
        t, bits = self.t, self.bits
        B, Sq, H, hd = q.shape
        Lk, KV = k.shape[1], k.shape[2]
        valid = torch.arange(Lk, device=q.device)[None, :] < lens[:, None]
        vk = valid[:, :, None, None]
        qc, _, qa = acam.quantize(q.float(), bits)
        kc, _, ka = acam.quantize(k.float(), bits, vk)
        vc, _, va = acam.quantize(v.float(), bits, vk)
        rep = H // KV
        kc = kc.repeat_interleave(rep, 2)
        vc = vc.repeat_interleave(rep, 2)
        r = torch.einsum("bqhd,bkhd->bhqk", qc, kc)
        xc = acam.logit_codes(r.float() * acam.scales_product(qa, ka, bits))
        if qmask is not None:
            xc = torch.where(qmask[:, None], xc,
                             torch.full_like(xc, acam.LOGIT_MIN))
        live = valid[:, None, None, :]
        s = torch.where(live, t.exp_val[xc + 128],
                        torch.zeros((), device=q.device)).sum(-1)
        xmax = torch.where(live, xc, torch.full_like(xc, acam.LOGIT_MIN)
                           ).amax(-1)
        lg = t.log[acam.pot_encode(s)]
        c_row = t.prob[torch.clamp(xmax - (lg << acam.LOG_SHIFT),
                                   acam.LOGIT_MIN, acam.LOGIT_MAX) + 128]
        if per_row:
            c_row = torch.where((lens > 0)[:, None, None], c_row,
                                torch.zeros_like(c_row))
        cmax = c_row.amax().float() * acam.PROB_SCALE
        req = torch.clamp_min(cmax, 1e-12) * acam.inv(bits)
        qm = acam.qmax(bits)
        table = torch.clamp(torch.round(t.prob.float() * acam.PROB_SCALE
                                        / req), -qm - 1, qm)
        d = torch.clamp(xc - (lg << acam.LOG_SHIFT)[..., None],
                        acam.LOGIT_MIN, acam.LOGIT_MAX)
        pc = torch.where(live, table[d + 128], torch.zeros((),
                                                           device=q.device))
        out = torch.einsum("bhqk,bkhd->bqhd", pc.double(), vc).float()
        return out * acam.scales_product(torch.clamp_min(cmax, 1e-12), va,
                                         bits)

    def moe(self, p, x, li):
        """Token-choice top-k over every row of the call: the router's
        Fig.-8 softmax, the k largest (ties to the lower expert), gates
        renormalized; capacity ceil(k * T * factor / E) a expert, ranked
        token-major, the rest dropped; each expert's rows gathered into an
        (E, C, D) block for the three float32 products, then weighted and
        summed per token (``order="apart"``: each expert's kept rows
        gathered and multiplied on their own)."""
        s = self.spec
        B, S, D = x.shape
        xf = x.reshape(-1, D).float()
        T, E, K = xf.shape[0], s["n_experts"], s["top_k"]
        probs = acam.softmax(self.t, xf @ p["router"].float())
        gate, expert = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        gate, expert = gate[:, :K], expert[:, :K]
        gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
        C = max(1, int(-(-K * T * s["capacity_factor"] // E)))
        flat = expert.reshape(-1)
        rank = torch.zeros_like(flat)
        for e in range(E):
            hit = flat == e
            rank[hit] = torch.arange(int(hit.sum()), device=x.device)
        keep = rank < C
        slot = torch.where(keep, flat * C + rank, E * C)
        self.routes.append((expert, keep))
        tok = torch.arange(T, device=x.device).repeat_interleave(K)
        w = (gate.reshape(-1) * keep)[:, None]
        ex, act = self.experts, s["activation"]
        if self.order == "apart":
            y = torch.zeros(T * K, D, device=x.device)
            for e in range(E):
                sel = torch.nonzero((flat == e) & keep)[:, 0]
                if sel.numel():
                    xe = xf[tok[sel]]
                    h = acam.activation(self.t, _mm(xe, p["w1"][e], ex), act)
                    h = h * _mm(xe, p["w3"][e], ex)
                    y[sel] = _mm(h, p["w2"][e], ex)
            return (y * w).reshape(T, K, D).sum(1).reshape(B, S, D)
        block = torch.zeros(E * C + 1, D, device=x.device)
        block[slot] = xf[tok]
        block = block[:-1].reshape(E, C, D)
        h = acam.activation(self.t, _mm(block, p["w1"].float(), ex), act)
        h = h * _mm(block, p["w3"].float(), ex)
        y = torch.cat([_mm(h, p["w2"].float(), ex).reshape(E * C, D),
                       torch.zeros(1, D, device=x.device)])
        return (y[slot] * w).reshape(T, K, D).sum(1).reshape(B, S, D)

    def ffn(self, p, x, li):
        h = self.linear(x, (li, "w1"), p["w1"])
        h = acam.activation(self.t, h, self.spec["activation"])
        return self.linear(h, (li, "w2"), p["w2"])

    # ------------------------------------------------------------- a call
    @torch.no_grad()
    def call(self, tokens, positions, ctx, lens, new_at, qmask, per_row,
             last):
        """One model call.

        tokens, positions (B, S); ``ctx`` a list over layers of (k, v),
        each (B, Lk, KV, hd): every row's keys before this call, in logical
        order; ``new_at`` (B, S) the logical column each new key lands on
        (-1: dropped); ``lens`` (B,) the live keys after the call;
        ``qmask`` (B, S, Lk) or None; ``last`` (B,) the row position whose
        logits the call returns. Returns (logits (B, V), [(k, v) new]).
        """
        s, p = self.spec, self.p
        self.routes = []
        B, S = tokens.shape
        hd, H = s["head_dim"], s["n_heads"]
        x = p["embed"]["tok_emb"][tokens].float()
        if s["pos_emb"] == "learned":
            x = x + p["embed"]["pos_emb"][positions].float()
        rows = torch.arange(B, device=x.device)[:, None].expand(B, S)
        put = new_at >= 0
        written = []
        for li, lp in enumerate(p["blocks"]):
            a = lp["attn"]
            h = self.norm(lp["norm1"], x)
            q = self.linear(h, (li, "wq"), a["wq"], a.get("bq"))
            k = self.linear(h, (li, "wk"), a["wk"], a.get("bk"))
            v = self.linear(h, (li, "wv"), a["wv"], a.get("bv"))
            if s["pos_emb"] == "rope":
                q, k = self.rope(q, positions), self.rope(k, positions)
            kk, vv = (c.float().clone() for c in ctx[li])
            kk[rows[put], new_at[put]] = k[put]
            vv[rows[put], new_at[put]] = v[put]
            written.append((k, v))
            o = self.attend(q * (1.0 / math.sqrt(hd)), kk, vv, lens, qmask,
                            per_row)
            x = x + self.linear(o.reshape(B, S, H * hd), (li, "wo"),
                                a["wo"].reshape(H * hd, -1))
            h = self.norm(lp["norm2"], x)
            x = x + (self.moe(lp["moe"], h, li) if "moe" in lp
                     else self.ffn(lp["ffn"], h, li))
        x = self.norm(p["final_norm"], x)
        xl = x[torch.arange(B, device=x.device), last][:, None]
        emb = p["embed"]
        if "unembed" in emb:
            logits = self.linear(xl, ("unembed",), emb["unembed"])
        else:
            logits = torch.einsum("bsd,dv->bsv", xl.float(),
                                  emb["tok_emb"].T.float())
        return logits[:, 0], written
