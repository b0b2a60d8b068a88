"""The work a model call needs, counted from its shapes.

Frozen here so that no change to the program moves the yardstick. The
attention rule is the port's launch count (`kernels/cost.py`: each int8
input read once, the int32 output written once; int8 multiplies and adds),
with both products counted over the unmasked (query, key) pairs, as the
call needs them, and K and V once per KV head. On a decode call of
full-head K and V, where no live key is masked, it equals the port's count
less the block table and lengths (a CPU test holds it there).

`call_work` counts one engine call from its arguments: the resident int8
products, the float32 work (the tied float lm head, the experts), and
attention, over the real rows only: feeding rows of a chunk call (their
fed tokens), decoding slots, the real tokens of a left-padded prompt.
"""
from __future__ import annotations

import torch


def attention_need(H, KV, D, rows):
    """(bytes, ops) one layer's attention needs for ``rows``, each (queries,
    unmasked pairs per head, live keys): q and the output per query head,
    K and V once per KV head; q . k and p . v over the unmasked pairs."""
    nbytes = sum(H * q * D + 2 * KV * live * D + 4 * H * q * D
                 for q, _, live in rows)
    ops = sum(4 * H * pairs * D for _, pairs, _ in rows)
    return nbytes, ops


def _host(t):
    return t.detach().to("cpu").long() if isinstance(t, torch.Tensor) else t


def call_work(spec, kind, args, kwargs) -> dict:
    """The needed work of one engine call (`GenerationEngine._decode`,
    ``_prefill_chunk`` or ``_prefill``, its positional and keyword
    arguments): ``int8_ops``, ``f32_flops``, ``attn_bytes``, ``attn_ops``
    (one layer each, times the layers), ``tokens`` (real rows), ``real``
    (the flattened rows the MoE routes that are real) and ``moe_touched``
    (experts a layer's real rows reached, filled by the tracer)."""
    D, H, KV, hd = (spec["d_model"], spec["n_heads"], spec["n_kv_heads"],
                    spec["head_dim"])
    F, V, L = spec["d_ff"], spec["vocab_size"], spec["n_layers"]
    tokens = args[1]
    B, S = tokens.shape
    if kind == "prefill_chunk":
        offs, feeds = _host(args[3]), _host(args[4])
        rows = [(int(f), int(f * o + f * (f + 1) // 2), int(o + f))
                for o, f in zip(offs.tolist(), feeds.tolist()) if f > 0]
        real = torch.arange(S)[None, :] < feeds[:, None]
    elif kind == "decode":
        lens = _host(args[3] if len(args) > 3 else kwargs["slot_lens"])
        pad = kwargs.get("pad_lens")
        pad = _host(pad) if pad is not None else torch.zeros_like(lens)
        rows = [(1, int(n - p), int(n - p))
                for n, p in zip(lens.tolist(), pad.tolist()) if n > 0]
        real = (lens > 0)[:, None]
    else:
        pad = _host(kwargs.get("pad_lens", args[3] if len(args) > 3
                               else torch.zeros(B)))
        n = [S - int(p) for p in pad.tolist()]
        rows = [(k, k * (k + 1) // 2, k) for k in n]
        real = torch.arange(S)[None, :] >= pad[:, None]
    toks = sum(q for q, _, _ in rows)
    last = len(rows)
    mats = D * H * hd + 2 * D * KV * hd + H * hd * D
    moe = bool(spec.get("n_experts"))
    if not moe:
        mats += 2 * D * F
    int8 = 2 * L * toks * mats
    f32 = 0
    if spec["tie_embeddings"]:
        f32 += 2 * D * V * last
    else:
        int8 += 2 * D * V * last
    if moe:
        f32 += 2 * 3 * D * F * spec["top_k"] * L * toks
    ab, ao = attention_need(H, KV, hd, rows)
    return {"kind": kind, "tokens": toks, "int8_ops": int8,
            "f32_flops": f32, "attn_bytes": L * ab, "attn_ops": L * ao,
            "layers": L, "real": real.reshape(-1), "moe_touched": []}


def moe_least_s(spec, work, peaks) -> float:
    """Least time of the MoE FFNs of one call: the float32 expert products
    of the real tokens at the float32 peak against the weights of the
    experts they reach, read once, and the tokens in and out, at the HBM
    rate; the larger, a layer at a time."""
    if not work["moe_touched"]:
        return 0.0
    D, F, k = spec["d_model"], spec["d_ff"], spec["top_k"]
    t = work["tokens"]
    total = 0.0
    for touched in work["moe_touched"]:
        flops = 2 * 3 * D * F * k * t
        nbytes = 4 * (3 * D * F * touched + 2 * D * t)
        total += max(flops / peaks["f32_flops_per_s"],
                     nbytes / peaks["hbm_bytes_per_s"])
    return total


def attn_least_s(work, peaks) -> float:
    """Least time of a call's attention, a layer at a time."""
    L = work["layers"]
    return L * max(work["attn_ops"] / L / peaks["int8_ops_per_s"],
                   work["attn_bytes"] / L / peaks["hbm_bytes_per_s"])


def train_step_flops(spec, batch, seq) -> float:
    """Model FLOPs of one float32 training step, forward and backward
    (three times the forward), without a recomputation: every matrix
    product, causal attention's q . k and p . v, and the lm head."""
    D, H, hd, F, V, L = (spec["d_model"], spec["n_heads"], spec["head_dim"],
                         spec["d_ff"], spec["vocab_size"], spec["n_layers"])
    toks = batch * seq
    mats = D * H * hd * 4 + 2 * D * F
    pairs = batch * seq * (seq + 1) // 2
    fwd = 2 * toks * (L * mats + D * V) + L * 4 * H * hd * pairs
    return 3.0 * fwd
