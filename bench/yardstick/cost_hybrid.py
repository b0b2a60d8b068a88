"""The work a call of a hybrid Mamba-2 and attention model needs, counted
from its shapes (`cost`'s rules, frozen here likewise).

Per real row (decoding slots; the real tokens of a left-padded admission):

* resident int8 products (2 ops a multiply-add): each Mamba layer's five
  input projections (d_model to 2 d_inner + 2 G N + H) and ``out_proj``
  (d_inner to d_model); each attention layer's q, k, v and o; every
  layer's shared expert (three d_model x shared_d_ff matrices);
* float32: the routed experts (k of them, three d_model x d_ff products
  each), each Mamba layer's conv (2 W FLOPs a channel of x, B and C) and
  scan (the recurrence's 5 P N FLOPs a head: decay, input, output), and
  the tied float32 head at each row's last position;
* attention as `cost.attention_need`, in the attention layers.

A Mamba layer's least time (`ssm_least_s`) is the larger of its compute
(the projections at the int8 peak plus the conv and scan at the float32
peak) and its bytes at the HBM rate: the projections' int8 codes read
once, and each real row's SSM state and conv history read and written
once (a fresh admission's only written).
"""
from __future__ import annotations

import torch

from .cost import _host, attention_need


def _sizes(spec):
    H, P, N, G = (spec["ssm_heads"], spec["ssm_headdim"], spec["ssm_state"],
                  spec["ssm_groups"])
    d_in, W = H * P, spec["conv_width"]
    conv_ch = d_in + 2 * G * N
    proj = spec["d_model"] * (2 * d_in + 2 * G * N + H) + d_in * spec[
        "d_model"]
    scan = 5 * P * N * H + 2 * W * conv_ch
    state = 4 * (H * P * N + (W - 1) * conv_ch)
    return proj, scan, state


def layer_counts(spec) -> tuple:
    """(Mamba layers, attention layers) of the stack."""
    pat = spec["mixer_pattern"]
    mamba = sum(pat[i % len(pat)] == "mamba" for i in range(spec["n_layers"]))
    return mamba, spec["n_layers"] - mamba


def call_work(spec, kind, args, kwargs) -> dict:
    """`cost.call_work`'s fields for one contiguous-pool call
    (`GenerationEngine._decode` or ``_prefill``), plus ``ssm_int8_ops``,
    ``ssm_f32_flops`` and ``ssm_bytes`` (one Mamba layer each) and
    ``ssm_layers``."""
    D, H, KV, hd = (spec["d_model"], spec["n_heads"], spec["n_kv_heads"],
                    spec["head_dim"])
    F, V, L = spec["d_ff"], spec["vocab_size"], spec["n_layers"]
    tokens = args[1]
    B, S = tokens.shape
    if kind == "decode":
        lens = _host(args[3] if len(args) > 3 else kwargs["slot_lens"])
        pad = kwargs.get("pad_lens")
        pad = _host(pad) if pad is not None else torch.zeros_like(lens)
        rows = [(1, int(n - p), int(n - p))
                for n, p in zip(lens.tolist(), pad.tolist()) if n > 0]
        real = (lens > 0)[:, None]
        fresh = False
    elif kind == "prefill":
        pad = _host(kwargs.get("pad_lens", args[3] if len(args) > 3
                               else torch.zeros(B)))
        n = [S - int(p) for p in pad.tolist()]
        rows = [(k, k * (k + 1) // 2, k) for k in n]
        real = torch.arange(S)[None, :] >= pad[:, None]
        fresh = True
    else:
        raise ValueError(f"a hybrid model serves contiguous calls, not "
                         f"{kind!r}")
    toks = sum(q for q, _, _ in rows)
    n_mamba, n_attn = layer_counts(spec)
    proj, scan, state = _sizes(spec)
    attn = D * H * hd + 2 * D * KV * hd + H * hd * D
    shared = 3 * D * spec["shared_d_ff"]
    ssm_int8 = 2 * toks * proj
    ssm_f32 = toks * scan
    ssm_bytes = proj + len(rows) * state * (1 if fresh else 2)
    int8 = n_mamba * ssm_int8 + 2 * toks * (n_attn * attn + L * shared)
    f32 = (n_mamba * ssm_f32 + 2 * 3 * D * F * spec["top_k"] * L * toks
           + 2 * D * V * len(rows))
    ab, ao = attention_need(H, KV, hd, rows)
    return {"kind": kind, "tokens": toks, "int8_ops": int8,
            "f32_flops": f32, "attn_bytes": n_attn * ab,
            "attn_ops": n_attn * ao, "layers": n_attn,
            "ssm_int8_ops": ssm_int8, "ssm_f32_flops": ssm_f32,
            "ssm_bytes": ssm_bytes, "ssm_layers": n_mamba,
            "real": real.reshape(-1), "moe_touched": []}


def ssm_least_s(work, peaks) -> float:
    """Least time of a call's Mamba layers, a layer at a time."""
    if not work.get("ssm_layers"):
        return 0.0
    compute = (work["ssm_int8_ops"] / peaks["int8_ops_per_s"]
               + work["ssm_f32_flops"] / peaks["f32_flops_per_s"])
    return work["ssm_layers"] * max(
        compute, work["ssm_bytes"] / peaks["hbm_bytes_per_s"])
