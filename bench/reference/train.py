"""Plain reference of the training cells: a decoder's float32 loss, its
gradients by autograd, and AdamW, step by step.

The model is the GPT-2 block (pre-LayerNorm with epsilon 1e-6, causal
softmax attention with biased q/k/v, GELU in its tanh form, learned
positions, the lm head tied to the token embedding); the loss the mean
next-token cross entropy. AdamW is the configuration's: gradients clipped
to a global norm, bias-corrected moments, decoupled weight decay on
matrices only, a linear warm-up then a cosine. Nothing here imports the
measured program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _ln(x, p):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * p["scale"] + p["bias"]


def loss(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    emb = params["embed"]
    x = emb["tok_emb"][tokens] + emb["pos_emb"][:S]
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    for lp in params["blocks"]:
        a = lp["attn"]
        h = _ln(x, lp["norm1"])
        q = torch.einsum("bsd,dhk->bshk", h, a["wq"]) + a["bq"]
        k = torch.einsum("bsd,dhk->bshk", h, a["wk"]) + a["bk"]
        v = torch.einsum("bsd,dhk->bshk", h, a["wv"]) + a["bv"]
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
        s = s.masked_fill(~causal, float("-inf"))
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
        x = x + torch.einsum("bshd,hdm->bsm", o, a["wo"])
        h = _ln(x, lp["norm2"])
        x = x + F.gelu(h @ lp["ffn"]["w1"], approximate="tanh") \
            @ lp["ffn"]["w2"]
    logits = _ln(x, params["final_norm"]) @ emb["tok_emb"].T
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def leaves(tree, path=()):
    """(path, tensor) of every leaf, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from leaves(t, path + (i,))
    else:
        yield path, tree


def rebuild(tree, values):
    it = iter(values)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(x) for x in t)
        return next(it)
    return walk(tree)


class AdamW:
    def __init__(self, lr, warmup, total, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, clip=1.0, min_ratio=0.1):
        self.__dict__.update(lr=lr, warmup=warmup, total=total, b1=b1, b2=b2,
                             eps=eps, wd=weight_decay, clip=clip,
                             min_ratio=min_ratio)

    def rate(self, t: int) -> float:
        if t < self.warmup:
            return self.lr * t / self.warmup
        prog = min(max((t - self.warmup) / max(self.total - self.warmup, 1),
                       0.0), 1.0)
        return self.lr * (self.min_ratio + (1 - self.min_ratio) * 0.5
                          * (1 + math.cos(math.pi * prog)))


def run(params: dict, batches: list, opt: AdamW) -> dict:
    """``len(batches)`` steps from ``params``: each step's loss, the first
    step's clipped gradient a leaf, and the parameters after the last
    step, as a list in `leaves` order."""
    ps = [t.detach().clone().float() for _, t in leaves(params)]
    mu = [torch.zeros_like(p) for p in ps]
    nu = [torch.zeros_like(p) for p in ps]
    losses, first = [], None
    for t, tokens in enumerate(batches, start=1):
        flat = [p.requires_grad_(True) for p in ps]
        with torch.enable_grad():
            value = loss(rebuild(params, flat), tokens)
            grads = torch.autograd.grad(value, flat)
        losses.append(float(value.detach()))
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        scale = torch.clamp_max(opt.clip / torch.clamp_min(norm, 1e-9), 1.0)
        grads = [g * scale for g in grads]
        if first is None:
            first = [g.detach().clone() for g in grads]
        lr = opt.rate(t)
        c1, c2 = 1 - opt.b1 ** t, 1 - opt.b2 ** t
        new = []
        with torch.no_grad():
            for p, g, m, v in zip(ps, grads, mu, nu):
                m.mul_(opt.b1).add_((1 - opt.b1) * g)
                v.mul_(opt.b2).add_((1 - opt.b2) * g * g)
                u = (m / c1) / (torch.sqrt(v / c2) + opt.eps)
                if p.ndim >= 2:
                    u = u + opt.wd * p
                new.append(p.detach() - lr * u)
        ps = new
    return {"losses": losses, "grads": first, "params": ps}
