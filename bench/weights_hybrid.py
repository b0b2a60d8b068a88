"""Random float weights of a hybrid Mamba-2 and attention configuration
(``family`` ``granite``), made on the device from a seed.

As `weights`: one ``torch.randn`` over every leaf at once, on a generator
on the device, each leaf a view of it. Every matrix 1/sqrt(fan-in), norm
scales (the gated norm's too) 1 + 0.1 N(0, 1). The tied embedding 0.02
over ``embedding_multiplier``, so that the scaled embedding has the 0.02
deviation of the other cells' (at 0.02 itself, times 12, each row's own
token outweighs the rest of its final state in the tied head: every
served token is the row's input token, whatever the precision, and the
logit check sees nothing). The
mixer's leaves are drawn so that one the program drops or misplaces shows
in the check: conv taps N(0, 1/W) for a width W (not the identity), conv
biases 0.1 N(0, 1), ``ssm_D`` 1 + 0.1 N(0, 1), ``A_log`` the log of A
uniform in [1, 16] and ``dt_bias`` the inverse softplus of dt log-uniform
in [1e-3, 1e-1], as Mamba-2 initialises them (uniforms made from the
normal draws through the normal's CDF). The tree has the port's layout,
which the references read too.
"""
from __future__ import annotations

import math

import torch

NORM_DEV = 0.1


def layout(spec: dict) -> list:
    """(path, shape, deviation, mean, kind) of every leaf; ``kind`` is
    ``normal`` (deviation x N + mean), ``a_log`` or ``dt_bias``."""
    D, H, KV, hd = (spec["d_model"], spec["n_heads"], spec["n_kv_heads"],
                    spec["head_dim"])
    F, V, E = spec["d_ff"], spec["vocab_size"], spec["n_experts"]
    Hs, P, N, G = (spec["ssm_heads"], spec["ssm_headdim"], spec["ssm_state"],
                   spec["ssm_groups"])
    W, d_in, Fs = spec["conv_width"], Hs * P, spec["shared_d_ff"]
    r = lambda n: 1.0 / math.sqrt(n)
    out = [(("embed", "tok_emb"), (V, D),
            0.02 / spec["embedding_multiplier"], 0.0, "normal"),
           (("final_norm", "scale"), (D,), NORM_DEV, 1.0, "normal")]
    pat = spec["mixer_pattern"]
    for i in range(spec["n_layers"]):
        b = ("blocks", i)
        out.append((b + ("norm1", "scale"), (D,), NORM_DEV, 1.0, "normal"))
        if pat[i % len(pat)] == "mamba":
            m = b + ("mamba",)
            out += [(m + ("w_z",), (D, d_in), r(D), 0.0, "normal"),
                    (m + ("w_x",), (D, d_in), r(D), 0.0, "normal"),
                    (m + ("w_B",), (D, G * N), r(D), 0.0, "normal"),
                    (m + ("w_C",), (D, G * N), r(D), 0.0, "normal"),
                    (m + ("w_dt",), (D, Hs), r(D), 0.0, "normal"),
                    (m + ("dt_bias",), (Hs,), 1.0, 0.0, "dt_bias"),
                    (m + ("A_log",), (Hs,), 1.0, 0.0, "a_log"),
                    (m + ("ssm_D",), (Hs,), NORM_DEV, 1.0, "normal")]
            for name, width in (("conv_x", d_in), ("conv_B", G * N),
                                ("conv_C", G * N)):
                out += [(m + (name,), (W, width), r(W), 0.0, "normal"),
                        (m + (name + "_bias",), (width,), NORM_DEV, 0.0,
                         "normal")]
            out += [(m + ("norm_scale",), (d_in,), NORM_DEV, 1.0, "normal"),
                    (m + ("out_proj",), (d_in, D), r(d_in), 0.0, "normal")]
        else:
            out += [(b + ("attn", "wq"), (D, H, hd), r(D), 0.0, "normal"),
                    (b + ("attn", "wk"), (D, KV, hd), r(D), 0.0, "normal"),
                    (b + ("attn", "wv"), (D, KV, hd), r(D), 0.0, "normal"),
                    (b + ("attn", "wo"), (H, hd, D), r(H * hd), 0.0,
                     "normal")]
        out += [(b + ("norm2", "scale"), (D,), NORM_DEV, 1.0, "normal"),
                (b + ("moe", "router"), (D, E), r(D), 0.0, "normal"),
                (b + ("moe", "w1"), (E, D, F), r(D), 0.0, "normal"),
                (b + ("moe", "w2"), (E, F, D), r(F), 0.0, "normal"),
                (b + ("moe", "w3"), (E, D, F), r(D), 0.0, "normal")]
        if Fs:
            out += [(b + ("shared", "w1"), (D, Fs), r(D), 0.0, "normal"),
                    (b + ("shared", "w2"), (Fs, D), r(Fs), 0.0, "normal"),
                    (b + ("shared", "w3"), (D, Fs), r(D), 0.0, "normal")]
    return out


def _uniform(z: torch.Tensor) -> torch.Tensor:
    """N(0, 1) draws as uniforms on (0, 1), in place."""
    return z.mul_(1.0 / math.sqrt(2.0)).erf_().add_(1.0).mul_(0.5)


def make(spec: dict, seed: int, device) -> dict:
    """The float32 weight tree of ``spec`` drawn from ``seed``."""
    leaves = layout(spec)
    n = sum(math.prod(shape) for _, shape, *_ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    tree: dict = {"blocks": [{} for _ in range(spec["n_layers"])]}
    off = 0
    lo, hi = math.log(1e-3), math.log(1e-1)
    for path, shape, dev, mean, kind in leaves:
        size = math.prod(shape)
        leaf = flat[off:off + size].view(shape)
        if kind == "a_log":  # A uniform in [1, 16]
            leaf = _uniform(leaf).mul_(15.0).add_(1.0).log_()
        elif kind == "dt_bias":  # inverse softplus of log-uniform dt
            dt = _uniform(leaf).mul_(hi - lo).add_(lo).exp_()
            leaf = dt.add_(torch.log(-torch.expm1(-dt)))
        else:
            leaf.mul_(dev)
            if mean:
                leaf.add_(mean)
        off += size
        node = tree
        for key in path[:-1]:
            node = node[key] if isinstance(key, int) else node.setdefault(
                key, {})
        node[path[-1]] = leaf
    return tree
