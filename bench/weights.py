"""Random float weights of a configuration, made on the device from a seed.

One ``torch.randn`` over every leaf at once, on a generator on the device,
then each leaf a view of it times its deviation plus its mean: embeddings
0.02, every matrix 1/sqrt(fan-in), norm scales 1 + 0.1 N(0, 1), norm and
projection biases 0.1 N(0, 1). Norm scales and biases that are not 1 and 0
make a bias or a scale that the program drops or misplaces show in the
check. The tree has the port's layout (``embed``, ``final_norm``,
``blocks``), which the reference reads too.
"""
from __future__ import annotations

import math

import torch


NORM_DEV = 0.1   # the deviation of norm scales about 1 and of biases


def layout(spec: dict) -> list:
    """(path, shape, deviation, mean) of every leaf."""
    D, H, KV, hd = (spec["d_model"], spec["n_heads"], spec["n_kv_heads"],
                    spec["head_dim"])
    F, V = spec["d_ff"], spec["vocab_size"]
    r = lambda n: 1.0 / math.sqrt(n)
    out = [(("embed", "tok_emb"), (V, D), 0.02, 0.0)]
    if spec["pos_emb"] == "learned":
        out.append((("embed", "pos_emb"), (spec["position_rows"], D), 0.02,
                    0.0))
    if not spec["tie_embeddings"]:
        out.append((("embed", "unembed"), (D, V), r(D), 0.0))

    def norm(path):
        out.append((path + ("scale",), (D,), NORM_DEV, 1.0))
        if spec["norm"] == "layernorm":
            out.append((path + ("bias",), (D,), NORM_DEV, 0.0))

    norm(("final_norm",))
    for i in range(spec["n_layers"]):
        b = ("blocks", i)
        norm(b + ("norm1",))
        out += [(b + ("attn", "wq"), (D, H, hd), r(D), 0.0),
                (b + ("attn", "wk"), (D, KV, hd), r(D), 0.0),
                (b + ("attn", "wv"), (D, KV, hd), r(D), 0.0),
                (b + ("attn", "wo"), (H, hd, D), r(H * hd), 0.0)]
        if spec["qkv_bias"]:
            out += [(b + ("attn", "bq"), (H, hd), NORM_DEV, 0.0),
                    (b + ("attn", "bk"), (KV, hd), NORM_DEV, 0.0),
                    (b + ("attn", "bv"), (KV, hd), NORM_DEV, 0.0)]
        norm(b + ("norm2",))
        if spec.get("n_experts"):
            E = spec["n_experts"]
            out += [(b + ("moe", "router"), (D, E), r(D), 0.0),
                    (b + ("moe", "w1"), (E, D, F), r(D), 0.0),
                    (b + ("moe", "w2"), (E, F, D), r(F), 0.0),
                    (b + ("moe", "w3"), (E, D, F), r(D), 0.0)]
        else:
            out += [(b + ("ffn", "w1"), (D, F), r(D), 0.0),
                    (b + ("ffn", "w2"), (F, D), r(F), 0.0)]
    return out


def make(spec: dict, seed: int, device) -> dict:
    """The float32 weight tree of ``spec`` drawn from ``seed``."""
    leaves = layout(spec)
    n = sum(math.prod(shape) for _, shape, _, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    tree: dict = {"blocks": [{} for _ in range(spec["n_layers"])]}
    off = 0
    for path, shape, dev, mean in leaves:
        size = math.prod(shape)
        leaf = flat[off:off + size].view(shape).mul_(dev)
        if mean:
            leaf.add_(mean)
        off += size
        node = tree
        for key in path[:-1]:
            if isinstance(key, int):
                node = node[key]
            else:
                node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree
