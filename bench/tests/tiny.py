"""Tiny versions of the cells, for runs of the whole harness on the CPU."""
import torch

from bench import run as R

torch.set_num_threads(1)

TINY = {
    "gpt2l-long": {
        "model": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      head_dim=16, d_ff=128, vocab_size=256),
        "serve": dict(slots=4, page_size=8, prefill_chunk=16, max_len=64),
        "mix": dict(clients=4, pool=16, blocks=8,
                    prompt={"dist": "lognormal", "median": 24, "sigma": 0.3,
                            "min": 12, "max": 40},
                    new_tokens={"dist": "uniform", "min": 2, "max": 6})},
    "mixtral4-decode": {
        "model": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab_size=256, n_experts=4,
                      top_k=2),
        "serve": dict(slots=4, prefill_len=24, max_len=48),
        "mix": dict(clients=4, pool=16, blocks=8,
                    prompt={"dist": "lognormal", "median": 16, "sigma": 0.3,
                            "min": 8, "max": 24},
                    new_tokens={"dist": "uniform", "min": 4, "max": 12})},
    "gpt2l-train": {
        "model": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      head_dim=16, d_ff=128, vocab_size=256,
                      position_rows=64),
        "mix": dict(batch=4, seq=32)},
}


def run(cell, seed=4_000_000_007, seconds=0.3, trace=False, control=False,
        fault=None):
    """(context, entry output) of one tiny run on the CPU."""
    ctx = R.context(cell, seed, seconds, trace, torch.device("cpu"),
                    control=control, fault=fault, overrides=TINY[cell])
    return ctx, R.entry(ctx).run(ctx)
