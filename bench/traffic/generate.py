"""The one traffic generator: a mix file of parameters in, requests out.

A mix (``bench/traffic/<name>.json``) fixes the distribution of prompt
lengths and of new tokens, taken from the public dataset it names under
``source``. Its ``pool`` (prompt length, new tokens) pairs are set by the
mix alone: stratified quantiles of each distribution, paired by a fixed
shuffle. The stream a run draws from is ``blocks`` of them, each block the
whole pool in a fixed order of its own; the seed draws the token ids.

So every seed sends the same sizes in the same order, on other tokens, as
an evaluation harness sends one dataset's items in the dataset's order
every time it runs. The order of sizes decides how completions bunch into
one step, and with it how many admissions queue behind each other: drawn
from the seed, it moved one cell's 95th-percentile time to first token
between one and two queued admissions from seed to seed.

Distributions: ``lognormal`` (``median``, or ``mean`` of the unclipped
distribution, and ``sigma``) and ``uniform``, each clipped to [``min``,
``max``] and rounded to whole tokens.
"""
from __future__ import annotations

import json
from pathlib import Path
from statistics import NormalDist

import numpy as np

HERE = Path(__file__).resolve().parent
PAIRING_SEED = 20260401  # fixes which prompt length meets which output length
ORDER_SEED = 20260402    # fixes the order of the sizes in the stream


def load(name: str) -> dict:
    return json.loads((HERE / f"{name}.json").read_text())


def _quantiles(dist: dict, n: int) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(p)) for p in u])
        median = (dist["median"] if "median" in dist
                  else dist["mean"] * np.exp(-dist["sigma"] ** 2 / 2))
        x = median * np.exp(dist["sigma"] * z)
    elif dist["dist"] == "uniform":
        x = dist["min"] + u * (dist["max"] + 1 - dist["min"]) - 0.5
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return np.clip(np.round(x), dist["min"], dist["max"]).astype(np.int64)


def sizes(mix: dict) -> list:
    """The mix's (prompt length, new tokens) pairs, in pairing order."""
    n = int(mix["pool"])
    prompts = _quantiles(mix["prompt"], n)
    news = _quantiles(mix["new_tokens"], n)
    news = news[np.random.default_rng(PAIRING_SEED).permutation(n)]
    return list(zip(prompts.tolist(), news.tolist()))


def requests(mix: dict, seed: int, vocab: int) -> list:
    """Every request a run can send, in the order the clients draw them:
    (prompt int32 array, new tokens). Token ids are uniform over
    [1, vocab); 0 is the pad id."""
    pairs = sizes(mix)
    fixed = np.random.default_rng(ORDER_SEED)
    order = np.concatenate([fixed.permutation(len(pairs))
                            for _ in range(int(mix["blocks"]))])
    total = sum(pairs[i][0] for i in order)
    rng = np.random.default_rng(int(seed) % 2 ** 63)
    ids = rng.integers(1, vocab, total, dtype=np.int64).astype(np.int32)
    out, at = [], 0
    for i in order:
        p, new = pairs[i]
        out.append((ids[at:at + p], int(new)))
        at += p
    return out


def mean_tokens(mix: dict) -> tuple:
    """(mean prompt length, mean new tokens) of the mix."""
    pairs = sizes(mix)
    return (sum(p for p, _ in pairs) / len(pairs),
            sum(n for _, n in pairs) / len(pairs))


if __name__ == "__main__":
    import sys
    mix = load(sys.argv[1])
    p, n = mean_tokens(mix)
    print(json.dumps({"mix": sys.argv[1], "mean_prompt": p,
                      "mean_new_tokens": n,
                      "pool": int(mix["pool"])}))
