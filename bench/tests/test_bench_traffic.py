"""The traffic generator: deterministic per seed, lengths in their clips,
the same work for every seed."""
import numpy as np
import pytest

from bench.traffic import generate

MIXES = ("long-doc", "moe-gen")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = generate.load(name)
    a = generate.requests(mix, 2 ** 31 + 11, 50257)
    b = generate.requests(mix, 2 ** 31 + 11, 50257)
    assert len(a) == len(b) == mix["pool"] * mix["blocks"]
    assert all(np.array_equal(p, q) and m == n for (p, m), (q, n) in zip(a, b))


@pytest.mark.parametrize("name", MIXES)
def test_lengths_within_clips_and_ids_in_vocab(name):
    mix = generate.load(name)
    reqs = generate.requests(mix, 5, 32768)
    lens = np.array([len(p) for p, _ in reqs])
    news = np.array([n for _, n in reqs])
    assert lens.min() >= mix["prompt"]["min"]
    assert lens.max() <= mix["prompt"]["max"]
    assert news.min() >= mix["new_tokens"]["min"]
    assert news.max() <= mix["new_tokens"]["max"]
    ids = np.concatenate([p for p, _ in reqs])
    assert ids.min() >= 1 and ids.max() < 32768


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_same_sizes_in_the_same_order(name):
    mix = generate.load(name)
    a = generate.requests(mix, 1, 1000)
    b = generate.requests(mix, 2, 1000)
    assert [(len(p), m) for p, m in a] == [(len(p), m) for p, m in b]
    assert not all(np.array_equal(p, q) for (p, _), (q, _) in zip(a, b))
    n = mix["pool"]
    pool = sorted(generate.sizes(mix))
    for k in range(0, len(a), n):  # each block is the whole pool
        assert sorted((len(p), m) for p, m in a[k:k + n]) == pool


def test_lognormal_median_near_its_parameter():
    """A mix set by its mean has the median mean * exp(-sigma^2 / 2)."""
    mix = generate.load("long-doc")
    d = mix["prompt"]
    lens = sorted(p for p, _ in generate.sizes(mix))
    median = d["mean"] * np.exp(-d["sigma"] ** 2 / 2)
    assert abs(lens[len(lens) // 2] - median) <= 12
    by_median = {**mix, "prompt": {**d, "median": median}}
    assert generate.sizes(by_median) == generate.sizes(mix)
