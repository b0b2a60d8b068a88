"""Deterministic synthetic LM data with learnable structure.

The port of `repro.data.synthetic`, numpy only, so its tokens are the
reference's bit for bit. The stream mixes Markov bigram structure with
induction-head patterns (`A B ... A -> B`), so a small transformer trained
on it shows a clear accuracy signal.

The iterator is stateful and checkpointable: `state()`/`set_state()` give
exact restore, and `skip(n)` fast-forwards after a restart. Sharding: each
data-parallel rank takes its slice of the global batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticLM"]


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int = 256
    seq_len: int = 128
    global_batch: int = 32
    seed: int = 0            # stream seed (varies train/eval)
    table_seed: int = 1234   # bigram-structure seed (fixed across splits)
    shard_index: int = 0
    shard_count: int = 1
    _step: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.table_seed)
        # sparse bigram transition table
        k = max(2, self.vocab_size // 64)  # small branching: a clear top-1
        self._succ = rng.integers(0, self.vocab_size,
                                  (self.vocab_size, k)).astype(np.int32)

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.shard_count:
            raise ValueError(f"global_batch {self.global_batch} does not "
                             f"split into {self.shard_count} shards")
        return self.global_batch // self.shard_count

    def state(self) -> dict:
        return {"step": self._step, "seed": self.seed}

    def set_state(self, st: dict):
        self._step = int(st["step"])

    def skip(self, n: int):
        self._step += int(n)

    def next_batch(self) -> dict:
        rng = np.random.default_rng(
            (self.seed, self._step, self.shard_index))
        self._step += 1
        B, S, V = self.local_batch, self.seq_len, self.vocab_size
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.integers(0, V, B)
        choose = rng.integers(0, self._succ.shape[1], (B, S))
        for t in range(1, S):
            toks[:, t] = self._succ[toks[:, t - 1], choose[:, t]]
        # plant induction patterns: copy a random earlier bigram forward
        n_pat = max(1, S // 16)
        for b in range(B):
            starts = rng.integers(1, S - 2, n_pat)
            for s in starts:
                src = rng.integers(0, max(1, s - 1))
                toks[b, s] = toks[b, src]
                toks[b, min(s + 1, S - 1)] = toks[b, src + 1]
        return {"tokens": toks}

    def __iter__(self):
        while True:
            yield self.next_batch()
