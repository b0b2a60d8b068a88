"""The port's `SyntheticLM` against the reference's: the same tokens bit for
bit over vocab sizes, seeds, lengths and shards, and after `skip`,
`set_state` and a restore from `state()`."""
import numpy as np
import pytest

pytest.importorskip("torch")

import _torch_helpers  # noqa: E402,F401  (one torch thread a worker)

from repro.data import SyntheticLM as RSyn  # noqa: E402
from repro_torch.data import SyntheticLM as TSyn  # noqa: E402


def _both(**kw):
    return RSyn(**kw), TSyn(**kw)


def _equal(r, t, n=3):
    for _ in range(n):
        a, b = r.next_batch(), t.next_batch()
        assert a.keys() == b.keys() == {"tokens"}
        assert a["tokens"].dtype == b["tokens"].dtype == np.int32
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("vocab,seq,batch,seed,table_seed", [
    (256, 128, 4, 0, 1234), (128, 32, 8, 5, 1234), (512, 17, 3, 7, 9),
    (50257, 64, 2, 0, 1234), (64, 4, 2, 3, 1), (1000, 256, 1, 11, 1234)])
def test_tokens_equal_bit_for_bit(vocab, seq, batch, seed, table_seed):
    r, t = _both(vocab_size=vocab, seq_len=seq, global_batch=batch,
                 seed=seed, table_seed=table_seed)
    np.testing.assert_array_equal(r._succ, t._succ)
    _equal(r, t)


@pytest.mark.parametrize("count", [2, 4])
def test_shards_equal_and_partition(count):
    outs = []
    for i in range(count):
        r, t = _both(vocab_size=256, seq_len=16, global_batch=8, seed=1,
                     shard_index=i, shard_count=count)
        assert r.local_batch == t.local_batch == 8 // count
        a, b = r.next_batch()["tokens"], t.next_batch()["tokens"]
        np.testing.assert_array_equal(a, b)
        outs.append(b)
    assert not np.array_equal(outs[0], outs[1])


def test_skip_set_state_and_state_equal():
    r, t = _both(vocab_size=256, seq_len=16, global_batch=4, seed=2)
    r.skip(3)
    t.skip(3)
    assert r.state() == t.state() == {"step": 3, "seed": 2}
    _equal(r, t, 2)
    # a fresh stream restored from the other's state continues it
    r2, t2 = _both(vocab_size=256, seq_len=16, global_batch=4, seed=2)
    r2.set_state(r.state())
    t2.set_state(t.state())
    _equal(r2, t2, 2)
    np.testing.assert_array_equal(t.next_batch()["tokens"],
                                  TSyn(vocab_size=256, seq_len=16,
                                       global_batch=4, seed=2,
                                       _step=5).next_batch()["tokens"])


def test_iterator_and_uneven_shards():
    r, t = _both(vocab_size=96, seq_len=8, global_batch=2, seed=4)
    for a, b, _ in zip(iter(r), iter(t), range(3)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    with pytest.raises(ValueError):
        TSyn(global_batch=6, shard_count=4).local_batch
