"""The frozen work counts against the port's `kernels.cost` and by hand."""
import pytest
import torch

from bench.yardstick import cost

pc = pytest.importorskip("repro_torch.kernels.cost")

@pytest.mark.parametrize("H,D,lens", [(20, 64, [700, 300, 1]),
                                     (16, 128, [64, 1024]),
                                     (48, 128, [256] * 8)])
def test_needed_attention_equals_the_port_at_decode(H, D, lens):
    """A decode call of full-head K and V: every live key unmasked, so the
    need is the port's paged count less the table and the lengths."""
    nbytes, ops = cost.attention_need(H, H, D, [(1, n, n) for n in lens])
    G, live = H * len(lens), H * sum(lens)
    pb, po = pc.total(pc.paged_attention(G, 1, D, live, 0, 0))
    assert (nbytes, ops) == (pb, po)


def test_gqa_reads_k_and_v_once_per_kv_head():
    """Grouped heads: q and the output per query head, K and V per KV
    head, the same pairs for every query head."""
    full = cost.attention_need(48, 48, 128, [(1, 300, 300)])
    gqa = cost.attention_need(48, 8, 128, [(1, 300, 300)])
    assert gqa[1] == full[1]
    assert full[0] - gqa[0] == 2 * (48 - 8) * 300 * 128


def _spec(**kw):
    s = dict(d_model=8, n_heads=2, n_kv_heads=2, head_dim=4, d_ff=16,
             vocab_size=10, n_layers=3, tie_embeddings=True)
    s.update(kw)
    return s


def test_chunk_call_counts_real_rows_and_causal_pairs():
    spec = _spec()
    toks = torch.zeros(2, 4, dtype=torch.int32)
    offs, feeds = torch.tensor([8, 0]), torch.tensor([3, 0])
    w = cost.call_work(spec, "prefill_chunk",
                       (None, toks, None, offs, feeds, None, 8), {})
    assert w["tokens"] == 3
    mats = 8 * 8 + 2 * 8 * 8 + 8 * 8 + 2 * 8 * 16
    assert w["int8_ops"] == 2 * 3 * 3 * mats
    assert w["f32_flops"] == 2 * 8 * 10 * 1      # one sampled row, tied head
    pairs = 9 + 10 + 11
    assert w["attn_ops"] == 3 * 4 * 2 * pairs * 4
    assert w["real"].tolist() == [True] * 3 + [False] * 5


def test_decode_call_skips_empty_slots_and_pad_keys():
    spec = _spec(n_experts=4, top_k=2, tie_embeddings=False)
    lens, pad = torch.tensor([10, 0, 5]), torch.tensor([4, 0, 0])
    w = cost.call_work(spec, "decode",
                       (None, torch.zeros(3, 1), None, lens),
                       {"pad_lens": pad})
    assert w["tokens"] == 2
    assert w["attn_ops"] == 3 * 4 * 2 * (6 + 5) * 4
    assert w["f32_flops"] == 2 * 3 * 8 * 16 * 2 * 3 * 2
    w["moe_touched"] = [4, 3, 4]
    peaks = {"f32_flops_per_s": 1.0, "hbm_bytes_per_s": 1e30}
    assert cost.moe_least_s(spec, w, peaks) == 3 * 2 * 3 * 8 * 16 * 2 * 2


def test_train_flops_are_three_forwards():
    f = cost.train_step_flops(_spec(), 2, 4)
    fwd = 2 * 8 * (3 * (8 * 8 * 4 + 2 * 8 * 16) + 8 * 10) + 3 * 4 * 8 * 2 * 10
    assert f == 3 * fwd
