"""The plain references against the port at a tiny size of each cell, on
the CPU: the served calls' logits and written keys and values, and the
training steps' losses, gradients and changes. A wrong reference shows
here before any card time is spent."""
import json
from pathlib import Path

import pytest

pytest.importorskip("repro_torch")

from . import tiny  # noqa: E402

BENCH = json.loads((Path(__file__).resolve().parents[2]
                    / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", ["gpt2l-long", "mixtral4-decode"])
def test_serving_reference_follows_the_port(cell):
    _, out = tiny.run(cell)
    r = out["readings"]
    assert r["calls"] >= 2 and r["rows"] >= 2
    assert r["logit_gap"] <= 1e-5
    assert r["kv_err"] <= 1e-5


def test_training_reference_follows_the_port():
    _, out = tiny.run("gpt2l-train")
    r = out["readings"]
    assert r["loss_gap"] <= 1e-6
    assert r["grad_gap"] <= 1e-5
    assert r["change_gap"] <= 1e-5
    assert out["attempted"] >= 1 and out["failed"] == 0


def _judged(ctx, out, name):
    """``run.result``'s verdict on the variant ``name`` in the program's
    place."""
    from bench import run as R
    return R.result(BENCH, ctx, {**out, "readings": out["variants"][name]},
                    "cpu")


@pytest.mark.parametrize("cell", ["gpt2l-long", "mixtral4-decode"])
def test_four_bit_control_reads_far_off(cell):
    """The lower-precision control (int4 codes in place of int8) at a tiny
    size: the result it gives is not correct."""
    ctx, out = tiny.run(cell, control=True)
    res = _judged(ctx, out, "int4")
    assert not res["correct"]
    assert out["variants"]["int4"]["kv_mean_err"] > 0.1


@pytest.mark.parametrize("cell", ["gpt2l-long", "mixtral4-decode"])
def test_sound_reorder_comes_out_correct(cell):
    """The reference in another float32 order in the program's place: the
    result it gives is correct."""
    ctx, out = tiny.run(cell, control=True)
    assert out["variants"]["apart"]["sound"]
    assert _judged(ctx, out, "apart")["correct"]


def test_expert_precision_controls_move_the_keys():
    """TF32 and bfloat16 experts in the reference change what the MoE
    cell writes, bfloat16 more than TF32."""
    _, out = tiny.run("mixtral4-decode", control=True)
    v = out["variants"]
    assert not v["tf32_experts"]["sound"] and not v["bf16_experts"]["sound"]
    assert 0 < v["tf32_experts"]["kv_mean_err"] \
        < v["bf16_experts"]["kv_mean_err"]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    import torch
    from bench.reference.decoder import tf32
    x = torch.randn(4096, generator=torch.Generator().manual_seed(5))
    y = tf32(x)
    assert int((y.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float(((y - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert float((y - x).abs().max()) > 0


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (TF32 exists only there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tf32_control_reads_far_off(card):
    """Training's control, the reference in TF32 in the program's place,
    at a tiny size on the card: it fails a limit the program meets."""
    from bench import run as R
    ctx = R.context("gpt2l-train", 4_000_000_009, 0.3, False, card,
                    control=True, overrides=tiny.TINY["gpt2l-train"])
    out = R.entry(ctx).run(ctx)
    assert R.result(BENCH, ctx, out, "cuda")["correct"]
    assert not _judged(ctx, out, "tf32")["correct"]


def test_paged_capture_keeps_each_page_content_once():
    """Two captures share the pages no call wrote in between; a written
    page is kept anew; pages past every row's live length are not kept."""
    import torch
    from bench.entries.serve import PageStore
    cache = [{"attn": {"k": torch.randn(6, 4, 2, 3),
                       "v": torch.randn(6, 4, 2, 3)}} for _ in range(2)]
    bt = torch.tensor([[1, 2, 5], [3, 4, 0]])
    store = PageStore()
    a = store.snap(cache, bt, torch.tensor([6, 3]), 4)
    assert sorted(a) == [1, 2, 3]
    cache[1]["attn"]["v"][2, 3] += 1.0
    b = store.snap(cache, bt, torch.tensor([7, 3]), 4)
    assert b[1] is a[1] and b[3] is a[3] and b[2] is not a[2]
    assert torch.equal(b[2][1, 1], cache[1]["attn"]["v"][2])
