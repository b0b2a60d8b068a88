"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at a
tiny size, and the result assembled as `bench/run.py` assembles it."""
import json
from pathlib import Path

import pytest

pytest.importorskip("repro_torch")

from bench import run as R  # noqa: E402
from bench.faults import (altered_token, half_batch,  # noqa: E402
                          state_unchanged)

from . import tiny  # noqa: E402

BENCH = json.loads((Path(__file__).resolve().parents[2]
                    / "BENCHMARK.json").read_text())


def _verdict(ctx, out):
    return R.result(BENCH, ctx, out, "cpu")


@pytest.mark.parametrize("cell", ["gpt2l-long", "mixtral4-decode"])
def test_sound_serving_run_is_correct_and_altered_token_is_not(cell):
    ctx, out = tiny.run(cell)
    assert _verdict(ctx, out)["correct"]
    ctx, out = tiny.run(cell, fault=altered_token)
    res = _verdict(ctx, out)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for k, c in res["checks"].items()
               if k.startswith("logit"))


def test_sound_training_run_is_correct():
    ctx, out = tiny.run("gpt2l-train")
    assert _verdict(ctx, out)["correct"]


@pytest.mark.parametrize("fault", [half_batch, state_unchanged],
                         ids=["half_batch", "state_unchanged"])
def test_broken_training_step_is_not_correct(fault):
    ctx, out = tiny.run("gpt2l-train", fault=fault)
    assert not _verdict(ctx, out)["correct"]
