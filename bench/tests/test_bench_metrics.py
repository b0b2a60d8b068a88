"""The metric arithmetic on hand-made samples."""
import pytest

from bench import harness
from bench.entries.serve import window_metrics


def test_p95_is_nearest_rank():
    assert harness.percentile(list(range(1, 101)), 95) == 95
    assert harness.percentile([3.0, 1.0, 2.0], 95) == 3.0
    assert harness.percentile([5.0] * 19 + [100.0], 95) == 5.0
    assert harness.percentile([5.0] * 19 + [100.0, 100.0], 95) == 100.0


class _Loop:
    def __init__(self, recs):
        self.recs = dict(enumerate(recs))


def _rec(t, times, error=None):
    return {"t": t, "times": times, "done": None, "error": error}


def test_stalled_request_counts_at_its_elapsed_time():
    loop = _Loop([_rec(10.0, [10.5, 10.7]), _rec(11.0, [])])
    m = window_metrics(loop, 10.0, 14.0)
    assert m["attempted"] == 2
    assert m["ttft_p95_s"] == pytest.approx(3.0)  # 14 - 11, not left out


def test_tokens_counted_over_the_whole_window():
    # a request submitted before the window: its tokens inside count, its
    # TTFT does not; gaps count only between two tokens inside the window
    loop = _Loop([_rec(0.0, [1.0, 2.5, 3.0, 4.5]), _rec(2.0, [2.2, 2.4])])
    m = window_metrics(loop, 2.0, 4.0)
    assert m["tokens"] == 4           # 2.5, 3.0 and 2.2, 2.4
    assert m["tokens_per_s"] == pytest.approx(2.0)
    assert m["attempted"] == 1
    assert m["ttft_p95_s"] == pytest.approx(0.2)
    assert m["itl_p95_ms"] == pytest.approx(500.0)


def test_failed_requests_counted_against_attempted():
    loop = _Loop([_rec(1.0, [], error="refused"), _rec(1.5, [1.6])])
    m = window_metrics(loop, 0.0, 2.0)
    assert (m["attempted"], m["failed"]) == (2, 1)


def test_verdict_needs_every_limit_set_and_met():
    ok = {"a": {"value": 0.1, "limit": 0.2}}
    assert harness.verdict(ok)
    assert not harness.verdict({"a": {"value": 0.3, "limit": 0.2}})
    assert not harness.verdict({"a": {"value": 0.1, "limit": None}})
    assert not harness.verdict({})
