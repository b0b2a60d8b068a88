"""Step-clock serving latency metrics: TTFT, per-token latency, fairness.

The recorder's clock is the **scheduler step counter** — `ServeMetrics
.tick()` once at the top of every `ContinuousBatcher.step()` — never
wall-clock: nothing here touches a traced value or a timer, so the
numbers are bit-deterministic across runs and machines and can gate CI
(`ContinuousBatcher.summary()` merges them into the report that
`launch/serve.py` reads). One step is one scheduler round (admissions +
at most one chunk call + at most one decode call), which is exactly the
unit an accelerator pays for: a request's step-TTFT counts the queue wait
plus every chunk call its prompt needed, so a prefix-cache hit that skips
chunk calls shows up directly.

Latency definitions (all in steps):

    TTFT        steps from ``on_submit`` to the request's first sampled
                token (``on_first_token``) — queue wait included, which
                is what the admission router redistributes;
    per-token   steps between consecutive sampled tokens of one request
                (``on_token``); 1 is a perfectly-occupied decode, >1
                means the slot sat out steps (pool mid-prefill, etc.).

`Histogram` keeps raw samples (these are scheduler counters, thousands
at most, not a hot path) and reports exact order-statistic percentiles —
p50/p99 by the nearest-rank rule — plus mean/max. `jain` is Jain's
fairness index over per-tenant weighted service, the summary's
``fairness_jain``.
"""
from __future__ import annotations

from typing import Optional, Sequence

__all__ = ["Histogram", "ServeMetrics", "jain"]


def jain(xs: Sequence[float]) -> float:
    """Jain's fairness index: (Σx)² / (n·Σx²) ∈ (0, 1], 1 = equal.

    Callers pass *weight-normalized* service (tokens_served / weight per
    tenant), so 1.0 means every tenant got service exactly proportional
    to its weight.
    """
    xs = [float(x) for x in xs]
    if not xs:
        return 1.0
    sq = sum(x * x for x in xs)
    if sq == 0.0:
        return 1.0
    return (sum(xs) ** 2) / (len(xs) * sq)


class Histogram:
    """Exact percentiles over integer step counts (nearest-rank)."""

    def __init__(self):
        self.samples: list[float] = []

    def add(self, value: float) -> None:
        self.samples.append(float(value))

    def __len__(self) -> int:
        return len(self.samples)

    def percentile(self, p: float) -> Optional[float]:
        """Nearest-rank percentile; None when empty."""
        if not self.samples:
            return None
        if not 0 < p <= 100:
            raise ValueError(f"percentile p={p} must be in (0, 100]")
        ordered = sorted(self.samples)
        rank = max(1, -(-len(ordered) * p // 100))  # ceil(n*p/100)
        return ordered[int(rank) - 1]

    def summary(self) -> dict:
        if not self.samples:
            return {"n": 0, "p50": None, "p99": None, "mean": None,
                    "max": None}
        return {
            "n": len(self.samples),
            "p50": self.percentile(50),
            "p99": self.percentile(99),
            "mean": sum(self.samples) / len(self.samples),
            "max": max(self.samples),
        }


class ServeMetrics:
    """Per-request latency + per-tenant service accounting for a batcher.

    Host-side only. The batcher drives it:

        tick             top of every step()
        on_submit        submit() accepted the request into the queue
        on_reject        submit() retired it with a structured error
        on_first_token   the request sampled its first token
        on_token         every subsequent sampled token
        on_error         retired mid-flight by a fault

    ``tenant_tokens`` counts *all* sampled tokens per tenant — the
    service measure `jain` weighs for the fairness row.
    """

    def __init__(self):
        self.step = 0
        self.ttft = Histogram()
        self.tpl = Histogram()  # per-token (inter-token) latency
        self._submitted: dict[int, int] = {}   # rid -> submit step
        self._last_tok: dict[int, int] = {}    # rid -> last token step
        self.tenant_tokens: dict[str, int] = {}
        self.tenant_requests: dict[str, int] = {}
        self.rejected = 0
        self.errored = 0

    # ------------------------------------------------------------- events
    def tick(self) -> None:
        self.step += 1

    def on_submit(self, rid: int, tenant: str = "default") -> None:
        self._submitted[rid] = self.step
        self.tenant_requests[tenant] = self.tenant_requests.get(tenant, 0) + 1

    def on_reject(self, rid: int) -> None:
        self._submitted.pop(rid, None)
        self.rejected += 1

    def on_first_token(self, rid: int, tenant: str = "default") -> None:
        submitted = self._submitted.pop(rid, None)
        if submitted is not None:
            self.ttft.add(self.step - submitted)
        self._last_tok[rid] = self.step
        self.tenant_tokens[tenant] = self.tenant_tokens.get(tenant, 0) + 1

    def on_token(self, rid: int, tenant: str = "default") -> None:
        last = self._last_tok.get(rid)
        if last is not None:
            self.tpl.add(self.step - last)
        self._last_tok[rid] = self.step
        self.tenant_tokens[tenant] = self.tenant_tokens.get(tenant, 0) + 1

    def on_error(self, rid: int) -> None:
        self._submitted.pop(rid, None)
        self._last_tok.pop(rid, None)
        self.errored += 1

    # -------------------------------------------------------------- report
    def fairness(self, weights: Optional[dict] = None) -> float:
        """Jain index over tokens-served / weight across tenants seen."""
        weights = weights or {}
        if not self.tenant_tokens:
            return 1.0
        return jain([tok / float(weights.get(t, 1.0))
                     for t, tok in sorted(self.tenant_tokens.items())])

    def summary(self) -> dict:
        ttft, tpl = self.ttft.summary(), self.tpl.summary()
        return {
            "steps": self.step,
            "ttft_p50": ttft["p50"], "ttft_p99": ttft["p99"],
            "ttft_mean": ttft["mean"], "ttft_n": ttft["n"],
            "tpl_p50": tpl["p50"], "tpl_p99": tpl["p99"],
            "tpl_mean": tpl["mean"], "tpl_n": tpl["n"],
            "tenant_tokens": dict(sorted(self.tenant_tokens.items())),
            "tenant_requests": dict(sorted(self.tenant_requests.items())),
            "rejected": self.rejected,
            "errored": self.errored,
        }
