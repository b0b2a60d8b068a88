"""Tenant-aware admission routing in front of the continuous batcher.

`AdmissionRouter` replaces `ContinuousBatcher`'s plain FIFO deque: it
holds the queued `Request`s per tenant and decides which one the next
admission (`_admit` / `_admit_paged`) sees. It exposes the same surface
the batcher already consumed — truthiness, ``len``, iteration,
``router[0]`` (peek) and ``popleft()`` — so every existing drain loop and
backpressure path works unchanged; only the *identity* of the head is now
policy-driven.

Policies (``policy=``):

    fifo       global arrival order, tenant-blind (the PR-7 behaviour);
    priority   strict priority by tenant weight (higher weight first),
               FIFO within a weight class — a starving low-priority
               tenant is the *documented* behaviour of this policy;
    wfq        weighted-fair queuing via deficit round-robin on a token
               budget: each tenant accrues ``quantum * weight`` tokens of
               deficit whenever the round-robin pointer passes it by, and
               is selected once its deficit covers its head request's
               cost (``len(prompt) + n_new`` tokens). Every pass over the
               ring tops up every waiting tenant, so no tenant starves,
               and long-run admitted tokens are proportional to weights
               while tenants stay backlogged.

The chosen head *blocks*: if the batcher cannot admit it (page-pool
backpressure), admission stops for the step and the same head is offered
next step. Skipping to a smaller request would silently starve the
chosen tenant — exactly what the policy exists to prevent — so the
backpressure semantics of PR 7's FIFO queue carry over per-policy.

Per-tenant queue-depth caps (``max_queue_per_tenant``) reject *at
submit*: ``push`` returns a structured
`RequestError(stage="admit")` instead of raising, and the batcher
retires the request with that error — operational overload is data, not
an exception (malformed requests still raise ValueError at ``submit``).
"""
from __future__ import annotations

from collections import deque
from typing import Iterator, Optional

from .batching import Request, RequestError

__all__ = ["AdmissionRouter", "POLICIES"]

POLICIES = ("fifo", "priority", "wfq")


def request_cost(req: Request) -> int:
    """Token budget a request admits: prompt plus every generated token.

    This is the deficit-round-robin currency — proportional to the page
    reservation (and so to KV footprint and decode-step occupancy), which
    is the resource tenants actually contend for.
    """
    return len(req.prompt) + req.n_new


class AdmissionRouter:
    """Policy-routed multi-tenant admission queue (deque-compatible).

    ``weights`` maps tenant name -> weight (default 1.0): wfq shares
    admitted tokens proportionally; priority treats the weight as a
    strict priority level. Unknown tenants get weight 1.0 — a tenant
    exists the moment a request names it.
    """

    def __init__(self, policy: str = "fifo",
                 weights: Optional[dict] = None,
                 max_queue_per_tenant: Optional[int] = None,
                 quantum: float = 32.0):
        if policy not in POLICIES:
            raise ValueError(f"unknown router policy {policy!r}; "
                             f"choose from {POLICIES}")
        if quantum <= 0:
            raise ValueError(f"quantum={quantum} must be > 0")
        if max_queue_per_tenant is not None and max_queue_per_tenant < 1:
            raise ValueError(f"max_queue_per_tenant={max_queue_per_tenant} "
                             f"must be >= 1 (or None for uncapped)")
        self.policy = policy
        self.weights = dict(weights or {})
        self.cap = max_queue_per_tenant
        self.quantum = float(quantum)
        self._queues: dict[str, deque] = {}
        self._ring: list[str] = []      # tenant round-robin ring (wfq)
        self._rr = 0                    # ring pointer
        self._topped = False            # pointer tenant got its per-visit
                                        # quantum already (DRR tops up once
                                        # per ARRIVAL of the pointer, not
                                        # once per reconsideration)
        self._deficit: dict[str, float] = {}
        self._seq = 0                   # global arrival counter
        self._choice: Optional[str] = None  # memoized chosen tenant
        self.rejected = 0               # depth-cap rejections (stats)

    # ------------------------------------------------------------ plumbing
    def weight(self, tenant: str) -> float:
        return float(self.weights.get(tenant, 1.0))

    def depths(self) -> dict[str, int]:
        """Queued requests per tenant (stats/reporting)."""
        return {t: len(q) for t, q in self._queues.items() if q}

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def __bool__(self) -> bool:
        return any(self._queues.values())

    def __iter__(self) -> Iterator[Request]:
        """All queued requests in arrival order (feasibility scans —
        `ContinuousBatcher._lock_prefill_len` — not service order)."""
        entries = [e for q in self._queues.values() for e in q]
        return iter(r for _, r in sorted(entries, key=lambda e: e[0]))

    def __getitem__(self, idx: int) -> Request:
        if idx != 0:
            raise IndexError("AdmissionRouter exposes only the policy head "
                             "([0]); iterate for the full queue")
        head = self.peek()
        if head is None:
            raise IndexError("peek from an empty router")
        return head

    # ------------------------------------------------------------- ingress
    def push(self, req: Request) -> Optional[RequestError]:
        """Enqueue; returns a structured rejection (None = accepted).

        Depth-cap rejections are operational backpressure, not errors in
        the program: the caller attaches the record to ``req.error`` and
        retires it, and the submitting tenant sees a typed admit-stage
        failure naming its own queue depth.
        """
        tenant = req.tenant
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = deque()
            self._ring.append(tenant)
            self._deficit.setdefault(tenant, 0.0)
        if self.cap is not None and len(q) >= self.cap:
            self.rejected += 1
            return RequestError(
                rid=req.rid, stage="admit", step=0,
                reason=f"tenant {tenant!r} queue depth cap "
                       f"({self.cap}) reached")
        q.append((self._seq, req))
        self._seq += 1
        return None

    # ------------------------------------------------------------- egress
    def _select(self) -> Optional[str]:
        """Pick the tenant whose head serves next.

        fifo/priority are pure functions of the queues (a later
        high-priority arrival preempts an un-popped head); wfq memoizes
        its choice so peek and pop agree without double-charging deficits.
        """
        heads = {t: q[0] for t, q in self._queues.items() if q}
        if not heads:
            self._choice = None
            return None
        if self.policy == "fifo":
            return min(heads, key=lambda t: heads[t][0])
        if self.policy == "priority":
            # strict: highest weight wins, arrival order within a class
            return min(heads,
                       key=lambda t: (-self.weight(t), heads[t][0]))
        if self._choice is not None and self._queues.get(self._choice):
            return self._choice
        # wfq: deficit round-robin over the tenant ring. When the pointer
        # ARRIVES at a waiting tenant it receives one quantum * weight
        # top-up; it then serves requests (pointer parked, no further
        # top-up) until its deficit no longer covers its head's cost, at
        # which point the pointer moves on. Each full ring pass tops every
        # waiting tenant up once, so the loop terminates and nobody
        # starves, while long-run service tracks the weights.
        self._choice = None
        while self._choice is None:
            tenant = self._ring[self._rr % len(self._ring)]
            entry = heads.get(tenant)
            if entry is not None:
                if not self._topped:
                    self._deficit[tenant] += self.quantum * self.weight(tenant)
                    self._topped = True
                if self._deficit[tenant] >= request_cost(entry[1]):
                    self._choice = tenant
                    break
            self._rr = (self._rr + 1) % len(self._ring)
            self._topped = False
        return self._choice

    def peek(self) -> Optional[Request]:
        """The request the policy serves next (stable until popped)."""
        tenant = self._select()
        return self._queues[tenant][0][1] if tenant is not None else None

    def popleft(self) -> Request:
        """Commit the memoized head (the one ``peek``/``[0]`` showed)."""
        tenant = self._select()
        if tenant is None:
            raise IndexError("pop from an empty router")
        _, req = self._queues[tenant].popleft()
        if self.policy == "wfq":
            self._deficit[tenant] -= request_cost(req)
            if not self._queues[tenant]:
                # classic DRR: an emptied queue forfeits leftover deficit
                # (banking it would let an idle tenant burst later)
                self._deficit[tenant] = 0.0
        self._choice = None
        return req
