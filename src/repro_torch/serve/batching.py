"""Request batching for the serving engine, and the request records.

The port of `repro.serve.batching`. Bucketed static batching: requests wait
in a queue; `BatchScheduler.run_once` pops up to ``bucket_size`` of them,
left-pads their prompts to the bucket's longest prompt, and prefills and
decodes the whole bucket together through `GenerationEngine.generate`. The
per-row pad lengths ride along, so pad columns are masked out of every
attention step and real tokens keep their solo positions: under greedy
decoding a request's tokens do not depend on its bucket-mates, up to the
reference's documented softening (raceit modes quantize whole activation
tensors, so int8 scales couple the rows of a bucket). Each request's result
is cut to its own ``n_new``; the bucket decodes to the longest request.
`Request` and `RequestError` are shared with the continuous batcher.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

__all__ = ["Request", "RequestError", "BatchScheduler"]


@dataclasses.dataclass(frozen=True)
class RequestError:
    """Structured per-request failure record (fail-safe serving).

    Attached to ``Request.error`` when the serving path retires a request
    without a result — e.g. the continuous batcher detecting non-finite
    logits on a device-faulted slot (`repro_torch.serve.continuous`). ``stage``
    names where it died: "prefill" (admission prefill), "decode" (a decode
    step; ``step`` is the number of tokens already generated), or "admit"
    (never ran — every slot was quarantined).
    """

    rid: int
    stage: str   # "prefill" | "decode" | "admit"
    step: int    # tokens generated before the failure
    reason: str


@dataclasses.dataclass
class Request:
    """One generation request.

    ``tenant`` names the traffic class the admission router
    (`repro_torch.serve.router.AdmissionRouter`) schedules by — weights,
    priorities and queue-depth caps are all keyed on it. The default
    tenant makes single-tenant callers (and every pre-router test)
    tenant-blind.
    """

    rid: int
    prompt: np.ndarray  # (P,) int32
    n_new: int
    tenant: str = "default"
    result: Optional[np.ndarray] = None
    error: Optional[RequestError] = None


class BatchScheduler:
    def __init__(self, engine, bucket_size: int = 4, pad_id: int = 0):
        self.engine = engine
        self.bucket = bucket_size
        self.pad_id = pad_id
        self.queue: deque[Request] = deque()
        self.done: dict[int, Request] = {}
        # occupancy accounting, comparable to ContinuousBatcher's: a bucket
        # runs (max n_new - 1) decode steps and keeps (n_new_r - 1)
        # post-prefill tokens per request
        self.model_calls = 0   # prefill + decode executions
        self.tokens_out = 0    # all kept tokens (incl. prefill's first)
        self.decode_steps = 0
        self.decode_tokens = 0

    def submit(self, req: Request):
        self.queue.append(req)

    def run_once(self) -> list[int]:
        """Serve one bucket to completion; returns completed request ids."""
        if not self.queue:
            return []
        batch = [self.queue.popleft()
                 for _ in range(min(self.bucket, len(self.queue)))]
        # right-align prompts to a common length; the pad prefix lengths go
        # to the engine so pads are masked and positions stay per-request
        plen = max(len(r.prompt) for r in batch)
        n_new = max(r.n_new for r in batch)
        prompts = np.full((len(batch), plen), self.pad_id, np.int32)
        pad_lens = np.zeros(len(batch), np.int32)
        for i, r in enumerate(batch):
            prompts[i, plen - len(r.prompt):] = r.prompt  # left-pad
            pad_lens[i] = plen - len(r.prompt)
        out = self.engine.generate(
            prompts, n_new, pad_lens=pad_lens if pad_lens.any() else None)
        self.model_calls += n_new  # 1 prefill + (n_new - 1) decode steps
        self.decode_steps += n_new - 1
        finished = []
        for i, r in enumerate(batch):
            r.result = out[i, : r.n_new]
            self.tokens_out += r.n_new
            self.decode_tokens += r.n_new - 1
            self.done[r.rid] = r
            finished.append(r.rid)
        return finished

    def run_all(self) -> dict[int, Request]:
        while self.queue:
            self.run_once()
        return self.done
