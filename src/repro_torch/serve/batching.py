"""Request records shared by the schedulers.

From `repro.serve.batching` only `Request` and `RequestError` are ported
(copied as they are); the bucketed `BatchScheduler` comes with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["Request", "RequestError"]


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
