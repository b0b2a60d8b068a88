"""Serving (port of repro.serve): the engine and the paged continuous batcher."""
from .batching import Request, RequestError  # noqa: F401
from .continuous import ContinuousBatcher  # noqa: F401
from .engine import GenerationEngine  # noqa: F401
from .metrics import Histogram, ServeMetrics, jain  # noqa: F401
from .prefix import PrefixCache, page_digest  # noqa: F401
from .router import AdmissionRouter  # noqa: F401
