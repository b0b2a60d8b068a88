"""The hardware layer: device noise and the analog cost model (the port of
`repro.hw`, numpy and torch only)."""
from . import area, gce, noise, params, simulator  # noqa: F401
from .noise import NoiseConfig  # noqa: F401
