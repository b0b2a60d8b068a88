"""Training data of the port (port of repro.data)."""
from .synthetic import SyntheticLM  # noqa: F401
