"""The model stack (port of repro.models): layers, the layer loop, the LM."""
from .model import Model, quantize_model_params  # noqa: F401
