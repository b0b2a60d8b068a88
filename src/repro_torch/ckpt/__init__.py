"""Weights across from the reference package (port of repro.ckpt's format)."""
from .reference import load_reference_checkpoint, params_from_numpy  # noqa: F401
