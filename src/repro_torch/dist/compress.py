"""Gradient compression with error feedback (EF-SGD style).

The port of `repro.dist.compress`. `ef_compress_update` compresses a
gradient tree after folding in the residual of the previous step and
returns the new residual, so the time-averaged compressed gradient is
unbiased: the error-feedback guarantee behind int8 and sign gradient
compressors. int8 codes are ``round(g / scale)`` (a true division, half to
even) clipped to [-127, 127], ``scale = max(max|g|, 1e-12) / 127``.

Not wired into the train step, as in the reference: it would sit in a
data-parallel gradient exchange, which neither package has yet.
"""
from __future__ import annotations

import torch

from .. import tree

__all__ = ["ef_compress_update"]


def _compress_leaf(g: torch.Tensor, method: str):
    """(compressed payload, restored float tensor)."""
    if method == "none":
        return g, g
    if method == "int8":
        scale = torch.clamp_min(g.abs().amax(), 1e-12) / 127.0
        codes = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return (codes, scale), codes.float() * scale
    if method == "sign":
        scale = g.abs().mean()
        codes = torch.sign(g).to(torch.int8)
        return (codes, scale), codes.float() * scale
    raise ValueError(f"unknown compression method: {method}")


def ef_compress_update(grads, residual, method: str = "int8"):
    """(grads + residual) -> (compressed, restored, new_residual) trees; a
    residual of None is zeros."""
    if residual is None:
        residual = tree.map(torch.zeros_like, grads)
    g_eff = tree.map(lambda g, r: g + r, grads, residual)
    out = [_compress_leaf(g, method) for g in tree.leaves(g_eff)]
    compressed = tree.unflatten(g_eff, [c for c, _ in out])
    restored = tree.unflatten(g_eff, [r for _, r in out])
    new_residual = tree.map(lambda g, r: g - r, g_eff, restored)
    return compressed, restored, new_residual
