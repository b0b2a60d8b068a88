"""RACE-IT attention numerics: the five-stage MHA pipeline (paper Fig. 12).

The port of `repro.core.attention`:

mvm       Q = X W_q on the crossbar DPE lane           (crossbar.py)
matmul-1  r = q . K^T on int8 codes                     (dd_matmul_codes)
div-add   r / sqrt(d_k) + mask on the adder lane        (scale folding)
softmax   Compute-ACAM dataflow                         (softmax.py)
matmul-2  out = s . V on int8 codes

The staged `raceit_attention` is the bit-accurate oracle the fused kernels
answer to. ``fidelity="int"`` multiplies the codes as integers (float64
products, exact); ``fidelity="acam"`` routes every scalar product through
the compiled 4-bit nibble tables (slow, and equal to "int").
"""
from __future__ import annotations

import numpy as np
import torch

from .ops import LOGIT_FMT, mult8_codes
from .quant import quantize_tensor, scale_product
from .softmax import acam_softmax

__all__ = ["raceit_attention", "dd_matmul_codes", "fused_attention_supported"]

# softmax configs the fused kernels cover (every mode the staged
# acam_softmax accepts); kept equal to kernels.acam_attention's
# FUSED_SOFTMAX_MODES (duplicated so this module never imports the kernels
# at load time)
_FUSED_SOFTMAX_MODES = ("pot", "pot_fine", "uniform")


def fused_attention_supported(fidelity: str = "int", softmax_mode: str = "pot",
                              hw: bool = False) -> str | None:
    """None if the fused kernel covers this config, else a reason string.

    Supported: ``fidelity="int"``, ``hw=False``, every softmax mode of the
    staged path. ``hw=True`` (per-cell match-line emulation) and
    ``fidelity="acam"`` (the nibble-table matmul) have no kernel path.
    """
    if hw:
        return "hw=True (per-cell ACAM emulation has no kernel path)"
    if fidelity != "int":
        return (f"fidelity={fidelity!r} (the kernel uses the bit-equal "
                f"integer matmul; only fidelity='int' is supported)")
    if softmax_mode not in _FUSED_SOFTMAX_MODES:
        return (f"softmax_mode={softmax_mode!r} not in "
                f"{_FUSED_SOFTMAX_MODES}")
    return None


def dd_matmul_codes(a_codes: torch.Tensor, b_codes: torch.Tensor,
                    fidelity: str = "int") -> torch.Tensor:
    """Data-dependent matmul on int8 codes: (..., M, K) x (..., K, N) -> int32.

    fidelity="acam": each scalar product goes through the four compiled 4-bit
    Compute-ACAM nibble tables + three adds (paper §IV-B), summed in int32.
    fidelity="int": plain integer dot products, here as float64 products of
    the codes (exact below 2^53 on any device; bit-identical).
    """
    if fidelity == "acam":
        prod = mult8_codes(a_codes[..., :, :, None], b_codes[..., None, :, :])
        return prod.sum(dim=-2, dtype=torch.int32)
    return torch.matmul(a_codes.double(), b_codes.double()).to(torch.int32)


def raceit_attention(
    q: torch.Tensor,  # (B, H, Sq, D) float
    k: torch.Tensor,  # (B, H, Sk, D) float
    v: torch.Tensor,  # (B, H, Sk, D) float
    mask: torch.Tensor | None = None,  # broadcastable to (B, H, Sq, Sk), bool
    fidelity: str = "int",
    softmax_mode: str = "pot",
    hw: bool = False,
    fused: bool = False,
) -> torch.Tensor:
    """Bit-accurate RACE-IT attention (float in/out, int8 internal).

    ``fused=True`` takes the fused kernel (`repro_torch.kernels.ops.
    raceit_attention_fused`), which the staged path here is the oracle of;
    an unsupported combination raises, as in the reference.
    """
    d = q.shape[-1]
    if fused:
        reason = fused_attention_supported(fidelity, softmax_mode, hw)
        if reason:
            raise ValueError(f"fused attention unsupported: {reason}")
        from ..kernels.ops import raceit_attention_fused  # lazy: no cycle
        return raceit_attention_fused(q, k, v, mask=mask,
                                      softmax_mode=softmax_mode)
    qq = quantize_tensor(q, bits=8)
    kq = quantize_tensor(k, bits=8)
    vq = quantize_tensor(v, bits=8)

    # matmul-1: r = q . K^T on the GCE multiplier lane
    r = dd_matmul_codes(qq.codes, kq.codes.transpose(-1, -2), fidelity)
    # div-add: scale by s_q s_k / sqrt(d) and apply the mask additively; the
    # jitted division by the constant sqrt(d) is a reciprocal multiply
    inv_sqrt_d = float(np.float32(1) / np.sqrt(np.float32(d)))
    logits = r.float() * scale_product(qq, kq) * inv_sqrt_d
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.full((), LOGIT_FMT.min_value,
                                        device=logits.device))
    # softmax: the Fig. 8 dataflow (integer, table-driven)
    probs = acam_softmax(logits, axis=-1, mode=softmax_mode, hw=hw)
    # matmul-2: out = s . V, probs re-enter the multiplier lane as 8-bit codes
    pq = quantize_tensor(probs, bits=8)
    out = dd_matmul_codes(pq.codes, vq.codes, fidelity)
    return out.float() * scale_product(pq, vq)
