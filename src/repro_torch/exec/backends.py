"""Backend registrations for the op slots of the paged serving path.

The port of `repro.exec.backends`, restricted to what
``ExecConfig.serving()`` resolves on a decoder-only all-attention model
served paged: matmul ``digital``/``raceit_int`` (resident int8 weights go
through `_resident_matmul` in both), activation ``digital``/``raceit_lut``,
attention_decode ``digital``/``raceit_fused_paged``/``raceit_gqa_paged``,
and lm_head ``digital``. Names and capability predicates are the
reference's, so both packages resolve the same plan.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import ops as acam_ops
from ..core.quant import quantize_tensor
from ..models import layers
from ..models.layers import NEG_INF, QuantizedWeight
from .registry import register

_FUSED_SOFTMAX_MODES = ("pot", "pot_fine", "uniform")


def _fused_supported(model_cfg, exec_cfg):
    if exec_cfg.noise is not None:
        return ("device-noise injection active (ExecConfig.noise); fused "
                "kernels model ideal devices — noise rides the staged "
                "raceit_noisy_* path")
    if exec_cfg.matmul_fidelity != "int":
        return (f"fidelity={exec_cfg.matmul_fidelity!r} (the kernel uses the "
                f"bit-equal integer matmul; only fidelity='int' is supported)")
    if exec_cfg.softmax_mode not in _FUSED_SOFTMAX_MODES:
        return (f"softmax_mode={exec_cfg.softmax_mode!r} not in "
                f"{_FUSED_SOFTMAX_MODES}")
    return None


def _gqa_native_supported(model_cfg, exec_cfg):
    why = _fused_supported(model_cfg, exec_cfg)
    if why is not None:
        return why
    if model_cfg.n_kv_heads >= model_cfg.n_heads:
        return (f"n_kv_heads={model_cfg.n_kv_heads} == "
                f"n_heads={model_cfg.n_heads} (no KV-head sharing to "
                f"exploit; the flat fused kernel is the same dataflow)")
    return None


# ---------------------------------------------------------------------------
# matmul (weight matmuls: QKV / FFN projections — the crossbar DPE lane)
# ---------------------------------------------------------------------------

def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) x int8 (K, N) -> int32.

    |sum| reaches 128*128*K (8.4e7 at K = 5120), past 2^24, so no float32,
    TF32 or bf16 product is exact, and torch.matmul has no integer path on
    CUDA. On the card this is ``torch._int_mm``, the int8 tensor-core GEMM
    with an int32 accumulator (it wants M > 16 and K, N multiples of 8: M is
    padded with zero rows); elsewhere, and for other widths, a float64
    product of the codes, exact below 2^53.
    """
    M, K = a.shape
    N = b.shape[1]
    if a.is_cuda and K % 8 == 0 and N % 8 == 0:
        pad = max(0, 17 - M)
        if pad:
            a = torch.cat([a, a.new_zeros((pad, K))])
        return torch._int_mm(a.contiguous(), b.contiguous())[:M]
    return (a.double() @ b.double()).to(torch.int32)


def _resident_matmul(plan, x, w: QuantizedWeight, bias):
    """Resident int8 crossbar weight: codes + per-column scale, activations
    quantized with the plan's ``act_bits``."""
    k = w.codes.shape[0]
    xq = quantize_tensor(x.float(), bits=plan.exec_cfg.act_bits)
    y32 = int_matmul(xq.codes.reshape(-1, k), w.codes)
    y = y32.float() * (xq.scale * w.scale)
    y = y.reshape(*x.shape[:-1], *w.shape).to(x.dtype)
    if bias is not None:
        y = y + bias.reshape(w.shape).to(y.dtype)
    return y


@register("matmul", "digital")
def _matmul_digital(plan, x, w, bias):
    if isinstance(w, QuantizedWeight):
        return _resident_matmul(plan, x, w, bias)
    k = w.shape[0]
    y = (x @ w.reshape(k, -1).to(x.dtype)).reshape(*x.shape[:-1], *w.shape[1:])
    if bias is not None:
        y = y + bias.reshape(w.shape[1:]).to(y.dtype)
    return y


@register("matmul", "raceit_int")
def _matmul_raceit_int(plan, x, w, bias):
    """Exact-ADC int8 crossbar matmul."""
    if isinstance(w, QuantizedWeight):
        return _resident_matmul(plan, x, w, bias)
    ec = plan.exec_cfg
    k = w.shape[0]
    w2 = w.reshape(k, -1)
    xq = quantize_tensor(x.float(), bits=ec.act_bits)
    wq = quantize_tensor(w2.float(), bits=ec.weight_bits, axis=1)
    y32 = int_matmul(xq.codes.reshape(-1, k), wq.codes)
    y = y32.float() * (xq.scale * wq.scale)
    y = y.reshape(*x.shape[:-1], *w.shape[1:]).to(x.dtype)
    if bias is not None:
        y = y + bias.reshape(w.shape[1:]).to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# activation (FFN nonlinearity)
# ---------------------------------------------------------------------------

@register("activation", "digital")
def _activation_digital(plan, x, name=None):
    name = name or plan.model_cfg.activation
    if name == "gelu":  # jax.nn.gelu's default is the tanh approximation
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


@register("activation", "raceit_lut")
def _activation_raceit_lut(plan, x, name=None):
    """Compute-ACAM LUT activation (unlisted activations map to gelu)."""
    name = name or plan.model_cfg.activation
    op = acam_ops.get_op(name if name in ("gelu", "silu") else "gelu")
    return op(x.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# attention_decode (Sq=1 decode steps and Sq=C chunked-prefill steps)
# ---------------------------------------------------------------------------
# Interface: impl(plan, q, k, v, *, kv_len, scale, pad_valid[, block_table,
#   page_size]); q (B, Sq, H, hd); k/v (B, Smax, KV, hd) contiguous rows or,
#   with block_table, the (n_pages, page_size, KV, hd) pool.

def _decode_scores(q, k, kv_heads, scale):
    """Float decode scores in grouped-query layout: (B, KV, G, Sq, Smax)."""
    qg = layers._split_gqa(q, kv_heads)  # (B, Sq, KV, G, hd)
    return torch.einsum("bqkgd,bckd->bkgqc", qg.float() * scale, k.float())


def _decode_combine(pr, v):
    o = torch.einsum("bkgqc,bckd->bkgqd", pr, v.float())
    b, kv, g, sq, hd = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, kv * g, hd)


def _decode_valid(k, kv_len, pad_valid):
    """Key-validity mask: (B, Smax), or (B, Sq, Smax) with a per-query mask."""
    valid = (torch.arange(k.shape[1], device=k.device)[None, :]
             < kv_len.reshape(-1, 1))
    if pad_valid is not None:
        valid = (valid[:, None, :] & pad_valid if pad_valid.ndim == 3
                 else valid & pad_valid)
    return valid


def _decode_mask_scores(s, valid, sentinel):
    vm = (valid[:, None, None, None] if valid.ndim == 2
          else valid[:, None, None])  # (B, Sq, Smax) -> (B, 1, 1, Sq, Smax)
    return torch.where(vm, s, torch.full((), sentinel, device=s.device))


@register("attention_decode", "digital")
def _decode_digital(plan, q, k, v, *, kv_len, scale, pad_valid=None):
    s = _decode_scores(q, k, k.shape[2], scale)
    valid = _decode_valid(k, kv_len, pad_valid)
    s = _decode_mask_scores(s, valid, NEG_INF)
    return _decode_combine(torch.softmax(s, dim=-1), v)


def _contiguous_unported(*args, **kwargs):
    raise NotImplementedError(
        "the contiguous (non-paged) fused decode is not ported yet; serve "
        "paged (block_table/page_size)")


@register("attention_decode", "raceit_fused_paged",
          supported=_fused_supported, paged=True,
          notes="block-paged KV pool (block_table/page_size) on the CUDA "
                "kernel csrc/acam_attention.cu")
def _decode_raceit_fused_paged(plan, q, k, v, *, kv_len, scale,
                               pad_valid=None, block_table=None,
                               page_size=None):
    if block_table is None:
        _contiguous_unported()
    return layers._raceit_paged_decode(q, k, v, kv_len, scale, plan,
                                       pad_valid=pad_valid,
                                       block_table=block_table, gqa=False)


@register("attention_decode", "raceit_gqa_paged",
          supported=_gqa_native_supported, paged=True,
          notes="block-paged KV pool on the GQA-native layout — the paged "
                "serving default for grouped-query configs")
def _decode_raceit_gqa_paged(plan, q, k, v, *, kv_len, scale,
                             pad_valid=None, block_table=None,
                             page_size=None):
    if block_table is None:
        _contiguous_unported()
    # chunked-prefill steps (Sq > 1) ride the flat paged entry: the GQA
    # grid's row dimension carries the rep sharing queries
    return layers._raceit_paged_decode(q, k, v, kv_len, scale, plan,
                                       pad_valid=pad_valid,
                                       block_table=block_table,
                                       gqa=q.shape[1] == 1)


# ---------------------------------------------------------------------------
# lm_head (the unembedding projection)
# ---------------------------------------------------------------------------

@register("lm_head", "digital",
          notes="resident int8 weights take the quantized path with the "
                "plan's act_bits")
def _lm_head_digital(plan, x, w):
    if isinstance(w, QuantizedWeight):  # resident int8 unembedding
        return _resident_matmul(plan, x, w, None).float()
    return torch.einsum("bsd,dv->bsv", x.float(), w.float())
