"""Backend registrations for the op slots of the serving paths.

The port of `repro.exec.backends`, restricted to what
``ExecConfig.serving()`` (fused or staged attention) and the digital
baseline resolve on stacks of global and sliding-window attention layers
(causal, bidirectional or cross attention) and Mamba-2 mixers, served
paged, from the contiguous slot pool, bucketed or solo, or run through
`Model.forward`: matmul ``digital``/``raceit_int`` (resident int8
weights go through `_resident_matmul` in both), activation ``digital``/
``raceit_lut``, softmax ``digital``/``raceit_acam``, dd_matmul ``int``/
``acam`` (the nibble tables, under ``matmul_fidelity="acam"``),
attention_prefill ``digital``/``raceit_staged``/``raceit_fused``, the
attention_decode fused family (``raceit_fused``, ``raceit_gqa_native``, the
per-row ``*_rows`` and the paged ``*_paged``, which serve contiguous
callers too), ``raceit_staged`` and ``digital``, and lm_head ``digital``/
``raceit_q8``; the ``raceit_noisy_*`` family registers itself from
`repro_torch.exec.noisy`, the tensor-parallel ``raceit_*_tp`` family from
`repro_torch.exec.sharded`. Names, notes and capability predicates are the
reference's, so both packages resolve the same plan.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import ops as acam_ops
from ..core.attention import dd_matmul_codes
from ..core.ops import LOGIT_FMT
from ..core.quant import quantize_tensor, ref_exp, ref_sum
from ..core.softmax import acam_softmax
from ..models import layers
from ..models.layers import NEG_INF, QuantizedWeight
from .registry import register

_FUSED_SOFTMAX_MODES = ("pot", "pot_fine", "uniform")

# past this key length the raceit attention formulations have always
# degraded to the chunked float path (a runtime shape rule)
RACEIT_ATTENTION_MAX_KEYS = 4096
_SEQ_NOTE = (f"falls back to the digital path beyond "
             f"Sk={RACEIT_ATTENTION_MAX_KEYS}")


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
# softmax (standalone rows: the MoE router, the staged decode scores)
# ---------------------------------------------------------------------------

@register("softmax", "digital")
def _softmax_digital(plan, logits, axis):
    """`jax.nn.softmax` as XLA's CPU graph computes it: exp(x - max) by
    XLA's exp, summed in XLA's order, then divided; the MoE router's
    gates and top-k are then the reference's bit for bit."""
    x = logits.float().movedim(axis, -1)
    e = ref_exp(x - x.amax(-1, keepdim=True))
    return (e / ref_sum(e)[..., None]).movedim(-1, axis)


@register("softmax", "raceit_acam")
def _softmax_raceit_acam(plan, logits, axis):
    return acam_softmax(logits, axis=axis, mode=plan.exec_cfg.softmax_mode)


# ---------------------------------------------------------------------------
# dd_matmul (data-dependent matmuls on int8 codes: q.K^T, probs.V)
# ---------------------------------------------------------------------------

@register("dd_matmul", "int")
def _dd_matmul_int(plan, a_codes, b_codes):
    return dd_matmul_codes(a_codes, b_codes, fidelity="int")


@register("dd_matmul", "acam",
          notes="4-bit nibble-table multiplies; bit-identical to 'int', slow")
def _dd_matmul_acam(plan, a_codes, b_codes):
    return dd_matmul_codes(a_codes, b_codes, fidelity="acam")


# ---------------------------------------------------------------------------
# attention_prefill (full / prefill attention)
# ---------------------------------------------------------------------------
# Interface: impl(plan, q, k, v, *, scale, q_offset, kind, window, chunk,
#   probs_dtype, pad_lens); q (B, Sq, H, hd); k/v (B, Sk, KV, hd); kind in
#   ("cross", "bidir", "local", "causal"); pad_lens (B,) int32 marks each row's
#   left-pad key prefix (bucketed serving), masked on top of the structural
#   mask.

def _mask_fn(kind: str, sk: int, q_offset, window: int):
    if kind == "cross":  # full cross attention: every encoder key
        return lambda qi, ki: torch.ones((), dtype=torch.bool,
                                         device=qi.device)
    if kind == "bidir":
        return lambda qi, ki: ki < sk + 0 * qi
    if kind == "local":  # causal sliding window
        return lambda qi, ki: ((ki <= qi + q_offset)
                               & (ki > qi + q_offset - window))
    if kind == "causal":
        return lambda qi, ki: ki <= qi + q_offset
    raise NotImplementedError(f"mask kind {kind!r} is not ported yet")


def _mask_array(kind, b, sq, sk, q_offset, window, pad_lens=None,
                device=None):
    msk = _mask_fn(kind, sk, q_offset, window)(
        torch.arange(sq, device=device)[:, None],
        torch.arange(sk, device=device)[None, :])
    msk = msk.expand(b, sq, sk)
    if pad_lens is not None:  # left-pad keys do not exist for their row
        msk = msk & (torch.arange(sk, device=device)[None, None, :]
                     >= pad_lens[:, None, None])
    return msk


@register("attention_prefill", "digital")
def _prefill_digital(plan, q, k, v, *, scale, q_offset, kind, window, chunk,
                     probs_dtype=None, pad_lens=None):
    if probs_dtype is None:
        probs_dtype = layers._probs_dtype(plan.model_cfg)
    sq, sk = q.shape[1], k.shape[1]
    if (kind == "local" and sq == sk and sq % window == 0 and sq > window
            and pad_lens is None):
        # sliding-window layers, single-shot prefill: q-blocked 2W-key
        # attention (the blocked form has no per-row mask, so padded
        # buckets take the chunked path below)
        return layers._local_block_attention(q, k, v, window, scale,
                                             probs_dtype)
    mask_fn = _mask_fn(kind, sk, q_offset, window)
    return layers._chunked_attention(q, k, v, mask_fn, min(chunk, sk), scale,
                                     probs_dtype, pad_lens=pad_lens)


@register("attention_prefill", "raceit_staged", notes=_SEQ_NOTE)
def _prefill_raceit_staged(plan, q, k, v, *, scale, q_offset, kind, window,
                           chunk, probs_dtype=None, pad_lens=None):
    sk = k.shape[1]
    if sk > RACEIT_ATTENTION_MAX_KEYS:
        return _prefill_digital(plan, q, k, v, scale=scale, q_offset=q_offset,
                                kind=kind, window=window, chunk=chunk,
                                probs_dtype=probs_dtype, pad_lens=pad_lens)
    mask = _mask_array(kind, q.shape[0], q.shape[1], sk, q_offset, window,
                       pad_lens, device=q.device)
    return layers._raceit_staged_attention(q, k, v, mask, scale, plan)


@register("attention_prefill", "raceit_fused", supported=_fused_supported,
          notes=_SEQ_NOTE)
def _prefill_raceit_fused(plan, q, k, v, *, scale, q_offset, kind, window,
                          chunk, probs_dtype=None, pad_lens=None):
    sk = k.shape[1]
    if sk > RACEIT_ATTENTION_MAX_KEYS:
        return _prefill_digital(plan, q, k, v, scale=scale, q_offset=q_offset,
                                kind=kind, window=window, chunk=chunk,
                                probs_dtype=probs_dtype, pad_lens=pad_lens)
    if kind == "causal" and pad_lens is None:
        # plain causal: the kernel masks from row and key indices, so no mask
        # of score shape is built (padded buckets need the per-row mask)
        return layers._raceit_fused_attention(q, k, v, None, scale, plan,
                                              causal_offset=q_offset)
    mask = _mask_array(kind, q.shape[0], q.shape[1], sk, q_offset, window,
                       pad_lens, device=q.device)
    return layers._raceit_fused_attention(q, k, v, mask, scale, plan)


# ---------------------------------------------------------------------------
# attention_decode (Sq=1 decode steps and Sq=C chunked-prefill steps)
# ---------------------------------------------------------------------------
# Interface: impl(plan, q, k, v, *, kv_len, scale, pad_valid[, block_table,
#   page_size]); q (B, Sq, H, hd); k/v (B, Smax, KV, hd) contiguous rows or,
#   with block_table, the (n_pages, page_size, KV, hd) pool; kv_len a ()
#   scalar or a (B,) vector of per-row fill levels (0 = an empty slot).

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


@register("attention_decode", "raceit_staged",
          notes="float scores + ACAM softmax (the pre-PR2 serving decode)")
def _decode_raceit_staged(plan, q, k, v, *, kv_len, scale, pad_valid=None):
    s = _decode_scores(q, k, k.shape[2], scale)
    valid = _decode_valid(k, kv_len, pad_valid)
    s = _decode_mask_scores(s, valid, LOGIT_FMT.min_value)
    pr = acam_softmax(s, axis=-1, mode=plan.exec_cfg.softmax_mode)
    return _decode_combine(pr, v)


def _flatten_row_lens(k, kv_len, pad_valid):
    """Degrade a per-row kv_len vector to the shared-max-fill contract of
    the flat backends: every row decodes to the batch max, each row's tail
    masked through the pad mask (stale entries stay inside the quantizer
    window, masked rather than absent)."""
    if kv_len.ndim == 0:
        return kv_len, pad_valid
    valid = torch.arange(k.shape[1], device=k.device)[None, :] < kv_len[:, None]
    if pad_valid is not None and pad_valid.ndim == 3:  # per-query chunk mask
        return kv_len.amax(), valid[:, None, :] & pad_valid
    return kv_len.amax(), (valid if pad_valid is None else valid & pad_valid)


@register("attention_decode", "raceit_fused", supported=_fused_supported,
          notes="per-row kv_len vectors degrade to the shared max fill")
def _decode_raceit_fused(plan, q, k, v, *, kv_len, scale, pad_valid=None):
    kv_len, pad_valid = _flatten_row_lens(k, kv_len, pad_valid)
    return layers._raceit_fused_decode(q, k, v, kv_len, scale, plan,
                                       pad_valid=pad_valid)


@register("attention_decode", "raceit_gqa_native",
          supported=_gqa_native_supported,
          notes="native (B*KV) cache layout; the rep queries sharing a KV "
                "head ride one tile — no cache-code repeat in the hot loop")
def _decode_raceit_gqa(plan, q, k, v, *, kv_len, scale, pad_valid=None):
    kv_len, pad_valid = _flatten_row_lens(k, kv_len, pad_valid)
    return layers._raceit_gqa_decode(q, k, v, kv_len, scale, plan,
                                     pad_valid=pad_valid)


@register("attention_decode", "raceit_fused_rows", supported=_fused_supported,
          notes="per-row kv_len: every batch row decodes at its own cache "
                "fill level (continuous batching); scalar kv_len callers "
                "are served unchanged")
def _decode_raceit_fused_rows(plan, q, k, v, *, kv_len, scale,
                              pad_valid=None):
    return layers._raceit_fused_decode(q, k, v, kv_len, scale, plan,
                                       pad_valid=pad_valid)


@register("attention_decode", "raceit_gqa_rows",
          supported=_gqa_native_supported,
          notes="per-row kv_len on the GQA-native cache layout — the "
                "serving default for grouped-query configs")
def _decode_raceit_gqa_rows(plan, q, k, v, *, kv_len, scale, pad_valid=None):
    return layers._raceit_gqa_decode(q, k, v, kv_len, scale, plan,
                                     pad_valid=pad_valid)


@register("attention_decode", "raceit_fused_paged",
          supported=_fused_supported, paged=True,
          notes="block-paged KV pool (block_table/page_size); contiguous "
                "callers are served on the per-row flat kernel unchanged")
def _decode_raceit_fused_paged(plan, q, k, v, *, kv_len, scale,
                               pad_valid=None, block_table=None,
                               page_size=None):
    if block_table is None:
        return layers._raceit_fused_decode(q, k, v, kv_len, scale, plan,
                                           pad_valid=pad_valid)
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
        return layers._raceit_gqa_decode(q, k, v, kv_len, scale, plan,
                                         pad_valid=pad_valid)
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


@register("lm_head", "raceit_q8",
          notes="fully-quantized lm head (beyond-paper; default stays "
                "full-precision)")
def _lm_head_raceit_q8(plan, x, w):
    if isinstance(w, QuantizedWeight):
        return _resident_matmul(plan, x, w, None).float()
    return _matmul_raceit_int(plan, x, w, None).float()


# the raceit_noisy_* and tensor-parallel raceit_*_tp families register
# themselves against the same slots from their own modules, reusing the
# helpers above; importing them here (after every helper is defined) keeps
# `_ensure_backends_loaded` the single load point
from . import noisy, sharded  # noqa: E402,F401
