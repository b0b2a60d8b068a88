"""The ``raceit_noisy_*`` backend family: device variation behind the plan.

The port of `repro.exec.noisy`. Every backend here is its clean
``raceit_*`` counterpart evaluated on *varied* devices, with the variation
drawn from the frozen `repro_torch.hw.noise.NoiseConfig` riding on
``ExecConfig.noise``:

  slot              backend               injection sites
  ----------------  --------------------  ---------------------------------
  matmul            raceit_noisy_int      stored weight codes (conductance
                                          spread + stuck cells, ISAAC
                                          unsigned domain)
  activation        raceit_noisy_lut      ACAM LUT in/out codes (threshold
                                          jitter + readout noise)
  softmax           raceit_noisy_acam     the three ACAM stages of the
                                          Fig. 8 dataflow
  attention_prefill raceit_noisy_staged   q/k/v/prob codes + ACAM softmax,
                                          optional per-row faults
  attention_decode  raceit_noisy_staged   decode softmax + per-row faults

Every site keys its draws by ``site_key(noise, tag, shape)`` and draws
JAX's numbers (`repro_torch.hw.prng`), so a (seed, NoiseConfig) pair
injects the reference's codes, on the card as on the CPU: the draws are
made on the host at their first use and cached with their device copies
(`repro_torch.hw.noise`), the port's counterpart of the reference's
constant-folded fault map. With all knobs at zero every helper is a no-op,
so a ``NoiseConfig()`` plan is bit-identical to the clean backends. The
fused kernels model ideal devices; under a NoiseConfig they degrade here,
with the reason recorded on the plan, and no kernel launches: the
reference computes this path in ``jnp``, the port in plain PyTorch.

``fault_rate`` (zero in every preset) NaNs out whole batch rows in the
noisy attention backends, which the fail-safe serving path
(`repro_torch.serve.continuous`) detects and retires per slot.
"""
from __future__ import annotations

import torch

from ..core import ops as acam_ops
from ..core.ops import LOGIT_FMT
from ..core.quant import quantize_tensor, scale_product
from ..core.softmax import noisy_acam_softmax
from ..hw.noise import (fault_rows, jitter_codes, perturb_weight_codes,
                        site_key)
from ..models.layers import QuantizedWeight, _attn_quantize
from .backends import (RACEIT_ATTENTION_MAX_KEYS, _SEQ_NOTE, _decode_combine,
                       _decode_mask_scores, _decode_scores, _decode_valid,
                       _mask_array, _prefill_digital, _resident_matmul,
                       int_matmul)
from .registry import register

# int8 code-domain clip bounds for jittered operand codes (symmetric
# max-abs quantization emits [-127, 127]; the clip only has to contain it)
_I8_LO, _I8_HI = -128, 127


def _noise_supported(model_cfg, exec_cfg):
    if exec_cfg.noise is None:
        return ("no NoiseConfig on ExecConfig.noise (ideal devices) — the "
                "clean raceit_* backends are the same numerics without the "
                "injection plumbing")
    return None


# ---------------------------------------------------------------------------
# matmul — crossbar DPE lane on a device-varied array
# ---------------------------------------------------------------------------

@register("matmul", "raceit_noisy_int", supported=_noise_supported,
          notes="raceit_int on perturbed stored weights (conductance "
                "spread + stuck cells); bit-identical at zero noise")
def _matmul_noisy_int(plan, x, w, bias):
    nz = plan.exec_cfg.noise
    ec = plan.exec_cfg
    if isinstance(w, QuantizedWeight):
        # resident int8 crossbar weight: the codes ARE the programmed
        # conductances — perturb them, keep the calibration scale
        codes = perturb_weight_codes(
            w.codes, nz, site_key(nz, "matmul_resident", tuple(w.codes.shape)),
            bits=8)
        return _resident_matmul(plan, x, QuantizedWeight(codes, w.scale,
                                                         w.shape), bias)
    k = w.shape[0]
    w2 = w.reshape(k, -1)
    xq = quantize_tensor(x.float(), bits=ec.act_bits)
    wq = quantize_tensor(w2.float(), bits=ec.weight_bits, axis=1)
    codes = perturb_weight_codes(wq.codes, nz,
                                 site_key(nz, "matmul_w", tuple(w2.shape)),
                                 bits=ec.weight_bits)
    y32 = int_matmul(xq.codes.reshape(-1, k), codes)
    y = y32.float() * (xq.scale * wq.scale)
    y = y.reshape(*x.shape[:-1], *w.shape[1:]).to(x.dtype)
    if bias is not None:
        y = y + bias.reshape(w.shape[1:]).to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# activation — Compute-ACAM LUT under threshold/readout noise
# ---------------------------------------------------------------------------

@register("activation", "raceit_noisy_lut", supported=_noise_supported,
          notes="raceit_lut through AcamFunction.apply_codes_noisy")
def _activation_noisy_lut(plan, x, name=None):
    nz = plan.exec_cfg.noise
    name = name or plan.model_cfg.activation
    op = acam_ops.get_op(name if name in ("gelu", "silu") else "gelu")
    xf = x.float()
    out = op.apply_codes_noisy(
        op.in_fmt.encode(xf),
        site_key(nz, f"activation_{op.name}", tuple(xf.shape)),
        nz.acam_sigma, nz.readout_sigma)
    return op.out_fmt.decode(out).to(x.dtype)


# ---------------------------------------------------------------------------
# softmax — Fig. 8 dataflow with noisy ACAM stages
# ---------------------------------------------------------------------------

@register("softmax", "raceit_noisy_acam", supported=_noise_supported,
          notes="raceit_acam with the three ACAM stages under variation "
                "(the CMOS adder lanes stay exact)")
def _softmax_noisy_acam(plan, logits, axis):
    nz = plan.exec_cfg.noise
    return noisy_acam_softmax(logits, axis=axis,
                              mode=plan.exec_cfg.softmax_mode, noise=nz,
                              key=site_key(nz, "softmax",
                                           tuple(logits.shape)))


# ---------------------------------------------------------------------------
# attention — staged Fig. 12 pipeline on varied devices (+ row faults)
# ---------------------------------------------------------------------------

def _jitter_i8(codes, sig, nz, tag):
    return jitter_codes(codes, sig, site_key(nz, tag, tuple(codes.shape)),
                        _I8_LO, _I8_HI)


def _noisy_staged_attention(q, k, v, mask, scale, plan):
    """`layers._raceit_staged_attention` with ACAM threshold jitter on the
    quantized operand codes and the noisy Fig. 8 softmax. Stage-for-stage
    identical at zero sigma (every injection helper early-returns)."""
    nz = plan.exec_cfg.noise
    sig = nz.acam_sigma
    qq, kq, vq = _attn_quantize(q, k, v, scale)
    qc = _jitter_i8(qq.codes, sig, nz, "attn_q")
    kc = _jitter_i8(kq.codes, sig, nz, "attn_k")
    vc = _jitter_i8(vq.codes, sig, nz, "attn_v")
    s32 = plan.dd_matmul(qc.permute(0, 2, 1, 3),              # (B,H,Sq,hd)
                         kc.permute(0, 2, 3, 1))              # (B,H,hd,Sk)
    logits = s32.float() * scale_product(qq, kq)
    logits = torch.where(mask[:, None], logits,
                         torch.full((), LOGIT_FMT.min_value,
                                    device=logits.device))
    probs = noisy_acam_softmax(logits, axis=-1,
                               mode=plan.exec_cfg.softmax_mode, noise=nz,
                               key=site_key(nz, "attn_softmax",
                                            tuple(logits.shape)))
    pq = quantize_tensor(probs, bits=8)
    pc = _jitter_i8(pq.codes, sig, nz, "attn_p")
    o32 = plan.dd_matmul(pc,                                  # (B,H,Sq,Sk)
                         vc.permute(0, 2, 1, 3))              # (B,H,Sk,hd)
    out = o32.float() * scale_product(pq, vq)
    return out.permute(0, 2, 1, 3)                            # (B,Sq,H,hd)


def _inject_row_faults(out, nz, tag):
    # per-row catastrophic faults: NaN the whole row. The site key hangs
    # off (seed, tag, batch) alone, so a caller can recompute the exact
    # fault map from the slot count without model dims.
    b = out.shape[0]
    rows = fault_rows(nz, site_key(nz, tag, (b,)), b, device=out.device)
    if rows is None:
        return out
    return torch.where(rows[:, None, None, None],
                       torch.full((), float("nan"), device=out.device), out)


@register("attention_prefill", "raceit_noisy_staged",
          supported=_noise_supported, notes=_SEQ_NOTE)
def _prefill_noisy_staged(plan, q, k, v, *, scale, q_offset, kind, window,
                          chunk, probs_dtype=None, pad_lens=None):
    nz = plan.exec_cfg.noise
    sk = k.shape[1]
    if sk > RACEIT_ATTENTION_MAX_KEYS:  # the digital path injects nothing
        return _prefill_digital(plan, q, k, v, scale=scale, q_offset=q_offset,
                                kind=kind, window=window, chunk=chunk,
                                probs_dtype=probs_dtype, pad_lens=pad_lens)
    mask = _mask_array(kind, q.shape[0], q.shape[1], sk, q_offset, window,
                       pad_lens, device=q.device)
    out = _noisy_staged_attention(q, k, v, mask, scale, plan)
    return _inject_row_faults(out, nz, "prefill_fault")


@register("attention_decode", "raceit_noisy_staged",
          supported=_noise_supported,
          notes="float scores + noisy ACAM softmax; fully row-independent, "
                "so injected faults stay bitwise-confined to their row")
def _decode_noisy_staged(plan, q, k, v, *, kv_len, scale, pad_valid=None):
    nz = plan.exec_cfg.noise
    s = _decode_scores(q, k, k.shape[2], scale)
    valid = _decode_valid(k, kv_len, pad_valid)
    s = _decode_mask_scores(s, valid, LOGIT_FMT.min_value)
    pr = noisy_acam_softmax(s, axis=-1, mode=plan.exec_cfg.softmax_mode,
                            noise=nz, key=site_key(nz, "decode_softmax",
                                                   tuple(s.shape)))
    out = _decode_combine(pr, v)
    return _inject_row_faults(out, nz, "decode_fault")
