"""The Compute-ACAM Softmax dataflow (paper Figure 8 and §IV-C).

The port of `repro.core.softmax`. softmax(x)_i = exp(x_i) / sum_j exp(x_j),
computed without divider hardware via a/b = exp(log a - log b):

  1. e_i = EXP(x_i)         8-bit 1-var Compute-ACAM, PoT-quantized output
  2. S   = sum_i e_i        CMOS adder lane
  3. L   = LOG(S)           8-bit 1-var Compute-ACAM (log(0) := min code)
  4. d_i = x_i - L          CMOS adder lane (subtract)
  5. p_i = EXP(d_i)         8-bit 1-var Compute-ACAM, uniform [0,1) output

``mode="pot"`` is the paper's configuration, ``"pot_fine"`` quarter-octave
PoT steps, ``"uniform"`` the Fig. 14 ablation (step 1 quantized uniformly).
Every float32 step follows the reference's jitted graph: the PoT decode of
step 1 is XLA's runtime exp (`PoTFormat.decode` on a tensor), the sum of
step 2 its reduction order (`ref_sum`), the PoT encode of step 3 its log
with fused multiply-adds. ``hw=True`` evaluates the three tables by their
match lines (`repro_torch.core.acam.RangeArrays`), equal to the gathers.
`noisy_acam_softmax` runs the same dataflow on varied ACAM devices.
"""
from __future__ import annotations

import torch

from . import ops
from .ops import LOG_OUT_FMT, LOGIT_FMT
from .quant import ref_sum

__all__ = ["acam_softmax", "noisy_acam_softmax", "softmax_reference"]

_EXP_OPS = {"pot": "exp_pot", "pot_fine": "exp_pot_fine",
            "uniform": "exp_uniform"}


def softmax_reference(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.softmax(x, dim=axis)


def acam_softmax(x: torch.Tensor, axis: int = -1, mode: str = "pot",
                 hw: bool = False) -> torch.Tensor:
    """Softmax over float logits with full ACAM integer semantics.

    x is first quantized into the div-add stage's LOGIT format (1-4-3);
    masked positions should already be at LOGIT_FMT.min_value.
    """
    exp_op = ops.get_op(_EXP_OPS[mode])
    log_op = ops.get_op("log_fine" if mode == "pot_fine" else "log")
    final_op = ops.get_op("exp_prob")

    x = x.float().movedim(axis, -1)
    xc = LOGIT_FMT.encode(x)  # step 0: output of the div-add stage
    e_codes = exp_op.apply_codes(xc, hw=hw)  # step 1
    e_vals = exp_op.out_fmt.decode(e_codes)
    S = ref_sum(e_vals)[..., None]  # step 2 (adder lane)
    s_codes = log_op.in_fmt.encode(S)  # PoT re-quantization of the sum
    L = log_op.apply_codes(s_codes, hw=hw)  # step 3, LOG_OUT (1-5-2) codes
    # step 4: subtract in a common fixed-point grid (LOGIT has 3 frac bits,
    # LOG_OUT 2), saturated to the exp table's domain
    d = xc - (L << (LOGIT_FMT.frac_bits - LOG_OUT_FMT.frac_bits))
    d = torch.clamp(d, LOGIT_FMT.code_min, LOGIT_FMT.code_max)
    p = final_op.apply_codes(d, hw=hw)  # step 5
    return final_op.out_fmt.decode(p).movedim(-1, axis)


def noisy_acam_softmax(x: torch.Tensor, axis: int = -1, mode: str = "pot",
                       noise=None, key=None) -> torch.Tensor:
    """`acam_softmax` under ACAM device variation: the three ACAM stages
    (EXP, LOG, final EXP) through `AcamFunction.apply_codes_noisy` with
    ``noise.acam_sigma`` of threshold jitter and ``noise.readout_sigma`` of
    readout noise each; the adder lanes of steps 2 and 4 stay exact.
    ``noise`` is a `repro_torch.hw.noise.NoiseConfig`, ``key`` the site's
    key, split in three. Each stage draws over the operand in its own
    layout (the row sum alone moves ``axis`` last, for XLA's order).
    Delegates to the clean `acam_softmax` when both sigmas are zero.
    """
    if noise is None or (noise.acam_sigma <= 0.0
                         and noise.readout_sigma <= 0.0):
        return acam_softmax(x, axis=axis, mode=mode)
    from ..hw import prng
    exp_op = ops.get_op(_EXP_OPS[mode])
    log_op = ops.get_op("log_fine" if mode == "pot_fine" else "log")
    final_op = ops.get_op("exp_prob")
    k1, k2, k3 = prng.split(key, 3)
    sig_in, sig_out = noise.acam_sigma, noise.readout_sigma

    xc = LOGIT_FMT.encode(x.float())
    e_codes = exp_op.apply_codes_noisy(xc, k1, sig_in, sig_out)
    e_vals = exp_op.out_fmt.decode(e_codes)
    S = ref_sum(e_vals.movedim(axis, -1))[..., None].movedim(-1, axis)
    s_codes = log_op.in_fmt.encode(S)
    L = log_op.apply_codes_noisy(s_codes, k2, sig_in, sig_out)
    d = xc - (L << (LOGIT_FMT.frac_bits - LOG_OUT_FMT.frac_bits))
    d = torch.clamp(d, LOGIT_FMT.code_min, LOGIT_FMT.code_max)
    p = final_op.apply_codes_noisy(d, k3, sig_in, sig_out)
    return final_op.out_fmt.decode(p)
