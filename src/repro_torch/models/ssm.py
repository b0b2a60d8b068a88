"""Mamba-2 (SSD, state-space duality) mixer: chunked matmul form + O(1) decode.

The port of `repro.models.ssm` without the mesh constraints. The SSD
recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t runs in
the chunkwise-parallel matmul form of arXiv:2405.21060 (an intra-chunk
"attention-like" term and an inter-chunk state recurrence) over a whole
prompt, and as the constant-memory recurrent update when one token meets a
cache (``S == 1 and cache is not None``, as in the reference: a 1-token
prompt prefilled into a cache takes the recurrent step too).

Step by step as the reference:

* the five input projections and ``out_proj`` go through the plan's matmul
  slot (resident int8 crossbar codes in raceit mode); the depthwise causal
  convolution, SiLU, softplus, exp and the scan stay plain float32, not
  through the activation (LUT) slot;
* softplus is ``jax.nn.softplus``'s formula, ``max(x, 0) + log1p(exp(-|x|))``
  (`softplus`; `torch.nn.functional.softplus` switches to x above 20);
* ``jnp.repeat`` of the B/C groups over heads is `torch.repeat_interleave`
  (group g serves heads g*rep .. g*rep + rep - 1);
* a prompt is zero-padded to a multiple of the chunk L = min(ssm_chunk, S);
  padded steps carry dt = 0, so they leave the state alone;
* every exp of a decay is taken of a difference clipped to [-60, 0], and the
  intra-chunk lower-triangular mask is applied after the exp;
* the three-operand contractions are taken pairwise, so no (b, c, l, h, p, n)
  intermediate is made (about 4.3 GB a layer at jamba's widths);
* the gated RMSNorm before ``out_proj`` (`gated_norm`: eps 1e-6 and a float32
  rsqrt) is a function of its own, so that tests can pin it to XLA's values.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ExecConfig, ModelConfig
from ..exec.plan import ExecPlan, as_plan
from . import layers

Params = dict

__all__ = ["init_mamba", "init_mamba_with_out", "mamba", "softplus",
           "gated_norm"]


def init_mamba(gen, cfg: ModelConfig, device, dtype) -> Params:
    """The mixer's parameters with the reference's distributions: dense
    projections N(0, 1/fan_in), dt log-uniform in [1e-3, 1e-1] stored as its
    inverse softplus, A_log = log(h % 15 + 1) for h = 1..H, D = 1, and conv
    taps that pass the current step through (identity at the last tap)."""
    D = cfg.d_model
    d_in, H, N, G = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    W = cfg.conv_width
    p = {
        "w_z": layers._dense_init(gen, (D, d_in), device, dtype),
        "w_x": layers._dense_init(gen, (D, d_in), device, dtype),
        "w_B": layers._dense_init(gen, (D, G * N), device, dtype),
        "w_C": layers._dense_init(gen, (D, G * N), device, dtype),
        "w_dt": layers._dense_init(gen, (D, H), device, dtype),
    }
    u = torch.rand((H,), generator=gen, device=device, dtype=torch.float32)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + u * (hi - lo))
    p["dt_bias"] = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    p["A_log"] = torch.log(
        torch.arange(1, H + 1, dtype=torch.float32, device=device) % 15 + 1.0)
    p["ssm_D"] = torch.ones((H,), device=device, dtype=torch.float32)
    for name, width in (("conv_x", d_in), ("conv_B", G * N), ("conv_C", G * N)):
        taps = torch.zeros((W, width), device=device, dtype=dtype)
        taps[-1] = 1.0
        p[name] = taps
    p["norm_scale"] = torch.ones((d_in,), device=device, dtype=dtype)
    return p


def init_mamba_with_out(gen, cfg: ModelConfig, device, dtype) -> Params:
    p = init_mamba(gen, cfg, device, dtype)
    p["out_proj"] = layers._dense_init(gen, (cfg.d_inner, cfg.d_model),
                                       device, dtype, fan_in=cfg.d_inner)
    return p


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def gated_norm(y: torch.Tensor, z: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """Mamba-2's gated RMSNorm before ``out_proj``, in float32."""
    g = y.float() * F.silu(z.float())
    g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + 1e-6)
    return g * scale.float()


def _causal_conv_simple(x, w, state):
    """Depthwise causal conv via explicit shifted sums (W is tiny).

    x (B, S, C); w (W, C); state (B, W-1, C) holds the previous steps' inputs
    (None: zeros). Returns y and the last W-1 inputs."""
    W = w.shape[0]
    if state is None:
        ctx = F.pad(x, (0, 0, W - 1, 0))
    else:
        ctx = torch.cat([state.to(x.dtype), x], dim=1)
    new_state = ctx[:, -(W - 1):, :] if W > 1 else None
    S = x.shape[1]
    y = sum(ctx[:, i:i + S, :] * w[i].to(x.dtype) for i in range(W))
    return y, new_state


def _clip_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(x, -60.0, 0.0))


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunkwise SSD. xh (B,S,H,P); dt (B,S,H); A (H,); Bm/Cm (B,S,G,N).

    Returns y (B,S,H,P) and the final state (B,H,P,N) float32.
    """
    Bsz, S, H, Pd = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(chunk, S)
    pad = (-S) % L
    if pad:  # zero-pad: dt = 0 makes padded steps identity (no state update)
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    S_pad = S + pad
    nc = S_pad // L
    rep = H // G

    xc = xh.reshape(Bsz, nc, L, H, Pd)
    dtc = dt.reshape(Bsz, nc, L, H).float()
    # jnp.repeat order: group g serves heads g*rep .. g*rep + rep - 1
    Bc = Bm.reshape(Bsz, nc, L, G, N).repeat_interleave(rep, dim=3)
    Cc = Cm.reshape(Bsz, nc, L, G, N).repeat_interleave(rep, dim=3)

    dA = dtc * A  # (B,nc,L,H), negative
    cum = torch.cumsum(dA, dim=2)

    # --- intra-chunk (attention-like, masked by causal decay) ---
    CB = torch.einsum("bclhn,bcshn->bchls", Cc.float(), Bc.float())
    # decay[l, s] = exp(cum_l - cum_s), lower-triangular after the exp
    cl = cum.permute(0, 1, 3, 2)  # (B,nc,H,L)
    dmat = _clip_exp(cl[..., :, None] - cl[..., None, :])
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=xh.device))
    att = (CB * torch.where(mask, dmat, torch.zeros((), device=xh.device))
           * dtc.permute(0, 1, 3, 2)[..., None, :])
    y_intra = torch.einsum("bchls,bcshp->bclhp", att.to(xh.dtype).float(),
                           xc.float())

    # --- per-chunk states and the inter-chunk recurrence ---
    decay_end = _clip_exp(cum[:, :, -1:, :] - cum)  # (B,nc,L,H)
    wx = (dtc * decay_end)[..., None] * xc.float()  # (B,nc,L,H,P)
    states = torch.einsum("bclhn,bclhp->bchpn", Bc.float(), wx)
    chunk_decay = _clip_exp(cum[:, :, -1, :])  # (B,nc,H)

    s = (torch.zeros((Bsz, H, Pd, N), dtype=torch.float32, device=xh.device)
         if init_state is None else init_state.float())
    states_in = []
    for c in range(nc):  # the state entering each chunk
        states_in.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    states_in = torch.stack(states_in, dim=1)  # (B,nc,H,P,N)

    y_inter = (torch.einsum("bclhn,bchpn->bclhp", Cc.float(), states_in)
               * _clip_exp(cum)[..., None])
    y = (y_intra + y_inter).reshape(Bsz, S_pad, H, Pd)[:, :S]
    return y.to(xh.dtype), s


def mamba(p: Params, x: torch.Tensor, *, cfg: ModelConfig,
          plan: ExecPlan | ExecConfig,
          cache: Optional[Params] = None):
    """Mamba-2 mixer. cache = {"state", "conv_x", "conv_B", "conv_C"}.

    Returns (out (B, S, d_model), new cache or None).
    """
    plan = as_plan(cfg, plan)
    Bsz, S, _ = x.shape
    H, Pd, N, G = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups

    z = layers._linear(x, p["w_z"], plan)
    xs = layers._linear(x, p["w_x"], plan)
    Bv = layers._linear(x, p["w_B"], plan)
    Cv = layers._linear(x, p["w_C"], plan)
    dt_raw = layers._linear(x, p["w_dt"], plan).float()

    xs, cs_x = _causal_conv_simple(xs, p["conv_x"],
                                   cache["conv_x"] if cache else None)
    Bv, cs_B = _causal_conv_simple(Bv, p["conv_B"],
                                   cache["conv_B"] if cache else None)
    Cv, cs_C = _causal_conv_simple(Cv, p["conv_C"],
                                   cache["conv_C"] if cache else None)
    xs, Bv, Cv = F.silu(xs), F.silu(Bv), F.silu(Cv)

    xh = xs.reshape(Bsz, S, H, Pd)
    Bm = Bv.reshape(Bsz, S, G, N)
    Cm = Cv.reshape(Bsz, S, G, N)
    dt = softplus(dt_raw + p["dt_bias"])  # (B,S,H)
    A = -torch.exp(p["A_log"])  # (H,)

    if S == 1 and cache is not None:
        # recurrent decode step
        s_prev = cache["state"].float()  # (B,H,P,N)
        dt1 = dt[:, 0]  # (B,H)
        dA1 = torch.exp(dt1 * A)
        B1 = Bm[:, 0].repeat_interleave(H // G, dim=1).float()  # (B,H,N)
        C1 = Cm[:, 0].repeat_interleave(H // G, dim=1).float()
        x1 = xh[:, 0].float()  # (B,H,P)
        s_new = (s_prev * dA1[..., None, None]
                 + (dt1[..., None] * x1)[..., None] * B1[:, :, None, :])
        y = torch.einsum("bhn,bhpn->bhp", C1, s_new)
        y = y[:, None].to(x.dtype)  # (B,1,H,P)
        state = s_new
    else:
        init_state = cache["state"] if cache is not None else None
        y, state = _ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk, init_state)

    y = y + xh * p["ssm_D"][:, None].to(x.dtype)
    y = y.reshape(Bsz, S, cfg.d_inner)
    y = gated_norm(y, z, p["norm_scale"]).to(x.dtype)

    out = layers._linear(y, p["out_proj"], plan)
    new_cache = None
    if cache is not None:
        new_cache = {"state": state.to(cache["state"].dtype),
                     "conv_x": cs_x, "conv_B": cs_B, "conv_C": cs_C}
    return out, new_cache
