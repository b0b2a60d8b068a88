"""Mamba-2 (SSD, state-space duality) mixer: chunked matmul form + O(1) decode.

The port of `repro.models.ssm` (its mesh constraints are `mamba_tp`'s
split over the model positions, in training). The SSD
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
* the gated RMSNorm before ``out_proj`` (`gated_norm`: eps
  ``cfg.norm_eps`` and a float32 rsqrt) is a function of its own, so that tests can pin it to XLA's values.

Beyond the reference (`ModelConfig` fields whose defaults are its
behaviour): ``conv_bias`` adds a bias to each conv channel, and
``ssm_skip_pads`` holds a left-padded call's pads out of the state (`mamba`).
Spans ``ssm.mixer`` and ``ssm.scan`` and the counter ``ssm.pad_rows`` (the
pad steps held out, by layer) go to `repro_torch.trace`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .. import trace
from ..configs.base import ExecConfig, ModelConfig
from ..dist.tp import all_gather, all_reduce, send
from ..exec.plan import ExecPlan, as_plan
from . import layers

Params = dict

__all__ = ["init_mamba", "init_mamba_with_out", "mamba", "mamba_tp",
           "softplus", "gated_norm", "gated_norm_split"]


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
        if cfg.conv_bias:
            p[name + "_bias"] = torch.zeros((width,), device=device,
                                            dtype=dtype)
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


def gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Mamba-2's gated RMSNorm before ``out_proj``, in float32."""
    g = y.float() * F.silu(z.float())
    g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + eps)
    return g * scale.float()


def gated_norm_split(ys: list, zs: list, scales: list, d_inner: int) -> list:
    """`gated_norm` over a d_inner split in column blocks, one a model
    position (``ys``, ``zs``, ``scales``): each block's sum of squares,
    all-reduced, gives the whole row's mean."""
    gs = [y.float() * F.silu(z.float()) for y, z in zip(ys, zs)]
    sums = all_reduce([(g * g).sum(-1, keepdim=True) for g in gs])
    return [g * torch.rsqrt(t / d_inner + 1e-6) * sc.float()
            for g, t, sc in zip(gs, sums, scales)]


def _causal_conv_simple(x, w, state, bias=None):
    """Depthwise causal conv via explicit shifted sums (W is tiny).

    x (B, S, C); w (W, C); state (B, W-1, C) holds the previous steps' inputs
    (None: zeros); ``bias`` (C,) or None. Returns y and the last W-1
    inputs."""
    W = w.shape[0]
    if state is None:
        ctx = F.pad(x, (0, 0, W - 1, 0))
    else:
        ctx = torch.cat([state.to(x.dtype), x], dim=1)
    new_state = ctx[:, -(W - 1):, :] if W > 1 else None
    S = x.shape[1]
    y = sum(ctx[:, i:i + S, :] * w[i].to(x.dtype) for i in range(W))
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y, new_state


def _clip_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(x, -60.0, 0.0))


def _ssd_chunks(xh, dt, Bm, Cm, chunk: int):
    """Zero-pad to a multiple of the chunk L = min(chunk, S) (dt = 0 makes
    padded steps identity: no state update) and cut into chunks: xc
    (B,nc,L,H,P), dtc (B,nc,L,H) float32, and Bc/Cc (B,nc,L,H,N) repeated
    from the groups over the heads."""
    Bsz, S, H, Pd = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // L
    rep = H // G
    # jnp.repeat order: group g serves heads g*rep .. g*rep + rep - 1
    return (xh.reshape(Bsz, nc, L, H, Pd), dt.reshape(Bsz, nc, L, H).float(),
            Bm.reshape(Bsz, nc, L, G, N).repeat_interleave(rep, dim=3),
            Cm.reshape(Bsz, nc, L, G, N).repeat_interleave(rep, dim=3))


def _ssd_local(xc, dtc, A, Bc, Cc):
    """What each chunk computes on its own: the intra-chunk term y_intra
    (B,nc,L,H,P), the chunk's state contribution (B,nc,H,P,N), its decay
    over the whole chunk (B,nc,H) and the in-chunk cumulative decay
    (B,nc,L,H)."""
    dA = dtc * A  # (B,nc,L,H), negative
    cum = torch.cumsum(dA, dim=2)

    # --- intra-chunk (attention-like, masked by causal decay) ---
    CB = torch.einsum("bclhn,bcshn->bchls", Cc.float(), Bc.float())
    # decay[l, s] = exp(cum_l - cum_s), lower-triangular after the exp
    L = xc.shape[2]
    cl = cum.permute(0, 1, 3, 2)  # (B,nc,H,L)
    dmat = _clip_exp(cl[..., :, None] - cl[..., None, :])
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=xc.device))
    att = (CB * torch.where(mask, dmat, torch.zeros((), device=xc.device))
           * dtc.permute(0, 1, 3, 2)[..., None, :])
    y_intra = torch.einsum("bchls,bcshp->bclhp", att.to(xc.dtype).float(),
                           xc.float())

    # --- per-chunk states ---
    decay_end = _clip_exp(cum[:, :, -1:, :] - cum)  # (B,nc,L,H)
    wx = (dtc * decay_end)[..., None] * xc.float()  # (B,nc,L,H,P)
    states = torch.einsum("bclhn,bclhp->bchpn", Bc.float(), wx)
    return y_intra, states, _clip_exp(cum[:, :, -1, :]), cum


def _ssd_carry(s, states, chunk_decay):
    """The inter-chunk recurrence from the state ``s`` entering the first
    chunk: (the state entering each chunk (B,nc,H,P,N), the state after
    the last)."""
    states_in = []
    for c in range(states.shape[1]):
        states_in.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    return torch.stack(states_in, dim=1), s


def _ssd_out(y_intra, Cc, states_in, cum):
    """y (B,nc,L,H,P): the intra-chunk term plus the carried state's."""
    y_inter = (torch.einsum("bclhn,bchpn->bclhp", Cc.float(), states_in)
               * _clip_exp(cum)[..., None])
    return y_intra + y_inter


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunkwise SSD. xh (B,S,H,P); dt (B,S,H); A (H,); Bm/Cm (B,S,G,N).

    Returns y (B,S,H,P) and the final state (B,H,P,N) float32.
    """
    Bsz, S, H, Pd = xh.shape
    xc, dtc, Bc, Cc = _ssd_chunks(xh, dt, Bm, Cm, chunk)
    y_intra, states, chunk_decay, cum = _ssd_local(xc, dtc, A, Bc, Cc)
    s = (torch.zeros((Bsz, H, Pd, Bm.shape[3]), dtype=torch.float32,
                     device=xh.device)
         if init_state is None else init_state.float())
    states_in, s = _ssd_carry(s, states, chunk_decay)
    y = _ssd_out(y_intra, Cc, states_in, cum)
    return y.reshape(Bsz, -1, H, Pd)[:, :S].to(xh.dtype), s


def _pad_keep(pad_lens, S: int, device):
    """(B, S) bool: the steps of a left-padded call that are real."""
    return (torch.arange(S, device=device)[None, :]
            >= pad_lens.to(device)[:, None])


def mamba(p: Params, x: torch.Tensor, *, cfg: ModelConfig,
          plan: ExecPlan | ExecConfig,
          cache: Optional[Params] = None,
          pad_lens: Optional[torch.Tensor] = None):
    """Mamba-2 mixer. cache = {"state", "conv_x", "conv_B", "conv_C"}.

    ``pad_lens`` (B,): each row's left pads in a call of more than one
    step. With ``cfg.ssm_skip_pads`` they are no part of the sequence: their
    x, B and C are zeroed before the convolution (the first real step sees
    a fresh conv window) and their dt is 0 (the state passes them
    unchanged). Otherwise they are ignored, and the scan runs through the
    pads as the reference's does.

    Returns (out (B, S, d_model), new cache or None).
    """
    plan = as_plan(cfg, plan)
    Bsz, S, _ = x.shape
    H, Pd, N, G = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups

    with trace.span("ssm.mixer"):
        z = layers._linear(x, p["w_z"], plan)
        xs = layers._linear(x, p["w_x"], plan)
        Bv = layers._linear(x, p["w_B"], plan)
        Cv = layers._linear(x, p["w_C"], plan)
        dt_raw = layers._linear(x, p["w_dt"], plan).float()

        keep = None
        if cfg.ssm_skip_pads and pad_lens is not None and S > 1:
            keep = _pad_keep(pad_lens, S, x.device)
            k3 = keep[..., None].to(xs.dtype)
            xs, Bv, Cv = xs * k3, Bv * k3, Cv * k3
            if trace.on:
                trace.add("ssm.pad_rows",
                          (~keep).sum().to(torch.int64),
                          key=trace.current("layer"))

        def conv(t, name):
            return _causal_conv_simple(t, p[name],
                                       cache[name] if cache else None,
                                       p.get(name + "_bias"))
        xs, cs_x = conv(xs, "conv_x")
        Bv, cs_B = conv(Bv, "conv_B")
        Cv, cs_C = conv(Cv, "conv_C")
        xs, Bv, Cv = F.silu(xs), F.silu(Bv), F.silu(Cv)

        xh = xs.reshape(Bsz, S, H, Pd)
        Bm = Bv.reshape(Bsz, S, G, N)
        Cm = Cv.reshape(Bsz, S, G, N)
        dt = softplus(dt_raw + p["dt_bias"])  # (B,S,H)
        if keep is not None:
            dt = dt * keep[..., None]
        A = -torch.exp(p["A_log"])  # (H,)

        with trace.span("ssm.scan"):
            if S == 1 and cache is not None:
                # recurrent decode step
                s_prev = cache["state"].float()  # (B,H,P,N)
                dt1 = dt[:, 0]  # (B,H)
                dA1 = torch.exp(dt1 * A)
                B1 = Bm[:, 0].repeat_interleave(H // G, dim=1).float()
                C1 = Cm[:, 0].repeat_interleave(H // G, dim=1).float()
                x1 = xh[:, 0].float()  # (B,H,P)
                s_new = (s_prev * dA1[..., None, None]
                         + (dt1[..., None] * x1)[..., None]
                         * B1[:, :, None, :])
                y = torch.einsum("bhn,bhpn->bhp", C1, s_new)
                y = y[:, None].to(x.dtype)  # (B,1,H,P)
                state = s_new
            else:
                init_state = cache["state"] if cache is not None else None
                y, state = _ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk,
                                        init_state)

        y = y + xh * p["ssm_D"][:, None].to(x.dtype)
        y = y.reshape(Bsz, S, cfg.d_inner)
        y = gated_norm(y, z, p["norm_scale"], cfg.norm_eps).to(x.dtype)

        out = layers._linear(y, p["out_proj"], plan)
    new_cache = None
    if cache is not None:
        new_cache = {"state": state.to(cache["state"].dtype),
                     "conv_x": cs_x, "conv_B": cs_B, "conv_C": cs_C}
    return out, new_cache


def mamba_tp(p: Params, hs: list, *, cfg: ModelConfig, plan: ExecPlan,
             group):
    """The cache-free Mamba-2 mixer over a data replica's model positions
    (``hs``: each position's whole normed input), the reference's SSD
    partitioning (`repro.models.ssm` ``_ssd_chunked``):

    * heads (``H % model == 0``): position m projects its heads' ``w_z``/
      ``w_x``/``w_dt`` columns, convolves them, runs the SSD over its heads
      and multiplies by its ``out_proj`` rows (``"partial"`` products);
      B and C are its own ``w_B``/``w_C`` columns when the groups divide,
      else projected (column-parallel where the leaf splits, then
      gathered) and repeated over the heads, its heads taken; the gated
      norm sums its squares across the positions (`gated_norm_split`);
    * otherwise the chunk axis (``chunks`` dividing the chunk count): the
      projections whole on every position (column-parallel and gathered
      where a leaf splits), each position's chunks computed on their own,
      the state carried from position to position in order, y gathered;
      then ``out_proj`` row-parallel where it splits (``"partial"``), else
      whole (``"full"``).
    """
    b, S, _ = hs[0].shape
    H, Pd, N, G = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups
    d_in, rep = cfg.d_inner, H // G
    M = group.size
    read = group.read
    by_heads = group.split((b, S, H, Pd), ("batch", None, "heads", "headdim"),
                           2)

    def proj(name):
        """``name``'s product on every position, whole: column-parallel
        then gathered where the leaf splits."""
        w = p[name]
        if group.leaf_dim(name, w.shape) == 1:
            return all_gather([layers._linear(h, read(w, m, 1, name), plan)
                               for m, h in enumerate(hs)], -1)
        return [layers._linear(h, read(w, m, name=name), plan)
                for m, h in enumerate(hs)]

    def conv(parts, name, cols: bool):
        return [F.silu(_causal_conv_simple(
            t, read(p[name], m, 1 if cols else None), None)[0])
            for m, t in enumerate(parts)]

    if by_heads:
        cols = lambda name: [layers._linear(h, read(p[name], m, 1, name),
                                            plan) for m, h in enumerate(hs)]
        z, xs = cols("w_z"), conv(cols("w_x"), "conv_x", True)
        dt_raw = [t.float() for t in cols("w_dt")]
        hb = [group.bounds(H, m) for m in range(M)]
        Hl = H // M
        if G % M == 0:  # each position's own groups
            Bv, Cv = (conv(cols(w), c, True) for w, c in (("w_B", "conv_B"),
                                                          ("w_C", "conv_C")))
            Bm = [t.reshape(b, S, G // M, N) for t in Bv]
            Cm = [t.reshape(b, S, G // M, N) for t in Cv]
        else:  # the whole B/C, repeated over the heads, this position's
            Bm, Cm = ([t.reshape(b, S, G, N).repeat_interleave(
                rep, dim=2)[:, :, h0:h1] for t, (h0, h1) in zip(
                    conv(proj(w), c, False), hb)]
                for w, c in (("w_B", "conv_B"), ("w_C", "conv_C")))
        ys = []
        for m in range(M):
            dt = softplus(dt_raw[m] + read(p["dt_bias"], m, 0))
            A = -torch.exp(read(p["A_log"], m, 0))
            xh = xs[m].reshape(b, S, Hl, Pd)
            y, _ = _ssd_chunked(xh, dt, A, Bm[m], Cm[m], cfg.ssm_chunk)
            y = y + xh * read(p["ssm_D"], m, 0)[:, None].to(xh.dtype)
            ys.append(y.reshape(b, S, Hl * Pd))
        ys = gated_norm_split(ys, z, [read(p["norm_scale"], m, 0)
                                      for m in range(M)], d_in)
        return [layers._linear(y.to(h.dtype), read(p["out_proj"], m, 0,
                                                    "out_proj"), plan)
                for m, (y, h) in enumerate(zip(ys, hs))], "partial"

    z, xs = proj("w_z"), conv(proj("w_x"), "conv_x", False)
    Bv, Cv = conv(proj("w_B"), "conv_B", False), conv(proj("w_C"), "conv_C",
                                                      False)
    dt_raw = [t.float() for t in proj("w_dt")]
    L = min(cfg.ssm_chunk, S)
    nc = -(-S // L)
    xh, dt, A, D_, Bm, Cm = [], [], [], [], [], []
    for m in range(M):
        xh.append(xs[m].reshape(b, S, H, Pd))
        dt.append(softplus(dt_raw[m] + read(p["dt_bias"], m)))
        A.append(-torch.exp(read(p["A_log"], m)))
        D_.append(read(p["ssm_D"], m))
        Bm.append(Bv[m].reshape(b, S, G, N))
        Cm.append(Cv[m].reshape(b, S, G, N))
    if group.split((b, nc, L, H, Pd), ("batch", "chunks", None, "heads",
                                       "headdim"), 1):
        ys, s = [], None
        for m, dev in enumerate(group.devices):
            c0, c1 = group.bounds(nc, m)
            xc, dtc, Bc, Cc = (t[:, c0:c1] for t in _ssd_chunks(xh[m], dt[m], Bm[m],
                                                    Cm[m], cfg.ssm_chunk))
            y_intra, states, decay, cum = _ssd_local(xc, dtc, A[m], Bc, Cc)
            if s is None:
                s = torch.zeros(states.shape[:1] + states.shape[2:],
                                dtype=torch.float32, device=dev)
            else:  # the state entering this position's first chunk
                s = send(s, dev)
            states_in, s = _ssd_carry(s, states, decay)
            ys.append(_ssd_out(y_intra, Cc, states_in, cum).reshape(
                b, -1, H, Pd))
        y = [t[:, :S].to(x.dtype) for t, x in zip(all_gather(ys, 1), xh)]
    else:
        y = [_ssd_chunked(*a, cfg.ssm_chunk)[0]
             for a in zip(xh, dt, A, Bm, Cm)]
    ys = [gated_norm((t + x * d[:, None].to(x.dtype)).reshape(b, S, d_in), zz,
                     read(p["norm_scale"], m)).to(h.dtype)
          for m, (t, x, d, zz, h) in enumerate(zip(y, xh, D_, z, hs))]
    if group.leaf_dim("out_proj", p["out_proj"].shape) == 0:
        return [layers._linear(y[..., slice(*group.bounds(d_in, m))],
                               read(p["out_proj"], m, 0, "out_proj"), plan)
                for m, y in enumerate(ys)], "partial"
    return [layers._linear(y, read(p["out_proj"], m, name="out_proj"), plan)
            for m, y in enumerate(ys)], "full"
