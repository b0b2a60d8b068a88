"""IBM Granite 4.0-H's published forward pass, in plain float32 PyTorch.

The model of `granitemoehybrid` (config.json of ibm-granite/granite-4.0-h-
small): a decoder whose layers are Mamba-2 mixers or NoPE GQA attention
(``layer_types``), each followed by a MoE FFN of routed SiLU-GLU experts
beside a SiLU-GLU shared expert, with µP scalars:

* the embedding times ``embedding_multiplier``;
* each layer ``x += residual_multiplier * mixer(rmsnorm(x))``, then
  ``x += residual_multiplier * (moe(h) + shared(h))`` with ``h =
  rmsnorm(x)``;
* Mamba-2: ``in_proj`` to z, xBC and dt (here the port's five column
  blocks ``w_z``, ``w_x``, ``w_B``, ``w_C``, ``w_dt``); a depthwise causal
  conv of width ``mamba_d_conv`` with a bias over xBC, zero history, then
  SiLU; dt = softplus(dt + dt_bias); A = -exp(A_log); the SSD recurrence
  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t + D x_t; the
  gated RMSNorm rmsnorm(y * silu(z)) * scale over the whole d_inner (one
  group); ``out_proj``. `ssd_chunked` is the chunked form of the Mamba-2
  paper (arXiv:2405.21060, its "minimal SSD": segment sums over chunks of
  ``mamba_chunk_size`` and the states carried between them),
  `ssd_sequential` the recurrence step by step;
* attention: no positions (NoPE), logits q.k times ``attention_multiplier``
  (not 1/sqrt(head_dim)), causal softmax, GQA over the KV heads;
* routing: the top-k router logits, a softmax over them (equal to the
  softmax over every expert renormalized over the top k); every token's k
  experts computed (dropless);
* the final RMSNorm, the tied embedding as the head, the logits divided by
  ``logits_scaling``.

Every RMSNorm, the gated one included, takes ``norm_eps`` (published
1e-5). Departure, a setting of the port's: ``capacity_factor`` given, the
port's static expert capacity (each expert keeps the first
ceil(k T cf / E) of its (token, choice) pairs in token-major order and
drops the rest), which a test uses to hold the port to the reference where
nothing drops. Ties of the top k go to the lower expert.

One sequence, no cache, no batching. Weights are the port's layout
(``embed``, ``final_norm``, ``blocks``: ``norm1``, ``mamba`` or ``attn``,
``norm2``, ``moe``, ``shared``); ``spec`` is the benchmark's model
description (``bench/configs/<config>.json``'s ``model``). The file imports
nothing of the measured program, and turns TF32 off.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rmsnorm(x, scale, eps):
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * scale.float()


def softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _w(w):
    """A weight as a (K, N) float32 matrix (any trailing output dims
    flattened)."""
    w = w.float()
    return w.reshape(w.shape[0], -1)


def segsum(x):
    """(..., T) -> (..., T, T): out[i, j] = sum(x[j+1 .. i]) for j <= i,
    -inf above the diagonal (the minimal SSD's stable segment sum)."""
    T = x.shape[-1]
    xe = x[..., None].expand(*x.shape, T)
    low = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), -1)
    xe = xe.masked_fill(~low, 0.0)
    out = torch.cumsum(xe, dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return out.masked_fill(~keep, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int, state=None):
    """The chunked SSD. x (T, H, P), dt (T, H), A (H,), B and C (T, H, N),
    ``state`` (H, P, N) or None (zeros). Returns y (T, H, P) and the final
    state. The sequence is zero-padded to whole chunks (dt = 0 there)."""
    T, H, P = x.shape
    pad = (-T) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    n = x.shape[0] // chunk
    X = (x * dt[..., None]).reshape(n, chunk, H, P)
    Ad = (A[None] * dt).reshape(n, chunk, H).permute(2, 0, 1)  # (H, n, l)
    Bc, Cc = B.reshape(n, chunk, H, -1), C.reshape(n, chunk, H, -1)
    Acs = torch.cumsum(Ad, -1)
    L = torch.exp(segsum(Ad))                                  # (H, n, l, l)
    y_diag = torch.einsum("clhn,cshn,hcls,cshp->clhp", Cc, Bc, L, X)
    decay = torch.exp(Acs[..., -1:] - Acs)                     # (H, n, l)
    states = torch.einsum("clhn,hcl,clhp->chpn", Bc, decay, X)
    init = (torch.zeros(1, H, P, B.shape[-1], device=x.device)
            if state is None else state.float()[None])
    states = torch.cat([init, states], 0)                      # (n+1, ...)
    dchunk = torch.exp(segsum(F.pad(Acs[..., -1], (1, 0))))    # (H, n+1, n+1)
    new = torch.einsum("hzc,chpn->zhpn", dchunk, states)
    states, final = new[:-1], new[-1]
    y_off = torch.einsum("clhn,chpn,hcl->clhp", Cc, states, torch.exp(Acs))
    y = (y_diag + y_off).reshape(n * chunk, H, P)[:T]
    return y, final


def ssd_sequential(x, dt, A, B, C, state=None):
    """The same recurrence one step at a time."""
    T, H, P = x.shape
    h = (torch.zeros(H, P, B.shape[-1], device=x.device) if state is None
         else state.float().clone())
    ys = []
    for t in range(T):
        h = h * torch.exp(dt[t] * A)[:, None, None] \
            + (dt[t][:, None] * x[t])[..., None] * B[t][:, None, :]
        ys.append(torch.einsum("hpn,hn->hp", h, C[t]))
    return torch.stack(ys), h


def mamba(spec, p, h, form: str = "chunked"):
    """One Mamba-2 mixer over h (T, D)."""
    T = h.shape[0]
    H, P = spec["ssm_heads"], spec["ssm_headdim"]
    G, N = spec["ssm_groups"], spec["ssm_state"]
    z = h @ _w(p["w_z"])
    xbc = torch.cat([h @ _w(p[k]) for k in ("w_x", "w_B", "w_C")], -1)
    dt = h @ _w(p["w_dt"])
    taps = torch.cat([p[k].float() for k in ("conv_x", "conv_B", "conv_C")],
                     -1)                                       # (W, ch)
    bias = torch.cat([p[k + "_bias"].float()
                      for k in ("conv_x", "conv_B", "conv_C")])
    W = taps.shape[0]
    conv = F.conv1d(xbc.T[None], taps.T[:, None, :], bias, padding=W - 1,
                    groups=taps.shape[1])[0, :, :T].T
    xbc = F.silu(conv)
    d_in = H * P
    x = xbc[:, :d_in].reshape(T, H, P)
    rep = H // G
    B = xbc[:, d_in:d_in + G * N].reshape(T, G, N).repeat_interleave(rep, 1)
    C = xbc[:, d_in + G * N:].reshape(T, G, N).repeat_interleave(rep, 1)
    dt = softplus(dt + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    if form == "chunked":
        y, _ = ssd_chunked(x, dt, A, B, C, spec["ssm_chunk"])
    else:
        y, _ = ssd_sequential(x, dt, A, B, C)
    y = (y + x * p["ssm_D"].float()[:, None]).reshape(T, d_in)
    g = y * F.silu(z)
    g = rmsnorm(g, p["norm_scale"], spec["norm_eps"])
    return g @ _w(p["out_proj"])


def attention(spec, p, h):
    """NoPE causal GQA over h (T, D), logits times the attention
    multiplier."""
    T = h.shape[0]
    Hq, KV, hd = spec["n_heads"], spec["n_kv_heads"], spec["head_dim"]
    q = (h @ _w(p["wq"])).reshape(T, Hq, hd)
    k = (h @ _w(p["wk"])).reshape(T, KV, hd).repeat_interleave(Hq // KV, 1)
    v = (h @ _w(p["wv"])).reshape(T, KV, hd).repeat_interleave(Hq // KV, 1)
    s = torch.einsum("qhd,khd->hqk", q, k) * spec["attention_multiplier"]
    mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=h.device))
    s = s.masked_fill(~mask, float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)
    return o.reshape(T, Hq * hd) @ p["wo"].float().reshape(Hq * hd, -1)


def glu(h, w1, w3, w2):
    return (F.silu(h @ w1.float()) * (h @ w3.float())) @ w2.float()


def moe(spec, p, h, capacity_factor=None):
    """The routed experts over h (T, D): dropless, or at the port's static
    capacity when ``capacity_factor`` is given."""
    T = h.shape[0]
    E, K = spec["n_experts"], spec["top_k"]
    logits = h @ p["router"].float()
    top, expert = torch.sort(logits, dim=-1, descending=True, stable=True)
    gate = torch.softmax(top[:, :K], -1)
    expert = expert[:, :K]
    keep = torch.ones(T, K, dtype=torch.bool, device=h.device)
    if capacity_factor is not None:
        cap = max(1, int(-(-K * T * capacity_factor // E)))
        flat = expert.reshape(-1)
        seen = torch.zeros(E, dtype=torch.long, device=h.device)
        kept = torch.zeros_like(flat, dtype=torch.bool)
        for i in range(flat.numel()):
            e = int(flat[i])
            kept[i] = bool(seen[e] < cap)
            seen[e] += 1
        keep = kept.reshape(T, K)
    out = torch.zeros_like(h)
    for e in range(E):
        tok, slot = torch.nonzero((expert == e) & keep, as_tuple=True)
        if tok.numel():
            y = glu(h[tok], p["w1"][e], p["w3"][e], p["w2"][e])
            out.index_add_(0, tok, y * gate[tok, slot][:, None])
    return out


@torch.no_grad()
def forward(spec, params, tokens, form: str = "chunked",
            capacity_factor=None):
    """Logits (T, V) of one sequence of token ids (T,)."""
    _no_tf32()
    r, eps = spec["residual_multiplier"], spec["norm_eps"]
    x = params["embed"]["tok_emb"][tokens.long()].float() \
        * spec["embedding_multiplier"]
    pattern = spec["mixer_pattern"]
    for i, lp in enumerate(params["blocks"]):
        h = rmsnorm(x, lp["norm1"]["scale"], eps)
        if pattern[i % len(pattern)] == "mamba":
            m = mamba(spec, lp["mamba"], h, form)
        else:
            m = attention(spec, lp["attn"], h)
        x = x + r * m
        h = rmsnorm(x, lp["norm2"]["scale"], eps)
        y = moe(spec, lp["moe"], h, capacity_factor)
        if "shared" in lp:
            s = lp["shared"]
            y = y + glu(h, s["w1"], s["w3"], s["w2"])
        x = x + r * y
    x = rmsnorm(x, params["final_norm"]["scale"], eps)
    return (x @ params["embed"]["tok_emb"].float().T) \
        / spec["logits_scaling"]
