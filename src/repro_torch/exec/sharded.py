"""The ``raceit_*_tp`` backend family: tensor-parallel fused attention.

The port of `repro.exec.sharded`. The backends register against the
attention slots with the reference's *structural* capability predicates
(they read the declarative `repro_torch.dist.MeshSpec` on
``ExecConfig.mesh``, never the devices), so plans resolve anywhere, and
running a resolved TP plan builds the concrete mesh through
``MeshSpec.build`` (the engine's device kind; a mesh built earlier onto an
explicit device list is reused).

Sharding layout (the mesh ``"model"`` axis, ``ms`` shards):

  q heads     H  -> H/ms  contiguous chunks (q is kv-major: heads
                          ``[kvh*rep, (kvh+1)*rep)`` share KV head ``kvh``,
                          so a chunk boundary lands on a KV-group boundary
                          whenever ``KV % ms == 0``, the predicate's rule)
  KV cache    KV -> KV/ms on the head axis of the contiguous buffer
                          (B, Smax, KV, hd) and of the paged pool
                          (n_pages, page_size, KV, hd); block tables,
                          kv_len vectors and pad masks are replicated
  output      H  -> H/ms  (the head axis again), concatenated on the
                          engine's device

One process drives every shard, as the reference's `shard_map` does; its
body, with a ``pmax`` in the middle, becomes stages over the list of
shards (`repro_torch.kernels.ops`' ``tp_*`` helpers):

1. each shard's local max |x| (masked where the reference masks it), the
   global max of those, and every shard quantizing with that one scale,
   so scales and codes are the single-device quantizers' bit for bit;
2. the probe -> global max -> exact flow for the kernel's call-wide PROB
   re-quantization max (`tp_exact_call`): each shard's probe call (floor
   0) gives its local cmax, their max becomes the floor of every shard's
   exact call, so each re-quantizes PROB with the single-device table.

The epilogue is the single-device chain's (`prob_descale`), so the
concatenated output equals the single-device backend's bit for bit. A
shard's slice of q, k, v and the cache is a view where its device is the
operand's. The probe doubles each shard's kernel work, and the shards
hold 1/ms of the heads each: 2/ms of the single-device work in all.
"""
from __future__ import annotations

import torch

from ..core.quant import scale_product
from ..kernels import ops as kops
from .backends import (RACEIT_ATTENTION_MAX_KEYS, _fused_supported,
                       _mask_array, _prefill_digital)
from .registry import register

AXIS = "model"  # the mesh axis every TP backend shards over


def _tp_supported(model_cfg, exec_cfg):
    ms = getattr(exec_cfg.mesh, "model_size", 1)
    if ms <= 1:
        return ("no tensor-parallel mesh (ExecConfig.mesh has no 'model' "
                "axis of size > 1)")
    why = _fused_supported(model_cfg, exec_cfg)
    if why is not None:
        return why
    if model_cfg.n_kv_heads % ms:
        return (f"n_kv_heads={model_cfg.n_kv_heads} not divisible by the "
                f"mesh 'model' axis ({ms} shards) — KV-head chunks would "
                f"straddle shards")
    return None


def _gqa_tp_supported(model_cfg, exec_cfg):
    why = _tp_supported(model_cfg, exec_cfg)
    if why is not None:
        return why
    if model_cfg.n_kv_heads >= model_cfg.n_heads:
        return (f"n_kv_heads={model_cfg.n_kv_heads} == "
                f"n_heads={model_cfg.n_heads} (no KV-head sharing to "
                f"exploit; raceit_fused_tp is the same dataflow)")
    return None


def _shard_devices(plan, like: torch.Tensor) -> list:
    """One device per model shard, from the plan's mesh built for the
    operands' device kind."""
    return plan.exec_cfg.mesh.build(kind=like.device.type).axis_devices(AXIS)


def _split(x: torch.Tensor, devices: list, dim: int) -> list:
    """``x`` in ``len(devices)`` equal chunks along ``dim``, chunk i on
    ``devices[i]`` (a view where that is ``x``'s device)."""
    return [c.to(d) for c, d in zip(x.chunk(len(devices), dim), devices)]


def _on_each(x, devices: list) -> list:
    """A replicated operand (or None) on every shard's device."""
    return [None if x is None else x.to(d) for d in devices]


def _gather(outs: list, like: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cat([o.to(like.device) for o in outs], dim)


def _descale(results: list, vqs: list, shapes: list) -> list:
    """The single-device epilogue on every shard: PROB requant and V
    scales (`prob_descale`) over the shard's int32 accumulator."""
    return [(out32.float() * kops.prob_descale(cmax, vq)).reshape(shape)
            for (out32, cmax), vq, shape in zip(results, vqs, shapes)]


# ---------------------------------------------------------------------------
# attention_prefill
# ---------------------------------------------------------------------------

def _tp_fused_attention(q, k, v, mask, scale, plan, causal_offset=None):
    """`models.layers._raceit_fused_attention` sharded over heads.

    q (B, Sq, H, hd), k/v (B, Sk, KV, hd); ``mask`` (B, Sq, Sk) replicated
    (None with ``causal_offset`` takes the kernel's in-kernel causal mask,
    as the single-device fast path does).
    """
    mode = plan.exec_cfg.softmax_mode
    devs = _shard_devices(plan, q)
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep, hl = h // kv, h // len(devs)
    heads = lambda x: x.repeat_interleave(rep, dim=2) if rep > 1 else x
    qqs = kops.tp_quantize_tensor(_split(q.float() * scale, devs, 2))
    kqs = kops.tp_quantize_tensor(_split(heads(k.float()), devs, 2))
    vqs = kops.tp_quantize_tensor(_split(heads(v.float()), devs, 2))
    masks = _on_each(None if causal_offset is not None else mask, devs)
    rows = lambda c, n: c.transpose(1, 2).reshape(b * hl, n, hd).contiguous()

    def call(qq, kq, vq, m):
        return lambda floor: kops.acam_attention_codes(
            rows(qq.codes, sq), rows(kq.codes, sk), rows(vq.codes, sk),
            scale_product(qq, kq), m,
            q_offset=causal_offset if causal_offset is not None else 0,
            causal=causal_offset is not None, mode=mode, cmax_floor=floor)

    results = kops.tp_exact_call([call(*a) for a in zip(qqs, kqs, vqs,
                                                        masks)])
    outs = _descale(results, vqs, [(b, hl, sq, hd)] * len(devs))
    return _gather(outs, q, 1).transpose(1, 2)


@register("attention_prefill", "raceit_fused_tp", supported=_tp_supported,
          notes="tensor-parallel fused prefill: heads sharded over the mesh "
                "'model' axis, quantizer scales and the PROB requant max "
                "globalized (pmax) — bit-identical to raceit_fused; falls "
                f"back to the digital path beyond "
                f"Sk={RACEIT_ATTENTION_MAX_KEYS}")
def _prefill_raceit_fused_tp(plan, q, k, v, *, scale, q_offset, kind, window,
                             chunk, probs_dtype=None, pad_lens=None):
    sk = k.shape[1]
    if sk > RACEIT_ATTENTION_MAX_KEYS:
        return _prefill_digital(plan, q, k, v, scale=scale, q_offset=q_offset,
                                kind=kind, window=window, chunk=chunk,
                                probs_dtype=probs_dtype, pad_lens=pad_lens)
    if kind == "causal" and pad_lens is None:
        return _tp_fused_attention(q, k, v, None, scale, plan,
                                   causal_offset=q_offset)
    mask = _mask_array(kind, q.shape[0], q.shape[1], sk, q_offset, window,
                       pad_lens, device=q.device)
    return _tp_fused_attention(q, k, v, mask, scale, plan)


# ---------------------------------------------------------------------------
# attention_decode (contiguous and paged caches, flat and GQA-native grids)
# ---------------------------------------------------------------------------

def _tp_fused_decode(q, k, v, kv_len, scale, plan, pad_valid=None):
    """`models.layers._raceit_fused_decode` sharded over heads.

    q (B, Sq, H, hd), k/v (B, Smax, KV, hd); kv_len (scalar or (B,)) and
    pad_valid stay replicated: lengths are per request, and every shard
    serves every request (for a slice of its heads).
    """
    mode = plan.exec_cfg.softmax_mode
    devs = _shard_devices(plan, q)
    b, sq, h, hd = q.shape
    smax, kv = k.shape[1], k.shape[2]
    rep, hl = h // kv, h // len(devs)
    kvl = torch.as_tensor(kv_len, device=q.device).to(torch.int32)
    qqs = kops.tp_quantize_tensor(_split(q.float() * scale, devs, 2))
    kqs = kops.tp_masked_prefix_quantize(_split(k.float(), devs, 2), kvl,
                                         axis=1)
    vqs = kops.tp_masked_prefix_quantize(_split(v.float(), devs, 2), kvl,
                                         axis=1)
    mask = None
    if pad_valid is not None:  # (B, Smax) -> (B, Sq, Smax), one row per b
        mask = (pad_valid[:, None, :] if pad_valid.ndim == 2
                else pad_valid).expand(b, sq, smax)

    def fold(c):
        if rep > 1:
            c = c.repeat_interleave(rep, dim=2)
        return c.transpose(1, 2).reshape(b * hl, smax, hd).contiguous()

    def call(qq, kq, vq, m, lens):
        qc = qq.codes.transpose(1, 2).reshape(b * hl, sq, hd).contiguous()
        if sq == 1:
            return lambda floor: kops.acam_attention_decode_codes(
                qc, fold(kq.codes), fold(vq.codes), scale_product(qq, kq),
                lens, mask=m, mode=mode, cmax_floor=floor)
        # the chunked-prefill step, the same entry as the flat backend's
        return lambda floor: kops.acam_attention_codes(
            qc, fold(kq.codes), fold(vq.codes), scale_product(qq, kq), m,
            kv_len=lens, mode=mode, cmax_floor=floor)

    lens = _on_each(kops.expand_row_lens(kvl, hl), devs)
    results = kops.tp_exact_call([call(*a) for a in zip(
        qqs, kqs, vqs, _on_each(mask, devs), lens)])
    outs = _descale(results, vqs, [(b, hl, sq, hd)] * len(devs))
    return _gather(outs, q, 1).transpose(1, 2)


def _tp_gqa_decode(q, k, v, kv_len, scale, plan, pad_valid=None):
    """`models.layers._raceit_gqa_decode` sharded over KV-head groups."""
    b, sq, h, hd = q.shape
    if sq > 1:  # chunk steps ride the flat grid, as on one device
        return _tp_fused_decode(q, k, v, kv_len, scale, plan,
                                pad_valid=pad_valid)
    mode = plan.exec_cfg.softmax_mode
    devs = _shard_devices(plan, q)
    smax, kv = k.shape[1], k.shape[2]
    rep, kl = h // kv, kv // len(devs)
    kvl = torch.as_tensor(kv_len, device=q.device).to(torch.int32)
    qqs = kops.tp_quantize_tensor(_split(q.float() * scale, devs, 2))
    kqs = kops.tp_masked_prefix_quantize(_split(k.float(), devs, 2), kvl,
                                         axis=1)
    vqs = kops.tp_masked_prefix_quantize(_split(v.float(), devs, 2), kvl,
                                         axis=1)
    mask = None
    if pad_valid is not None:  # (B, Smax) -> (B, rep, Smax), one row per b
        mask = pad_valid[:, None, :].expand(b, rep, smax)
    to_groups = lambda c: c.transpose(1, 2).reshape(b * kl, smax, hd
                                                    ).contiguous()

    def call(qq, kq, vq, m, lens):
        return lambda floor: kops.acam_attention_decode_gqa_codes(
            qq.codes.reshape(b * kl, rep, hd).contiguous(),
            to_groups(kq.codes), to_groups(vq.codes), scale_product(qq, kq),
            lens, mask=m, mode=mode, cmax_floor=floor)

    lens = _on_each(kops.expand_row_lens(kvl, kl), devs)
    results = kops.tp_exact_call([call(*a) for a in zip(
        qqs, kqs, vqs, _on_each(mask, devs), lens)])
    outs = _descale(results, vqs, [(b, sq, h // len(devs), hd)] * len(devs))
    return _gather(outs, q, 2)


def _tp_paged_decode(q, k_pool, v_pool, kv_len, scale, plan, pad_valid=None,
                     block_table=None, gqa=False):
    """`models.layers._raceit_paged_decode` sharded over the pool's KV axis.

    The page pool (n_pages, page_size, KV, hd) shards on its head axis;
    block tables and fill levels are replicated, so page routing (and the
    trash-page fence) is the same on every shard.
    """
    mode = plan.exec_cfg.softmax_mode
    devs = _shard_devices(plan, q)
    ms = len(devs)
    b, sq, h, hd = q.shape
    n_pages, ps, kv, _ = k_pool.shape
    rep, hl, kl = h // kv, h // ms, kv // ms
    kvl = kv_len.to(torch.int32)
    bt = block_table.to(torch.int32).contiguous()
    pv = kops.page_valid_lengths(bt, kvl, n_pages, ps)
    qh = (q.float() * scale).transpose(1, 2)  # (B, H, Sq, hd)
    qqs = kops.tp_quantize_tensor(_split(qh, devs, 1))
    kqs = kops.tp_masked_page_quantize(_split(k_pool.float(), devs, 2), pv)
    vqs = kops.tp_masked_page_quantize(_split(v_pool.float(), devs, 2), pv)
    mask = pad_valid
    if mask is not None and mask.ndim == 2:  # (B, Smax) -> (B, Sq, Smax)
        mask = mask[:, None, :]
    gqa = gqa and sq == 1
    if gqa:
        if mask is not None:  # (B, 1, Sk) -> (B, rep, Sk), one per slot
            mask = mask.expand(b, rep, mask.shape[-1])
        to_rows = lambda c: c.transpose(1, 2).reshape(n_pages * kl, ps, hd
                                                      ).contiguous()
        lens = kops.expand_row_lens(kvl, kl)
    else:
        def to_rows(c):
            if rep > 1:
                c = c.repeat_interleave(rep, dim=2)
            return c.transpose(1, 2).reshape(n_pages * hl, ps, hd
                                             ).contiguous()
        lens = kops.expand_row_lens(kvl, hl)

    def call(qq, kq, vq, m, lens, bt):
        if gqa:
            return lambda floor: kops.acam_attention_decode_gqa_codes(
                qq.codes.reshape(b * kl, rep, hd).contiguous(),
                to_rows(kq.codes), to_rows(vq.codes), scale_product(qq, kq),
                lens, mask=m, mode=mode, block_table=bt, page_size=ps,
                groups_per_slot=kl, cmax_floor=floor)
        return lambda floor: kops.acam_attention_codes(
            qq.codes.reshape(b * hl, sq, hd).contiguous(), to_rows(kq.codes),
            to_rows(vq.codes), scale_product(qq, kq), m, kv_len=lens,
            mode=mode, block_table=bt, page_size=ps, groups_per_slot=hl,
            cmax_floor=floor)

    results = kops.tp_exact_call([call(*a) for a in zip(
        qqs, kqs, vqs, _on_each(mask, devs), _on_each(lens, devs),
        _on_each(bt, devs))])
    outs = _descale(results, vqs, [(b, hl, sq, hd)] * ms)
    return _gather(outs, q, 1).transpose(1, 2)  # (B, Sq, H, hd)


@register("attention_decode", "raceit_fused_tp", supported=_tp_supported,
          paged=True,
          notes="tensor-parallel fused decode: KV cache (contiguous or "
                "paged pool) sharded over heads on the mesh 'model' axis; "
                "probe->pmax->exact requant keeps it bit-identical to the "
                "single-device chain")
def _decode_raceit_fused_tp(plan, q, k, v, *, kv_len, scale, pad_valid=None,
                            block_table=None, page_size=None):
    if block_table is not None:
        return _tp_paged_decode(q, k, v, kv_len, scale, plan,
                                pad_valid=pad_valid, block_table=block_table,
                                gqa=False)
    return _tp_fused_decode(q, k, v, kv_len, scale, plan, pad_valid=pad_valid)


@register("attention_decode", "raceit_gqa_tp", supported=_gqa_tp_supported,
          paged=True,
          notes="tensor-parallel GQA-native decode: each shard's KV-head "
                "groups stream their own pool stripe — the multi-device "
                "serving default for grouped-query configs")
def _decode_raceit_gqa_tp(plan, q, k, v, *, kv_len, scale, pad_valid=None,
                          block_table=None, page_size=None):
    if block_table is not None:
        return _tp_paged_decode(q, k, v, kv_len, scale, plan,
                                pad_valid=pad_valid, block_table=block_table,
                                gqa=True)
    return _tp_gqa_decode(q, k, v, kv_len, scale, plan, pad_valid=pad_valid)
