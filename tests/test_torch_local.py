"""Local (sliding-window) attention and ring caches of the port against the
reference, below the serving layer.

* `exec.backends._mask_fn("local")` and `_mask_array`: the same masks.
* `models.layers._local_block_attention` (the q-blocked digital path) and
  the digital prefill backend's choice of it: the reference's float values
  within 1e-5 (float32 einsums that reduce in other orders) in float32
  probabilities, 1e-2 in bfloat16 (one bfloat16 rounding of the
  probabilities, taken at slightly different float32 values).
* `layers.attention(local=True)` on a ring of L = window = 8 columns, in
  digital, raceit fused and raceit staged: prefill with Sq < L, Sq == L and
  Sq > L, and decode on a wrapped ring with a scalar and a per-slot write
  index (left-pad masks and the ring-reclaim clause included). The output
  matches within 1e-5 (float32 matmul order); the cache columns and
  indices written are the reference's. The layer has no positional
  embedding, so both frameworks quantize the same q, k and v: the raceit
  paths compare the same integer pipelines.
* The reference's own ring tests, mirrored: a ring-cache decode equals the
  full windowed forward (tests/test_models_smoke.py:93) and a prompt that
  overflows the ring drops the decode pad mask
  (tests/test_serve_batching.py:171).
* Block-paged caches refuse local layers, as the reference does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ExecConfig, ModelConfig  # noqa: E402
from repro.exec import backends as RB  # noqa: E402
from repro.exec import resolve_plan as r_resolve  # noqa: E402
from repro.models import Model as RModel  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.model import quantize_model_params as r_quantize  # noqa: E402
from repro_torch.exec import backends as TB  # noqa: E402
from repro_torch.exec import resolve_plan as t_resolve  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import blocks as TBlocks  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.model import quantize_model_params as t_quantize  # noqa: E402

from _torch_helpers import (port_exec_config, port_model_config,  # noqa: E402
                            port_params)
from conftest import tiny_config  # noqa: E402

W = 8  # window = ring length
ATOL = 1e-5
# the execution configs under test: digital, and raceit with fused or
# staged attention (on resident int8 weights, as raceit_q8 serves)
EXECS = {
    "digital": ExecConfig(mode="digital"),
    "fused": ExecConfig.serving(mode="raceit"),
    "staged": ExecConfig.serving(mode="raceit", fused_attention=False),
}
_CFG = ModelConfig(name="loc", n_layers=1, d_model=32, n_heads=4,
                   n_kv_heads=2, d_ff=64, vocab_size=64, window=W,
                   mixer_pattern=("attn_local",), pos_emb="none",
                   param_dtype="float32", compute_dtype="float32")


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- masks

@pytest.mark.parametrize("q_offset", [0, 5, 13])
@pytest.mark.parametrize("window", [3, 8])
def test_mask_fn_local(q_offset, window):
    qi, ki = np.arange(6)[:, None], np.arange(20)[None, :]
    want = RB._mask_fn("local", 20, q_offset, window)(jnp.asarray(qi),
                                                      jnp.asarray(ki))
    got = TB._mask_fn("local", 20, q_offset, window)(_t(qi), _t(ki))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    # row i sees keys up to i + q_offset, at most a window of them
    assert got.sum(-1).tolist() == [min(window, i + q_offset + 1)
                                    for i in range(6)]


@pytest.mark.parametrize("pad", [None, [0, 3, 7]])
def test_mask_array_local(pad):
    want = RB._mask_array("local", 3, 10, 10, 0, 4,
                          None if pad is None else jnp.asarray(pad))
    got = TB._mask_array("local", 3, 10, 10, 0, 4,
                         None if pad is None else torch.tensor(pad))
    np.testing.assert_array_equal(got.numpy(), _np(want))


# ---------------------------------------------- the q-blocked digital path

@pytest.mark.parametrize("probs", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_local_block_attention(heads, probs):
    H, KV = heads
    rng = np.random.default_rng(H + KV)
    q = rng.normal(0, 1, (2, 4 * W, H, 16)).astype(np.float32)
    k = rng.normal(0, 1, (2, 4 * W, KV, 16)).astype(np.float32)
    v = rng.normal(0, 1, (2, 4 * W, KV, 16)).astype(np.float32)
    want = RL._local_block_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), W, 0.25,
                                     getattr(jnp, probs))
    got = TL._local_block_attention(_t(q), _t(k), _t(v), W, 0.25,
                                    getattr(torch, probs))
    np.testing.assert_allclose(got.numpy(), _np(want),
                               atol=ATOL if probs == "float32" else 1e-2)


@pytest.mark.parametrize("sq", [W, 2 * W, 3 * W + 4])
@pytest.mark.parametrize("padded", [False, True])
def test_prefill_digital_local(sq, padded, monkeypatch):
    """Past one window an unpadded prompt whose length the window divides
    takes the q-blocked path; the rest take the chunked path; both the
    reference's values."""
    rng = np.random.default_rng(sq)
    q = rng.normal(0, 1, (2, sq, 4, 16)).astype(np.float32)
    k = rng.normal(0, 1, (2, sq, 2, 16)).astype(np.float32)
    v = rng.normal(0, 1, (2, sq, 2, 16)).astype(np.float32)
    pad = np.array([0, 3], np.int32) if padded else None
    kw = dict(scale=0.25, q_offset=0, kind="local", window=W, chunk=1024)
    cfg = _CFG
    want = RB._prefill_digital(
        r_resolve(cfg, EXECS["digital"]), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v), pad_lens=None if pad is None else jnp.asarray(pad),
        **kw)
    blocked = []
    inner = TL._local_block_attention
    monkeypatch.setattr(TL, "_local_block_attention",
                        lambda *a: blocked.append(1) or inner(*a))
    got = TB._prefill_digital(
        t_resolve(port_model_config(cfg), port_exec_config(EXECS["digital"])),
        _t(q), _t(k), _t(v), pad_lens=None if pad is None else _t(pad), **kw)
    assert bool(blocked) == (not padded and sq % W == 0 and sq > W)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


# ------------------------------------------------- layers.attention(local)

def _layer(mode, quantized=False):
    """(reference params, port params, reference plan, port plan)."""
    p = RL.init_attention(jax.random.PRNGKey(3), _CFG, jnp.float32)
    tp = {k: _t(v) for k, v in p.items()}
    if quantized:
        p, tp = r_quantize(p), t_quantize(tp)
    ec = EXECS[mode]
    return p, tp, ec, port_exec_config(ec)


def _caches(B, idx, rng):
    """A ring cache (B, W, KV, hd) with random contents on both sides."""
    hd = _CFG.resolved_head_dim
    k = rng.normal(0, 1, (B, W, 2, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, W, 2, hd)).astype(np.float32)
    idx = np.asarray(idx, np.int32)
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v),
             "idx": jnp.asarray(idx)},
            {"k": _t(k), "v": _t(v), "idx": _t(idx)})


def _compare(want, got):
    (wo, wc), (go, gc) = want, got
    np.testing.assert_allclose(go.numpy(), _np(wo), atol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(gc[name].numpy(), _np(wc[name]),
                                   atol=ATOL)
    np.testing.assert_array_equal(gc["idx"].numpy(), _np(wc["idx"]))


@pytest.mark.parametrize("sq", [5, W, 12])
@pytest.mark.parametrize("mode", list(EXECS))
def test_attention_local_prefill(mode, sq):
    """Prefill into a fresh ring (Sq < L writes columns [0, Sq); Sq >= L
    keeps the last L), with a left-padded row."""
    rng = np.random.default_rng(sq)
    p, tp, ec, tec = _layer(mode, quantized=mode != "digital")
    x = rng.normal(0, 1, (2, sq, _CFG.d_model)).astype(np.float32)
    pad = np.array([0, 2], np.int32)
    pos = np.maximum(np.arange(sq)[None] - pad[:, None], 0).astype(np.int32)
    rc, tc = _caches(2, 0, rng)
    want = RL.attention(p, jnp.asarray(x), cfg=_CFG, plan=ec,
                        positions=jnp.asarray(pos), local=True, cache=rc,
                        pad_lens=jnp.asarray(pad))
    got = TL.attention(tp, _t(x), cfg=port_model_config(_CFG), plan=tec,
                       positions=_t(pos), local=True, cache=tc,
                       pad_lens=_t(pad))
    _compare(want, got)


@pytest.mark.parametrize("mode", list(EXECS))
def test_attention_local_prefill_at_an_offset(mode):
    """A second prefill of 3 tokens at idx 6 of an 8-column ring: the write
    starts at 6 % 8 and is clamped to L - Sq, as `dynamic_update_slice`
    clamps it; the window reaches back from the offset."""
    rng = np.random.default_rng(7)
    p, tp, ec, tec = _layer(mode, quantized=mode != "digital")
    x = rng.normal(0, 1, (2, 3, _CFG.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, 9, dtype=np.int32), (2, 3)).copy()
    rc, tc = _caches(2, 14, rng)  # 14 % 8 = 6 > L - Sq = 5
    want = RL.attention(p, jnp.asarray(x), cfg=_CFG, plan=ec,
                        positions=jnp.asarray(pos), local=True, cache=rc)
    got = TL.attention(tp, _t(x), cfg=port_model_config(_CFG), plan=tec,
                       positions=_t(pos), local=True, cache=tc)
    _compare(want, got)


@pytest.mark.parametrize("mode", list(EXECS))
@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "slots"])
def test_attention_local_decode_on_a_wrapped_ring(mode, per_slot):
    """A decode step on rings that have wrapped: the new k/v land at
    idx % L (every row of a per-slot cache at its own column), every column
    inside the window is attended, and left-pad columns stay masked until
    the ring reclaims them."""
    rng = np.random.default_rng(11 + per_slot)
    p, tp, ec, tec = _layer(mode, quantized=mode != "digital")
    B = 4
    x = rng.normal(0, 1, (B, 1, _CFG.d_model)).astype(np.float32)
    idx = [3, 8, 13, 21] if per_slot else 13
    rc, tc = _caches(B, idx, rng)
    pad = np.array([2, 0, 3, 1], np.int32)
    kw, tkw = {}, {}
    if per_slot:
        lens = np.asarray(idx, np.int32) + 1
        kw = dict(slot_lens=jnp.asarray(lens), pad_lens=jnp.asarray(pad),
                  pad_prompt_len=jnp.int32(W))
        tkw = dict(slot_lens=_t(lens), pad_lens=_t(pad), pad_prompt_len=W)
    else:
        kw = dict(pad_lens=jnp.asarray(pad))
        tkw = dict(pad_lens=_t(pad))
    pos = np.full((B, 1), 13, np.int32)
    want = RL.attention(p, jnp.asarray(x), cfg=_CFG, plan=ec,
                        positions=jnp.asarray(pos), local=True, cache=rc,
                        **kw)
    got = TL.attention(tp, _t(x), cfg=port_model_config(_CFG), plan=tec,
                       positions=_t(pos), local=True, cache=tc, **tkw)
    _compare(want, got)
    cols = np.asarray(idx) % W * np.ones(B, int)
    changed = (got[1]["k"].numpy() != rc["k"]).any(axis=(2, 3))
    assert [np.flatnonzero(r).tolist() for r in changed] == \
        [[int(c)] for c in cols]


def test_global_layer_writes_past_the_buffer_are_still_dropped():
    """Global layers keep the drop rule of a per-slot index past the
    buffer; the same index on a local layer wraps."""
    rng = np.random.default_rng(2)
    _, tp, _, tec = _layer("digital")
    x = _t(rng.normal(0, 1, (2, 1, _CFG.d_model)).astype(np.float32))
    pos = torch.zeros((2, 1), dtype=torch.int32)
    for local, written in ((False, [[2], []]), (True, [[2], [1]])):
        _, tc = _caches(2, [2, 9], rng)
        before = tc["k"].clone()
        TL.attention(tp, x, cfg=port_model_config(_CFG), plan=tec,
                     positions=pos, local=local, cache=tc,
                     slot_lens=torch.tensor([3, 0]))
        changed = (tc["k"] != before).any(-1).any(-1)
        assert [torch.nonzero(r).flatten().tolist() for r in changed] == \
            written


# ------------------------------------------------ the reference's ring tests

def _gemma(key=0):
    cfg = tiny_config(get_config("gemma3-4b"))
    params = RModel(cfg).init(jax.random.PRNGKey(key))
    return cfg, params


def test_local_ring_cache_equals_full_decode():
    """tests/test_models_smoke.py:93 on the port: decoding through ring
    caches (24 tokens, window 8, the rings wrap twice) gives the logits of
    the reference's full windowed forward within its 2e-3, and the
    reference's own ring decode within 1e-4 (float32 stacks of 13 layers
    reduce in other orders)."""
    cfg, params = _gemma()
    rmodel = RModel(cfg)
    tmodel = TModel(port_model_config(cfg), device="cpu")
    tparams = port_params(params, cfg)
    S = 24
    tokens = jax.random.randint(jax.random.PRNGKey(0), (1, S), 0,
                                cfg.vocab_size)
    full = _np(rmodel.forward(params, {"tokens": tokens}, use_remat=False))
    rcache = rmodel.init_cache(1, max_len=32)
    tcache = tmodel.init_cache(1, max_len=32)
    assert [c["attn"]["k"].shape[1] for c in tcache] == \
        [W if m == "attn_local" else 32
         for m in (cfg.layer_spec(i)[0] for i in range(cfg.n_layers))]
    tok = _np(tokens)
    _, rcache = rmodel.prefill(params, tokens[:, :4], rcache)
    _, tcache = tmodel.prefill(tparams, _t(tok[:, :4]), tcache)
    errs, diffs = [], []
    for t in range(4, S):
        rl, rcache = rmodel.decode_step(params, tokens[:, t:t + 1], rcache)
        tl, tcache = tmodel.decode_step(tparams, _t(tok[:, t:t + 1]), tcache)
        errs.append(float(np.abs(tl.numpy()[:, 0] - full[:, t]).max()))
        diffs.append(float(np.abs(tl.numpy() - _np(rl)).max()))
    assert max(errs) < 2e-3, errs
    assert max(diffs) < 1e-4, diffs


def test_ring_overflow_prompt_drops_decode_pad_mask():
    """tests/test_serve_batching.py:171 on the port: a 12-token prompt takes
    the last-L prefill branch of an 8-column ring, so with
    ``pad_prompt_len > L`` the decode pad mask is a no-op for the layer;
    and the outputs are the reference's."""
    rng = np.random.default_rng(0)
    p, tp, ec, tec = _layer("digital")
    tcfg = port_model_config(_CFG)
    B, plen = 2, 12
    pad = np.array([5, 0], np.int32)
    rc, tc = _caches(B, 0, rng)
    x = rng.normal(0, 1, (B, plen, _CFG.d_model)).astype(np.float32)
    pos = np.maximum(np.arange(plen)[None] - pad[:, None], 0)
    _, rc = RL.attention(p, jnp.asarray(x), cfg=_CFG, plan=ec,
                         positions=jnp.asarray(pos), local=True, cache=rc,
                         pad_lens=jnp.asarray(pad))
    _, tc = TL.attention(tp, _t(x), cfg=tcfg, plan=tec, positions=_t(pos),
                         local=True, cache=tc, pad_lens=_t(pad))
    xt = rng.normal(0, 1, (B, 1, _CFG.d_model)).astype(np.float32)
    dpos = (plen - pad[:, None]).astype(np.int32)
    snap = {k: v.clone() for k, v in tc.items()}
    o_pad, _ = TL.attention(tp, _t(xt), cfg=tcfg, plan=tec,
                            positions=_t(dpos), local=True, cache=tc,
                            pad_lens=_t(pad), pad_prompt_len=plen)
    o_ref, _ = TL.attention(tp, _t(xt), cfg=tcfg, plan=tec,
                            positions=_t(dpos), local=True, cache=snap)
    np.testing.assert_array_equal(o_pad.numpy(), o_ref.numpy())
    want, _ = RL.attention(p, jnp.asarray(xt), cfg=_CFG, plan=ec,
                           positions=jnp.asarray(dpos), local=True,
                           cache=rc, pad_lens=jnp.asarray(pad),
                           pad_prompt_len=jnp.int32(plen))
    np.testing.assert_allclose(o_pad.numpy(), _np(want), atol=ATOL)


# ------------------------------------------------------ paged caches refuse

def test_paged_caches_refuse_local_layers():
    cfg = port_model_config(tiny_config(get_config("gemma3-4b")))
    with pytest.raises(NotImplementedError, match="global attention layers"):
        TModel(cfg, device="cpu").init_slot_cache(2, 32, page_size=8,
                                                  n_pages=9)
    with pytest.raises(NotImplementedError, match="local/ring layers"):
        _, tp, _, tec = _layer("digital")
        TL.attention(tp, torch.zeros((1, 1, _CFG.d_model)),
                     cfg=port_model_config(_CFG), plan=tec,
                     positions=torch.zeros((1, 1), dtype=torch.int32),
                     local=True, cache=TBlocks.init_layer_cache(
                         port_model_config(_CFG), "attn", 1, 8, "cpu",
                         torch.float32, page_size=8, n_pages=2)["attn"],
                     slot_lens=torch.tensor([1]),
                     block_table=torch.ones((1, 1), dtype=torch.int32),
                     page_size=8)


def test_stack_caches_have_two_lengths():
    """Local layers keep a ring of min(max_len, window) columns, global
    layers max_len; the slot pool gives every layer a per-slot index."""
    cfg = port_model_config(tiny_config(get_config("gemma3-4b")))
    model = TModel(cfg, device="cpu")
    for max_len, ring in ((32, W), (6, 6)):
        cache = model.init_slot_cache(3, max_len)
        for i, layer in enumerate(cache):
            local = cfg.layer_spec(i)[0] == "attn_local"
            assert layer["attn"]["k"].shape == \
                (3, ring if local else max_len, 2, 16)
            assert layer["attn"]["idx"].shape == (3,)
