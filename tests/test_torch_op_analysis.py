"""The port's op counter (`repro_torch.launch.op_analysis`) against the
reference's HLO analysis, and the kernels' ``meta`` launches against
`repro_torch.kernels.cost`.

* Flops: on one device at tiny size (olmo-1b, 2 layers, d 128), digital
  mode, `analyze_ops` over the port's step on ``meta`` counts what
  `repro.launch.hlo_analysis.analyze_hlo` counts in the reference's
  compiled step: prefill (21,757,952 at B 2, S 16), decode and a train
  step (forward, backward with remat, AdamW).
* Each kernel wrapper on ``meta`` tensors returns its outputs' shapes and
  dtypes, computes nothing, launches nothing, and reports exactly what
  `kernels.cost` reckons: the paged and contiguous kernels' two passes,
  the one-tile kernel's one launch, the LUT, MVM and softmax kernels.
* The counter's bytes, its peak of live storage and the ring model of the
  collectives.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ExecConfig as RExec  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.models import Model as RModel  # noqa: E402
from repro_torch.configs.base import ExecConfig  # noqa: E402
from repro_torch.kernels import acam_attention as A  # noqa: E402
from repro_torch.kernels import acam_lut, acam_mvm, acam_softmax  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.launch import op_analysis  # noqa: E402
from repro_torch.launch.op_analysis import analyze_ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402

from _torch_helpers import port_model_config  # noqa: E402

TINY = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
            vocab_size=512)
META = torch.device("meta")


@pytest.fixture(scope="module")
def models():
    cfg = get_config("olmo-1b").replace(**TINY)
    rm = RModel(cfg, RExec(mode="digital"))
    tm = Model(port_model_config(cfg), ExecConfig(mode="digital"),
               device="meta")
    return cfg, rm, tm


def _ref_flops(fn, *args):
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


@pytest.mark.parametrize("B,S", [(2, 16), (1, 64)])
def test_prefill_and_decode_flops_match_hlo(models, B, S):
    cfg, rm, tm = models
    rparams = jax.eval_shape(rm.init, jax.random.PRNGKey(0))
    rcache = jax.eval_shape(lambda: rm.init_cache(B, S))
    params = tm.init(torch.Generator())
    ref = _ref_flops(lambda p, t, c: rm.prefill(p, t, c), rparams,
                     jax.ShapeDtypeStruct((B, S), jnp.int32), rcache)
    got, _ = analyze_ops(tm.prefill, params,
                         torch.zeros((B, S), dtype=torch.int32, device=META),
                         tm.init_cache(B, S))
    assert got.flops == ref
    if (B, S) == (2, 16):
        assert ref == 21_757_952
    ref = _ref_flops(lambda p, t, c: rm.decode_step(p, t, c), rparams,
                     jax.ShapeDtypeStruct((B, 1), jnp.int32), rcache)
    got, _ = analyze_ops(tm.decode_step, params,
                         torch.zeros((B, 1), dtype=torch.int32, device=META),
                         tm.init_cache(B, S))
    assert got.flops == ref
    assert got.kernel_launches == {}   # digital: no kernel


def test_train_step_flops_match_hlo(models):
    from repro.train import optim as roptim, trainer as rtrainer
    from repro_torch.train import optim, trainer
    cfg, rm, tm = models
    B, S = 2, 32
    rparams = jax.eval_shape(rm.init, jax.random.PRNGKey(0))
    ropt = jax.eval_shape(roptim.adamw_init, rparams)
    rstep = rtrainer.make_train_step(rm, roptim.AdamWConfig(
        schedule=roptim.warmup_cosine(100, 10_000)))
    ref = _ref_flops(rstep, rparams, ropt,
                     {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)})
    params = tm.init(torch.Generator())
    step = trainer.make_train_step(tm, optim.AdamWConfig(
        schedule=optim.warmup_cosine(100, 10_000)))
    got, _ = analyze_ops(step, params, optim.adamw_init(params),
                         {"tokens": torch.zeros((B, S), dtype=torch.int32,
                                                device=META)})
    # forward, backward and the layers' recomputed products (remat):
    # the same products as the reference's HLO
    assert got.flops == ref


# ------------------------------------------------- the kernels' meta launches

def _meta(shape, dtype=torch.int8):
    return torch.empty(shape, dtype=dtype, device=META)


def _launches_of(fn):
    before = {**A.launches, **acam_lut.launches, **acam_mvm.launches,
              **acam_softmax.launches}
    c, out = analyze_ops(fn)
    after = {**A.launches, **acam_lut.launches, **acam_mvm.launches,
             **acam_softmax.launches}
    assert after == before          # meta launches nothing
    return c, out


def _expect(c, launches):
    """The counter recorded exactly ``launches``: their names, bytes and
    operations (the wrapper's own small ops before a launch, its lengths
    and mask, count as ops of their own)."""
    assert c.launches == launches
    nbytes, ops = cost.total(launches)
    assert c.flops == ops and c.int8_ops == ops
    assert c.memory_bytes >= nbytes
    kernel_ops = {k: v for k, v in c.ops.items() if k.startswith("kernel.")}
    want = {}
    for x in launches:
        want[f"kernel.{x.name}"] = want.get(f"kernel.{x.name}", 0) + 1
    assert kernel_ops == want


def test_contiguous_and_single_meta_launches():
    G, Sq, Sk, D = 40, 1, 1024, 64
    kvl = torch.empty((G,), dtype=torch.int32, device=META)
    c, (out, cmax) = _launches_of(lambda: A.acam_attention_codes(
        _meta((G, Sq, D)), _meta((G, Sk, D)), _meta((G, Sk, D)), 0.01,
        kv_len=kvl))
    assert out.shape == (G, Sq, D) and out.dtype == torch.int32
    assert cmax.shape == () and cmax.dtype == torch.int32
    _expect(c, cost.contiguous_attention(G, Sq, D, G * Sk, Sq * G * Sk))
    # causal, a Python offset: the pairs below the diagonal
    G, Sq, Sk = 4, 300, 600
    c, _ = _launches_of(lambda: A.acam_attention_codes(
        _meta((G, Sq, D)), _meta((G, Sk, D)), _meta((G, Sk, D)), 0.01,
        causal=True, q_offset=300))
    pairs = G * sum(min(Sk, i + 301) for i in range(Sq))
    _expect(c, cost.contiguous_attention(G, Sq, D, G * Sk, pairs))
    # one tile, a mask
    G, Sq, Sk = 8, 16, 200
    mask = torch.empty((2, Sq, Sk), dtype=torch.bool, device=META)
    assert A.one_tile(G, Sq, Sk)
    c, _ = _launches_of(lambda: A.acam_attention_codes(
        _meta((G, Sq, D)), _meta((G, Sk, D)), _meta((G, Sk, D)), 0.01,
        mask, kv_len=150))
    _expect(c, cost.contiguous_attention(G, Sq, D, G * 150, Sq * G * 150,
                                         mask.numel(), single=True))


def test_paged_meta_launch():
    slots, gps, Sq, D, ps, mp = 3, 4, 1, 128, 64, 8
    G = slots * gps
    c, (out, cmax) = _launches_of(lambda: A.acam_attention_codes(
        _meta((G, Sq, D)), _meta((20 * gps, ps, D)), _meta((20 * gps, ps, D)),
        0.01, kv_len=torch.empty((G,), dtype=torch.int32, device=META),
        block_table=torch.empty((slots, mp), dtype=torch.int32, device=META),
        page_size=ps, groups_per_slot=gps))
    assert out.shape == (G, Sq, D) and out.dtype == torch.int32
    _expect(c, cost.paged_attention(G, Sq, D, G * mp * ps, slots * mp, G))


def test_lut_mvm_softmax_meta_launches():
    from repro_torch.core.crossbar import CrossbarConfig
    lut = torch.empty((256,), dtype=torch.int32, device=META)
    x = _meta((512, 640), torch.int32)
    c, out = _launches_of(lambda: acam_lut.acam_lut_2d(x, lut))
    assert out.shape == x.shape and out.dtype == torch.int32
    _expect(c, cost.lut(x.numel(), 4, 256))
    xm, w = _meta((64, 1280)), _meta((1280, 512))
    for cfg, planes in ((CrossbarConfig(), 1),
                        (CrossbarConfig(adc_mode="quantize"), None)):
        planes = planes or cfg.num_input_slices * cfg.num_weight_slices
        c, out = _launches_of(lambda: acam_mvm.acam_mvm(xm, w, cfg))
        assert out.shape == (64, 512) and out.dtype == torch.int32
        _expect(c, cost.mvm(64, 1280, 512, planes))
    xs = _meta((160, 1024))
    c, out = _launches_of(lambda: acam_softmax.acam_softmax_codes(xs))
    assert out.shape == xs.shape and out.dtype == torch.int32
    _expect(c, cost.softmax(xs.numel(), 1))


def test_cost_matches_the_bound_formulas():
    # a paged decode: bytes and operations by hand
    G, Sq, D, live = 40, 1, 64, 40 * 700
    a, b = cost.paged_attention(G, Sq, D, live, 8 * 16, G)
    assert a.nbytes + b.nbytes == (G * Sq * D + 2 * live * D
                                   + 4 * G * Sq * D + 4 * 8 * 16 + 4 * G)
    assert a.ops + b.ops == 2 * 2 * Sq * live * D
    ms, by = cost.bound_ms(3.35e9, 1.0)
    assert math.isclose(ms, 1.0) and by == "bytes"
    ms, by = cost.bound_ms(1.0, 1979e9)
    assert math.isclose(ms, 1.0) and by == "operations"


# ------------------------------------------------------ bytes, peak, rings

def test_bytes_views_and_peak():
    a = torch.empty((1024,), device=META)

    def step(a):
        b = a * 2               # 4 KiB in, 4 KiB out
        v = b.view(32, 32)      # a view: no traffic, no storage
        c = v.sum()             # 4 KiB in, 4 B out
        del b, v
        d = torch.zeros((4096,), device=META)   # 16 KiB out
        return c, d
    cst, _ = analyze_ops(step, a)
    assert cst.arg_bytes == 4096
    assert cst.memory_bytes == 8192 + 4096 + 4 + 16384
    # a and b (8 KiB), then c (4 B) and d (16 KiB) with b gone
    assert cst.peak_live_bytes == 4096 + 4 + 16384
    assert cst.ops["view"] == 1 and cst.flops == 0


def test_ring_model_and_collectives():
    assert op_analysis.ring_bytes("all-reduce", 100.0, 4) == 150.0
    assert op_analysis.ring_bytes("all-gather", 100.0, 4) == 75.0
    assert op_analysis.ring_bytes("all-reduce", 100.0, 1) == 0.0
    pspecs = {"embed": {"tok_emb": ("model", None)},
              "blocks": [{"attn": {"wo": ("model", None, None)},
                          "ffn": {"w2": ("model", None)}}] * 3}
    assert op_analysis.row_parallel_count(pspecs) == 7
    c = op_analysis.OpCost()
    op_analysis.collectives(c, pspecs, 1000, {"data": 4, "model": 2},
                            act_rows=8, out_rows=8, d_model=16, vocab=32,
                            act_itemsize=2, train=True)
    act = 8 * 16 * 2
    assert c.collective_by_axis["model"] == (
        2 * 7 * op_analysis.ring_bytes("all-reduce", act, 2)
        + 2 * op_analysis.ring_bytes("all-gather", 8 * 32 * 2, 2))
    assert c.collective_by_axis["data"] == op_analysis.ring_bytes(
        "all-reduce", 1000, 4)
    assert "not a trace" in c.notes[0]
