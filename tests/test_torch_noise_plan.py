"""The ``raceit_noisy_*`` backends behind the port's plan, against the
reference's, and the ``lm_head=raceit_q8`` backend.

* The registry: the port registers the reference's noisy names per slot;
  at an all-zero NoiseConfig every one is bit-identical to its clean
  counterpart (the registry-derived loop of tests/test_exec_noise.py), and
  a zero-noise plan's attention is bit-identical to the clean plan's over
  softmax mode x fill level.
* Each noisy backend at ``nominal`` and ``worst_case`` against the
  reference's on the same inputs, the reference jitted as it serves:
  matmul on float and resident int8 weights, the LUT activation, the
  Fig.-8 softmax, staged prefill attention (GQA) and decode (a shared and
  a per-row fill) in each softmax mode. Bit for bit, as the clean staged
  path is
  (tests/test_torch_staged.py), except the decode's float score einsum,
  held to that file's ATOL; the matmul family (and the q8 lm head)
  against the reference's op-by-op graph, which the clean backends
  follow.
* Reproducibility and seed dependence; noise in the plan cache key; the
  fused predicate's degrade reason; ``plan.explain()`` line for line.
* ``lm_head=raceit_q8``: the port's plan names it as the reference's does,
  and tiny gpt2-large's logits with float weights through it equal the
  reference's within ATOL, with the same argmax.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ExecConfig  # noqa: E402
from repro.exec import list_backends as r_list  # noqa: E402
from repro.exec import resolve_plan as r_resolve  # noqa: E402
from repro.hw.noise import NoiseConfig  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.layers import QuantizedWeight as RQW  # noqa: E402
from repro.serve import GenerationEngine as REngine  # noqa: E402
from repro_torch.exec import OP_SLOTS  # noqa: E402
from repro_torch.exec import list_backends as t_list  # noqa: E402
from repro_torch.exec import resolve_plan as t_resolve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.layers import QuantizedWeight as TQW  # noqa: E402
from repro_torch.serve import GenerationEngine as TEngine  # noqa: E402

from _torch_helpers import (port_exec_config, port_model_config,  # noqa: E402
                            port_params)
from conftest import tiny_config  # noqa: E402

CFG = tiny_config(get_config("gpt2-large"))
TCFG = port_model_config(CFG)
MODES = ("pot", "pot_fine", "uniform")
# tests/test_torch_staged.py's tolerance for float32 sums in other orders
ATOL = 1e-4


def _plans(ec):
    return r_resolve(CFG, ec), t_resolve(TCFG, port_exec_config(ec))


def _noisy(level="nominal", seed=0, **kw):
    nz = dataclasses.replace(NoiseConfig.preset(level, seed=seed), **kw)
    return ExecConfig(mode="raceit", noise=nz)


def _slot_args(rng, slot):
    """Numpy arguments per slot (q has H=4 over KV=2: the GQA repeat)."""
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    if slot == "matmul":
        return (f32(2, 16), f32(16, 8), None), {}
    if slot == "activation":
        return (f32(4, 16),), {}
    if slot == "softmax":
        return (2.0 * f32(2, 8), -1), {}
    if slot == "attention_prefill":
        return ((f32(1, 8, 4, 8), f32(1, 8, 2, 8), f32(1, 8, 2, 8)),
                dict(scale=0.35, q_offset=0, kind="causal", window=4,
                     chunk=8))
    if slot == "attention_decode":
        return ((f32(2, 1, 4, 8), f32(2, 16, 2, 8), f32(2, 16, 2, 8)),
                dict(kv_len=np.int32(12), scale=0.35))
    if slot == "dd_matmul":
        return (rng.integers(-127, 128, (2, 4, 8)).astype(np.int8),
                rng.integers(-127, 128, (2, 8, 4)).astype(np.int8)), {}
    if slot == "lm_head":
        return (f32(1, 4, 16), f32(16, 32)), {}
    raise KeyError(slot)


def _t(a):
    if a is None or isinstance(a, (int, float, str)):
        return a
    return torch.from_numpy(np.array(a))


def _j(a):
    if a is None or isinstance(a, (int, float, str)):
        return a
    return jnp.asarray(a)


def _call_port(plan, slot, args, kw):
    return getattr(plan, slot)(*map(_t, args),
                               **{k: _t(v) for k, v in kw.items()})


def _call_ref(plan, slot, args, kw):
    """The reference's backend jitted, as its serving graph runs it; the
    matmul family op by op, whose descale product the port follows (its
    clean raceit_int and resident matmul too: XLA reorders the jitted
    product's constants there)."""
    if slot == "matmul":
        return np.asarray(plan.matmul(*map(_j, args)))
    arrays = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]

    def fn(*xs):
        full = list(args)
        for i, x in zip(arrays, xs):
            full[i] = x
        return getattr(plan, slot)(*full, **{k: _j(v) for k, v in kw.items()})
    return np.asarray(jax.jit(fn)(*[jnp.asarray(args[i]) for i in arrays]))


# ---------------------------------------------------------------- registry

@pytest.mark.parametrize("slot", OP_SLOTS)
def test_noisy_names_are_the_references(slot):
    want = sorted(n for n in r_list(slot) if "noisy" in n)
    got = sorted(n for n in t_list(slot) if "noisy" in n)
    assert got == want
    if slot in ("dd_matmul", "lm_head"):
        assert not got


@pytest.mark.parametrize("slot", OP_SLOTS)
def test_noisy_backends_zero_sigma_bit_parity(slot):
    """Enumerate the port's registry: every noisy-named backend, pinned
    under an all-zero NoiseConfig, is bit-identical to its clean
    counterpart (name minus 'noisy_', else raceit_staged)."""
    from repro_torch.hw.noise import NoiseConfig as TNoise
    from repro_torch.configs.base import ExecConfig as TExec
    names = t_list(slot)
    noisy_names = sorted(n for n in names if "noisy" in n)
    if slot in ("dd_matmul", "lm_head"):
        assert not noisy_names
        return
    assert noisy_names, f"slot {slot!r} has no raceit_noisy_* backend"
    args, kw = _slot_args(np.random.default_rng(0), slot)
    for name in noisy_names:
        ref = name.replace("noisy_", "")
        if ref not in names:
            ref = "raceit_staged"
        p_noisy = t_resolve(TCFG, TExec(mode="raceit", noise=TNoise())
                            .with_ops(**{slot: name}))
        p_clean = t_resolve(TCFG, TExec(mode="raceit").with_ops(**{slot: ref}))
        assert p_noisy.backend(slot) == name and p_clean.backend(slot) == ref
        np.testing.assert_array_equal(
            _call_port(p_noisy, slot, args, kw).numpy(),
            _call_port(p_clean, slot, args, kw).numpy(),
            err_msg=f"{slot}/{name} vs {ref}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fill", [4, 16])
def test_zero_noise_attention_parity_matrix(mode, fill):
    """A zero-noise raceit plan (no pins) routes attention to
    raceit_noisy_staged and stays bit-identical to the clean plan, across
    softmax modes and fill levels (a per-row kv_len vector included)."""
    from repro_torch.configs.base import ExecConfig as TExec
    from repro_torch.hw.noise import NoiseConfig as TNoise
    clean = t_resolve(TCFG, TExec(mode="raceit", softmax_mode=mode))
    zero = t_resolve(TCFG, TExec(mode="raceit", softmax_mode=mode,
                                 noise=TNoise()))
    assert zero.backend("attention_decode") == "raceit_noisy_staged"
    assert zero.backend("attention_prefill") == "raceit_noisy_staged"
    rng = np.random.default_rng(fill)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    q, k, v = f32(2, 1, 4, 8), f32(2, 16, 2, 8), f32(2, 16, 2, 8)
    kv = torch.tensor([fill, max(fill // 2, 1)], dtype=torch.int32)
    np.testing.assert_array_equal(
        clean.attention_decode(q, k, v, kv_len=kv, scale=0.3).numpy(),
        zero.attention_decode(q, k, v, kv_len=kv, scale=0.3).numpy())
    qp, kp, vp = f32(1, 8, 4, 8), f32(1, 8, 2, 8), f32(1, 8, 2, 8)
    kw = dict(scale=0.3, q_offset=0, kind="causal", window=4, chunk=8)
    np.testing.assert_array_equal(
        clean.attention_prefill(qp, kp, vp, **kw).numpy(),
        zero.attention_prefill(qp, kp, vp, **kw).numpy())


# --------------------------------------------- nonzero noise, port vs ref

@pytest.mark.parametrize("level", ["nominal", "worst_case"])
@pytest.mark.parametrize("slot", ["matmul", "activation", "softmax"])
def test_noisy_backend_matches_reference(slot, level):
    rp, tp = _plans(_noisy(level, seed=3))
    assert tp.backend(slot) == rp.backend(slot)
    assert tp.backend(slot).startswith("raceit_noisy_")
    rng = np.random.default_rng(11)
    args, kw = _slot_args(rng, slot)
    want = _call_ref(rp, slot, args, kw)
    got = _call_port(tp, slot, args, kw).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    clean = _call_port(t_resolve(TCFG, port_exec_config(
        ExecConfig(mode="raceit"))), slot, args, kw).numpy()
    assert not np.array_equal(got, clean)  # the noise is there


@pytest.mark.parametrize("level", ["nominal", "worst_case"])
@pytest.mark.parametrize("name", ["gelu", "silu"])
def test_noisy_activation_of_each_function(name, level):
    rp, tp = _plans(_noisy(level, seed=1))
    x = np.random.default_rng(2).normal(0, 1.5, (3, 5, 40)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda x: rp.activation(x, name))(
        jnp.asarray(x)))
    np.testing.assert_array_equal(tp.activation(_t(x), name).numpy(), want)


@pytest.mark.parametrize("level", ["nominal", "worst_case"])
def test_noisy_int_on_resident_weights(level):
    """Resident int8 crossbar codes (``raceit_q8``) are perturbed at the
    ``matmul_resident`` site, keyed by the codes' shape alone."""
    rp, tp = _plans(_noisy(level, seed=4, stuck_rate=0.02))
    rng = np.random.default_rng(4)
    codes = rng.integers(-127, 128, (32, 24)).astype(np.int8)
    scale = rng.uniform(0.001, 0.01, (1, 24)).astype(np.float32)
    x = rng.normal(0, 1, (2, 3, 32)).astype(np.float32)
    bias = rng.normal(0, 1, (24,)).astype(np.float32)
    rw = RQW(jnp.asarray(codes), jnp.asarray(scale), (24,))
    tw = TQW(_t(codes), _t(scale), (24,))
    want = np.asarray(rp.matmul(jnp.asarray(x), rw, jnp.asarray(bias)))
    got = tp.matmul(_t(x), tw, _t(bias)).numpy()
    np.testing.assert_array_equal(got, want)
    clean = t_resolve(TCFG, port_exec_config(ExecConfig(mode="raceit")))
    assert not np.array_equal(got, clean.matmul(_t(x), tw, _t(bias)).numpy())


@pytest.mark.parametrize("mode,level", [("pot", "nominal"),
                                        ("pot_fine", "worst_case"),
                                        ("uniform", "worst_case")])
def test_noisy_attention_matrix(mode, level):
    """raceit_noisy_staged in each softmax mode, at a shared and at a
    per-row fill: the staged prefill (GQA, left-padded rows) bit for bit,
    the decode (float scores) within ATOL, on the reference's inputs (one
    jitted graph)."""
    ec = dataclasses.replace(_noisy(level, seed=5), softmax_mode=mode)
    rp, tp = _plans(ec)
    for slot in ("attention_prefill", "attention_decode"):
        assert tp.backend(slot) == rp.backend(slot) == "raceit_noisy_staged"
    rng = np.random.default_rng(len(mode))
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = f32(2, 1, 4, 8), f32(2, 16, 2, 8), f32(2, 16, 2, 8)
    qp, kp, vp = f32(2, 8, 4, 8), f32(2, 8, 2, 8), f32(2, 8, 2, 8)
    shared, rows = np.int32(16), np.asarray([12, 5], np.int32)
    pad = np.asarray([0, 3], np.int32)
    kw = dict(scale=0.3, q_offset=0, kind="causal", window=4, chunk=8)

    def ref(q, k, v, rows, qp, kp, vp, pad):
        return (rp.attention_decode(q, k, v, kv_len=shared, scale=0.3),
                rp.attention_decode(q, k, v, kv_len=rows, scale=0.3),
                rp.attention_prefill(qp, kp, vp, pad_lens=pad, **kw))
    want = [np.asarray(a) for a in jax.jit(ref)(q, k, v, rows, qp, kp, vp,
                                                pad)]
    got = [tp.attention_decode(*map(_t, (q, k, v)), kv_len=_t(n), scale=0.3)
           for n in (shared, rows)]
    got.append(tp.attention_prefill(*map(_t, (qp, kp, vp)), pad_lens=_t(pad),
                                    **kw))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    clean = t_resolve(TCFG, port_exec_config(ExecConfig(mode="raceit",
                                                        softmax_mode=mode)))
    assert not np.array_equal(got[2].numpy(), clean.attention_prefill(
        *map(_t, (qp, kp, vp)), pad_lens=_t(pad), **kw).numpy())


def test_prefill_past_the_key_limit_is_digital_and_fault_free():
    """Beyond RACEIT_ATTENTION_MAX_KEYS the noisy prefill serves the
    digital path, and that fallback injects no faults."""
    from repro_torch.exec.backends import RACEIT_ATTENTION_MAX_KEYS
    rp, tp = _plans(_noisy("worst_case", fault_rate=1.0))
    dig = t_resolve(TCFG, port_exec_config(ExecConfig(mode="digital")))
    sk = RACEIT_ATTENTION_MAX_KEYS + 8
    rng = np.random.default_rng(6)
    q = _t(rng.standard_normal((1, 2, 2, 4)).astype(np.float32))
    k = _t(rng.standard_normal((1, sk, 2, 4)).astype(np.float32))
    kw = dict(scale=0.5, q_offset=sk - 2, kind="causal", window=4, chunk=512)
    got = tp.attention_prefill(q, k, k, **kw)
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(got.numpy(),
                                  dig.attention_prefill(q, k, k, **kw).numpy())


def test_row_faults_nan_exactly_the_references_rows():
    rp, tp = _plans(_noisy("worst_case", seed=0, fault_rate=0.5))
    rng = np.random.default_rng(7)
    args, kw = _slot_args(rng, "attention_decode")
    q = rng.standard_normal((4, 1, 4, 8)).astype(np.float32)
    k = rng.standard_normal((4, 16, 2, 8)).astype(np.float32)
    kw = dict(kw, kv_len=np.int32(10))
    want = _call_ref(rp, "attention_decode", (q, k, k), kw)
    got = _call_port(tp, "attention_decode", (q, k, k), kw).numpy()
    dead = np.isnan(want).all(axis=(1, 2, 3))
    assert dead.any() and not dead.all()
    np.testing.assert_array_equal(np.isnan(got).all(axis=(1, 2, 3)), dead)
    assert np.isfinite(got[~dead]).all()
    np.testing.assert_allclose(got[~dead], want[~dead], rtol=0, atol=ATOL)


# ------------------------------------------------------------------ plans

def test_noisy_outputs_reproducible_and_seed_dependent():
    _, pA = _plans(_noisy("nominal", seed=0))
    _, pB = _plans(_noisy("nominal", seed=1))
    _, p0 = _plans(ExecConfig(mode="raceit"))
    rng = np.random.default_rng(8)
    x = _t(rng.standard_normal((2, 16)).astype(np.float32))
    w = _t(rng.standard_normal((16, 8)).astype(np.float32))
    y1 = pA.matmul(x, w, None).numpy()
    np.testing.assert_array_equal(y1, pA.matmul(x, w, None).numpy())
    assert not np.array_equal(y1, pB.matmul(x, w, None).numpy())
    assert not np.array_equal(y1, p0.matmul(x, w, None).numpy())
    lg = _t(2.0 * rng.standard_normal((2, 8)).astype(np.float32))
    np.testing.assert_array_equal(pA.softmax(lg, -1).numpy(),
                                  pA.softmax(lg, -1).numpy())


def test_noise_participates_in_plan_cache_key():
    from repro_torch.configs.base import ExecConfig as TExec
    from repro_torch.hw.noise import NoiseConfig as TNoise
    p_clean = t_resolve(TCFG, TExec(mode="raceit"))
    p_zero = t_resolve(TCFG, TExec(mode="raceit", noise=TNoise()))
    p_seed1 = t_resolve(TCFG, TExec(mode="raceit", noise=TNoise(seed=1)))
    assert p_clean is not p_zero and p_zero is not p_seed1
    assert p_clean.backend("softmax") == "raceit_acam"
    assert p_zero.backend("softmax") == "raceit_noisy_acam"
    assert t_resolve(TCFG, TExec(mode="raceit", noise=TNoise())) is p_zero


@pytest.mark.filterwarnings(
    "ignore:fused_attention=True requested:RuntimeWarning")
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", ["gpt2-large", "command-r-35b"])
def test_explain_with_noise_matches_reference(name, fused):
    """The serving plan with noise set: the noisy names on every raceit
    slot, the fused requests degraded with the noise reason, and every line
    of ``explain()`` the reference's."""
    cfg = tiny_config(get_config(name))
    ec = ExecConfig.serving(mode="raceit", fused_attention=fused,
                            noise=NoiseConfig.preset("nominal", seed=7))
    rp = r_resolve(cfg, ec)
    tp = t_resolve(port_model_config(cfg), port_exec_config(ec))
    assert tp.explain() == rp.explain()
    for slot, backend in (("matmul", "raceit_noisy_int"),
                          ("activation", "raceit_noisy_lut"),
                          ("softmax", "raceit_noisy_acam"),
                          ("attention_prefill", "raceit_noisy_staged"),
                          ("attention_decode", "raceit_noisy_staged")):
        assert tp.backend(slot) == rp.backend(slot) == backend
    reasons = [d.reason for d in tp.degrades if d.slot.startswith("attention")]
    assert bool(reasons) == fused
    assert all("noise" in r for r in reasons)


# ---------------------------------------------------------- lm_head q8

def test_lm_head_raceit_q8_is_registered_and_resolved():
    ec = ExecConfig(mode="raceit").with_ops(lm_head="raceit_q8")
    rp, tp = _plans(ec)
    assert rp.backend("lm_head") == "raceit_q8"
    assert tp.backend("lm_head") == "raceit_q8"
    assert tp.op("lm_head").reason is None
    assert sorted(t_list("lm_head")) == sorted(r_list("lm_head"))
    assert tp.explain() == rp.explain()


def test_lm_head_raceit_q8_backend_matches_reference():
    rp, tp = _plans(ExecConfig(mode="raceit").with_ops(lm_head="raceit_q8"))
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    want = np.asarray(rp.lm_head(jnp.asarray(x), jnp.asarray(w)))
    got = tp.lm_head(_t(x), _t(w))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    codes = rng.integers(-127, 128, (16, 40)).astype(np.int8)
    scale = rng.uniform(0.001, 0.01, (1, 40)).astype(np.float32)
    rw = RQW(jnp.asarray(codes), jnp.asarray(scale), (40,))
    tw = TQW(_t(codes), _t(scale), (40,))
    want = np.asarray(rp.lm_head(jnp.asarray(x), rw))
    np.testing.assert_array_equal(tp.lm_head(_t(x), tw).numpy(), want)


def test_lm_head_raceit_q8_logits_of_tiny_gpt2_large(monkeypatch):
    """``--mode raceit --exec-plan lm_head=raceit_q8`` on float weights:
    the unembedding is quantized through the crossbar path on both sides,
    so a prefill's logits agree within ATOL, with the same argmax (the
    port's norms pinned to the reference's values, as in
    tests/test_torch_staged.py)."""
    ec = ExecConfig(mode="raceit").with_ops(lm_head="raceit_q8")
    ref = REngine(CFG, None, ec, max_len=32)
    p0 = ref.model.init(jax.random.PRNGKey(2))
    ref.params = p0
    port = TEngine(TCFG, port_params(p0, CFG), port_exec_config(ec),
                   max_len=32, device="cpu")
    assert port.plan.backend("lm_head") == "raceit_q8"
    ref_norm = jax.jit(RL.apply_norm, static_argnums=2)

    def norm(p, x, cfg):
        y = ref_norm({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                     jnp.asarray(x.numpy()), CFG)
        return torch.from_numpy(np.array(y))
    monkeypatch.setattr(TL, "apply_norm", norm)
    prompts = np.random.default_rng(3).integers(1, 256, (2, 7)).astype(
        np.int32)
    rl, _ = ref._prefill(ref.params, jnp.asarray(prompts),
                         ref.model.init_cache(2, 32))
    tl, _ = port._prefill(port.params, torch.from_numpy(prompts).long(),
                          port.model.init_cache(2, 32))
    rl, tl = np.asarray(rl), tl.numpy()
    assert tl.shape == rl.shape and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, rl, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tl.argmax(-1), rl.argmax(-1))
    # what the override gave before the backend existed: the plan degraded
    # to the float unembedding, whose logits part from the reference's
    float_head = TEngine(TCFG, port.params, port_exec_config(
        ExecConfig(mode="raceit")), max_len=32, device="cpu")
    fl, _ = float_head._prefill(port.params,
                                torch.from_numpy(prompts).long(),
                                port.model.init_cache(2, 32))
    assert float_head.plan.backend("lm_head") == "digital"
    assert np.abs(fl.numpy() - rl).max() > 10 * ATOL
