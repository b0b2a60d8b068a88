"""The port's staged oracle, the public kernel API's float entries, and
``--staged-attention`` serving against the reference.

* The core: `acam_softmax` in its three modes, the staged
  `raceit_attention` (with and without a mask, head dims whose square root
  is and is not a power of two), `dd_matmul_codes`, `bit_sliced_matmul` and
  `crossbar_linear`, bit for bit on the same float inputs.
* The kernel API: `raceit_linear` (exact and quantizing ADC) and
  `acam_activation` outputs, bit for bit, and `raceit_attention(fused=True)`.
* The plan: with ``fused_attention=False`` (what ``--staged-attention``
  asks for) `plan.explain()` prints the reference's table line for line.
* Serving: tiny gpt2-large and command-r-35b in raceit_q8 with staged
  attention give the reference's greedy tokens; prefill and decode logits
  agree within the tolerance of tests/test_torch_generate.py (the norms
  pinned to the reference's values, as there: XLA's CPU rsqrt and torch's
  differ in the last bit).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ExecConfig  # noqa: E402
from repro.core import attention as RA  # noqa: E402
from repro.core import crossbar as RC  # noqa: E402
from repro.core import softmax as RS  # noqa: E402
from repro.core.quant import quantize_tensor as r_quantize_tensor  # noqa: E402
from repro.kernels import ops as R  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.model import quantize_model_params as r_quantize  # noqa: E402
from repro.serve import GenerationEngine as REngine  # noqa: E402
from repro_torch.core import attention as TA  # noqa: E402
from repro_torch.core import crossbar as TC  # noqa: E402
from repro_torch.core import softmax as TS  # noqa: E402
from repro_torch.core.quant import quantize_tensor as t_quantize_tensor  # noqa: E402
from repro_torch.kernels import ops as T  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.model import quantize_model_params as t_quantize  # noqa: E402
from repro_torch.serve import GenerationEngine as TEngine  # noqa: E402

from _torch_helpers import (port_exec_config, port_model_config,  # noqa: E402
                            port_params)
from conftest import tiny_config  # noqa: E402

MODES = ("pot", "pot_fine", "uniform")
MODELS = ("gpt2-large", "command-r-35b")
MAX_LEN = 64
# tests/test_torch_generate.py's raceit_q8 tolerance: float32 stacks that
# reduce in other orders differ by ulps, re-rounded to int8 codes
ATOL = 1e-4


def _tcfg(cfg):
    return TC.CrossbarConfig(**{f: getattr(cfg, f)
                                for f in cfg.__dataclass_fields__})


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------- core

@pytest.mark.parametrize("shape", [(3, 1), (2, 5, 33), (4, 300), (2, 1100),
                                   (1, 2, 3, 64)])
@pytest.mark.parametrize("mode", MODES)
def test_acam_softmax(shape, mode):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, shape).astype(np.float32)
    x[..., 0] = -16.0  # a masked position (the LOGIT minimum)
    want = np.asarray(RS.acam_softmax(jnp.asarray(x), mode=mode))
    got = TS.acam_softmax(*_t(x), mode=mode)
    np.testing.assert_array_equal(got.numpy(), want)
    if len(shape) > 2:  # another axis: moved last and back
        want = np.asarray(RS.acam_softmax(jnp.asarray(x), axis=1, mode=mode))
        got = TS.acam_softmax(*_t(x), axis=1, mode=mode)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("mode", MODES)
def test_raceit_attention_staged(mode, d, masked):
    rng = np.random.default_rng(d + masked)
    q = rng.normal(0, 1.5, (2, 3, 9, d)).astype(np.float32)
    k = rng.normal(0, 1.0, (2, 3, 11, d)).astype(np.float32)
    v = rng.normal(0, 1.0, (2, 3, 11, d)).astype(np.float32)
    mask = (rng.random((2, 1, 9, 11)) > 0.3) if masked else None
    want = np.asarray(RA.raceit_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), softmax_mode=mode))
    got = TA.raceit_attention(*_t(q, k, v),
                              None if mask is None else _t(mask)[0],
                              softmax_mode=mode)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", MODES)
def test_raceit_attention_fused_entry(mode):
    """``fused=True`` reaches the fused kernel's float entry (whose contract
    with the staged oracle is at most 1 PROB ulp); both packages' fused
    entries agree bit for bit."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(0, 1, (1, 2, 5, 16)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(RA.raceit_attention(*map(jnp.asarray, (q, k, v)),
                                          softmax_mode=mode, fused=True))
    got = TA.raceit_attention(*_t(q, k, v), softmax_mode=mode, fused=True)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="fidelity"):
        TA.raceit_attention(*_t(q, k, v), fidelity="acam", fused=True)


def test_dd_matmul_codes():
    rng = np.random.default_rng(1)
    a = rng.integers(-128, 128, (2, 3, 5, 16)).astype(np.int8)
    b = rng.integers(-128, 128, (2, 3, 16, 7)).astype(np.int8)
    want = np.asarray(RA.dd_matmul_codes(jnp.asarray(a), jnp.asarray(b)))
    got = TA.dd_matmul_codes(*_t(a, b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    acam = TA.dd_matmul_codes(*_t(a, b), fidelity="acam")  # nibble tables
    assert acam.dtype == torch.int32
    np.testing.assert_array_equal(acam.numpy(), want)


_XBAR = [RC.CrossbarConfig(), RC.CrossbarConfig(adc_mode="quantize"),
         RC.CrossbarConfig(adc_mode="quantize", adc_bits=5, rows=64),
         RC.CrossbarConfig(adc_mode="quantize", cell_bits=3, dac_bits=2)]


@pytest.mark.parametrize("cfg", _XBAR, ids=lambda c: f"{c.adc_mode}-"
                         f"{c.adc_bits}-{c.rows}-{c.cell_bits}-{c.dac_bits}")
def test_bit_sliced_matmul_and_crossbar_linear(cfg):
    rng = np.random.default_rng(2)
    x = rng.integers(-128, 128, (6, 300)).astype(np.int32)
    w = rng.integers(-128, 128, (300, 20)).astype(np.int32)
    want = np.asarray(RC.bit_sliced_matmul(jnp.asarray(x), jnp.asarray(w),
                                           cfg))
    got = TC.bit_sliced_matmul(*_t(x, w), _tcfg(cfg))
    np.testing.assert_array_equal(got.numpy(), want)
    xf = rng.normal(0, 1, (2, 3, 300)).astype(np.float32)
    wf = rng.normal(0, 0.1, (300, 20)).astype(np.float32)
    bias = rng.normal(0, 1, (20,)).astype(np.float32)
    wq_r = r_quantize_tensor(jnp.asarray(wf), bits=8, axis=1)
    wq_t = t_quantize_tensor(*_t(wf), bits=8, axis=1)
    want = np.asarray(RC.crossbar_linear(jnp.asarray(xf), wq_r,
                                         jnp.asarray(bias), cfg))
    got = TC.crossbar_linear(*_t(xf), wq_t, *_t(bias), _tcfg(cfg))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------- kernel API

@pytest.mark.parametrize("cfg", _XBAR[:3], ids=["exact", "quantize-8",
                                                "quantize-5-rows64"])
def test_raceit_linear(cfg):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 4, 96)).astype(np.float32)
    w = rng.normal(0, 0.1, (96, 48)).astype(np.float32)
    want = np.asarray(R.raceit_linear(jnp.asarray(x), jnp.asarray(w), cfg,
                                      interpret=True))
    got = T.raceit_linear(*_t(x, w), _tcfg(cfg))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["gelu", "silu"])
def test_acam_activation(name):
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1.5, (3, 16, 70)).astype(np.float32)
    want = np.asarray(R.acam_activation(jnp.asarray(x), name, interpret=True))
    got = T.acam_activation(*_t(x), name)
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------- plan, serving

_ENGINES: dict = {}


def _engines(name):
    """(reference, port) engines in raceit_q8 with staged attention."""
    if name not in _ENGINES:
        cfg = tiny_config(get_config(name))
        ec = ExecConfig.serving(mode="raceit", fused_attention=False)
        ref = REngine(cfg, None, ec, max_len=MAX_LEN)
        p0 = ref.model.init(jax.random.PRNGKey(2))
        tparams = t_quantize(port_params(p0, cfg))
        ref.params = r_quantize(p0)
        port = TEngine(port_model_config(cfg), tparams, port_exec_config(ec),
                       max_len=MAX_LEN, device="cpu")
        _ENGINES[name] = (ref, port)
    return _ENGINES[name]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_plan_explain_matches_reference(name, fused):
    """Every line, the softmax and dd_matmul slots included."""
    from repro.exec import resolve_plan as r_resolve
    from repro_torch.exec import resolve_plan as t_resolve
    cfg = tiny_config(get_config(name))
    ec = ExecConfig.serving(mode="raceit", fused_attention=fused)
    want = r_resolve(cfg, ec).explain()
    got = t_resolve(port_model_config(cfg), port_exec_config(ec)).explain()
    assert got == want
    if not fused:
        assert "attention_prefill -> raceit_staged" in got
        assert "attention_decode  -> raceit_staged" in got
    assert "softmax           -> raceit_acam" in got
    assert "dd_matmul         -> int" in got


def _bucket(seed, lens):
    rng = np.random.default_rng(seed)
    P = max(lens)
    prompts = np.zeros((len(lens), P), np.int32)
    pad = np.array([P - n for n in lens], np.int32)
    for i, n in enumerate(lens):
        prompts[i, P - n:] = rng.integers(1, 256, n)
    return prompts, pad


@pytest.mark.parametrize("name", MODELS)
def test_staged_logits(name, monkeypatch):
    """A left-padded bucket: prefill and two decode steps, logits within the
    tolerance and the same argmax (norms pinned to the reference's)."""
    ref, port = _engines(name)
    assert port.plan.backend("attention_prefill") == "raceit_staged"
    ref_norm = jax.jit(RL.apply_norm, static_argnums=2)

    def norm(p, x, cfg):
        y = ref_norm({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                     jnp.asarray(x.numpy()), ref.cfg)
        return torch.from_numpy(np.array(y))
    monkeypatch.setattr(TL, "apply_norm", norm)
    prompts, pad = _bucket(3, (9, 4, 6))
    B, P = prompts.shape
    rcache = ref.model.init_cache(B, MAX_LEN)
    tcache = port.model.init_cache(B, MAX_LEN)
    rl, rcache = ref._prefill(ref.params, jnp.asarray(prompts), rcache,
                              pad_lens=jnp.asarray(pad))
    tl, tcache = port._prefill(port.params, torch.from_numpy(prompts).long(),
                               tcache, pad_lens=torch.from_numpy(pad))
    steps = [(np.asarray(rl), tl.numpy())]
    toks = np.random.default_rng(4).integers(1, 256, (2, B, 1)).astype(np.int32)
    for tok in toks:
        rl, rcache = ref._decode(ref.params, jnp.asarray(tok), rcache,
                                 jnp.asarray(pad), jnp.int32(P))
        tl, tcache = port._decode(port.params, torch.from_numpy(tok).long(),
                                  tcache, pad_lens=torch.from_numpy(pad),
                                  pad_prompt_len=torch.tensor(P))
        steps.append((np.asarray(rl), tl.numpy()))
    for rl, tl in steps:
        assert tl.shape == rl.shape and np.isfinite(tl).all()
        np.testing.assert_allclose(tl, rl, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(tl.argmax(-1), rl.argmax(-1))


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_staged_generate_matches_reference(name, padded):
    ref, port = _engines(name)
    prompts, pad = _bucket(5, (7, 3) if padded else (6,))
    pad = pad if padded else None
    want = ref.generate(jnp.asarray(prompts), 6, pad_lens=pad)
    got = port.generate(prompts, 6, pad_lens=pad)
    np.testing.assert_array_equal(got, want)


def test_launcher_staged_attention_on_request_of_cpu(capsys):
    from repro_torch.launch.serve import main
    done = main(["--arch", "gpt2-large", "--mode", "raceit_q8",
                 "--device", "cpu", "--staged-attention", "--requests", "3",
                 "--n-new", "3", "--slots", "2", "--set", "n_layers=2",
                 "d_model=64", "n_heads=4", "n_kv_heads=4", "d_ff=128",
                 "vocab_size=256"])
    assert sorted(done) == [0, 1, 2]
    assert all(r.error is None and len(r.result) == 3 for r in done.values())
    out = capsys.readouterr().out
    assert "attention_prefill -> raceit_staged" in out
    assert "attention_decode  -> raceit_staged" in out
