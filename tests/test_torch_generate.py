"""The port's solo `generate` and bucketed `BatchScheduler` against the
reference, on the contiguous KV cache.

The JAX `Model.init` parameters of tiny gpt2-large (MHA, learned positions)
and tiny command-r-35b (GQA, RoPE) are carried across as numpy arrays.

* Model: `prefill` of a left-padded batch and contiguous `decode_step`
  logits within the tolerance of tests/test_torch_serve.py, with the same
  argmax, in ``digital`` and ``raceit_q8``. In ``raceit_q8`` the port's
  norms return the reference's float values: XLA's CPU rsqrt and torch's
  differ in the last bit, and such an ulp at an int8 rounding boundary
  moves an attention row's PoT code (a few 1e-2 in the logits). The
  digital case holds the norms themselves.
* Serving: `GenerationEngine.generate` gives the reference's greedy tokens
  with and without ``pad_lens``, and with each contiguous decode backend
  pinned; `BatchScheduler.run_all` gives the
  reference's tokens and counters on a mixed-length trace, and in digital
  mode each request's tokens equal serving it solo.
* The resolved plan prints the reference's lines for every slot.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ExecConfig  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.model import quantize_model_params as r_quantize  # noqa: E402
from repro.serve import BatchScheduler as RScheduler  # noqa: E402
from repro.serve import GenerationEngine as REngine  # noqa: E402
from repro.serve import Request as RRequest  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.model import quantize_model_params as t_quantize  # noqa: E402
from repro_torch.serve import BatchScheduler as TScheduler  # noqa: E402
from repro_torch.serve import GenerationEngine as TEngine  # noqa: E402
from repro_torch.serve import Request as TRequest  # noqa: E402

from _torch_helpers import (port_exec_config, port_model_config,  # noqa: E402
                            port_params)
from conftest import tiny_config  # noqa: E402

MAX_LEN = 64
MODELS = ("gpt2-large", "command-r-35b")
# the tolerance of tests/test_torch_serve.py: float32 stacks that reduce in
# different orders differ by ulps; raceit_q8 re-rounds activations to int8
ATOL = {"digital": 1e-5, "raceit_q8": 1e-4}

_ENGINES: dict = {}


def _engines(name, mode, decode=None):
    """(reference engine, port engine) on the same weights, cached;
    ``decode`` pins the attention_decode backend."""
    key = (name, mode, decode)
    if key not in _ENGINES:
        cfg = tiny_config(get_config(name))
        pins = () if decode is None else (("attention_decode", decode),)
        ec = (ExecConfig.serving(mode="raceit", op_overrides=pins)
              if mode == "raceit_q8"
              else ExecConfig(mode="digital", fused_attention=True))
        ref = REngine(cfg, None, ec, max_len=MAX_LEN)
        p0 = ref.model.init(jax.random.PRNGKey(1))
        tparams = port_params(p0, cfg)
        if mode == "raceit_q8":
            ref.params = r_quantize(p0)
            tparams = t_quantize(tparams)
        else:
            ref.params = p0
        port = TEngine(port_model_config(cfg), tparams, port_exec_config(ec),
                       max_len=MAX_LEN, device="cpu")
        _ENGINES[key] = (ref, port)
    return _ENGINES[key]


def _bucket(seed, lens=(9, 4, 6)):
    rng = np.random.default_rng(seed)
    P = max(lens)
    prompts = np.zeros((len(lens), P), np.int32)
    pad = np.array([P - n for n in lens], np.int32)
    for i, n in enumerate(lens):
        prompts[i, P - n:] = rng.integers(1, 256, n)
    return prompts, pad


@pytest.mark.parametrize("mode", ["digital", "raceit_q8"])
@pytest.mark.parametrize("name", MODELS)
def test_prefill_and_decode_logits(name, mode, monkeypatch):
    """A left-padded batch: prefill, then two decode steps on fixed tokens."""
    ref, port = _engines(name, mode)
    if mode == "raceit_q8":
        ref_norm = jax.jit(RL.apply_norm, static_argnums=2)

        def norm(p, x, cfg):
            y = ref_norm({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                         jnp.asarray(x.numpy()), ref.cfg)
            return torch.from_numpy(np.array(y))
        monkeypatch.setattr(TL, "apply_norm", norm)
    prompts, pad = _bucket(3)
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
        np.testing.assert_allclose(tl, rl, rtol=0, atol=ATOL[mode])
        np.testing.assert_array_equal(tl.argmax(-1), rl.argmax(-1))
    assert int(tcache[0]["attn"]["idx"]) == P + 2


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("mode", ["digital", "raceit_q8"])
@pytest.mark.parametrize("name", MODELS)
def test_generate_matches_reference(name, mode, padded):
    ref, port = _engines(name, mode)
    if padded:
        prompts, pad = _bucket(5, lens=(7, 3))
    else:
        prompts, pad = _bucket(5, lens=(6,))
        pad = None
    want = ref.generate(jnp.asarray(prompts), 5, pad_lens=pad)
    got = port.generate(prompts, 5, pad_lens=pad)
    assert got.dtype == want.dtype and got.shape == (len(prompts), 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("decode", ["raceit_fused", "raceit_gqa_native",
                                    "raceit_fused_rows", "raceit_gqa_rows"])
def test_pinned_contiguous_decode_backends(decode):
    """Every contiguous decode backend, pinned, gives the reference's greedy
    tokens on a left-padded command-r bucket (GQA: the flat backends repeat
    the cache codes, the native ones do not)."""
    ref, port = _engines("command-r-35b", "raceit_q8", decode)
    assert port.plan.backend("attention_decode") == decode
    prompts, pad = _bucket(8, lens=(6, 2))
    want = ref.generate(jnp.asarray(prompts), 4, pad_lens=pad)
    np.testing.assert_array_equal(port.generate(prompts, 4, pad_lens=pad),
                                  want)


def _trace():
    rng = np.random.default_rng(6)
    return [(rid, rng.integers(1, 256, int(n)).astype(np.int32), int(m))
            for rid, (n, m) in enumerate(zip((5, 9, 2, 7, 4),
                                             (3, 2, 4, 1, 3)))]


_COUNTERS = ("model_calls", "tokens_out", "decode_steps", "decode_tokens")


@pytest.mark.parametrize("name", MODELS)
def test_batch_scheduler_matches_reference(name):
    """raceit_q8 buckets of 2 over a mixed-length trace: the same tokens and
    the same counters as the reference's scheduler."""
    ref, port = _engines(name, "raceit_q8")
    rs, ts = RScheduler(ref, bucket_size=2), TScheduler(port, bucket_size=2)
    for rid, prompt, n_new in _trace():
        rs.submit(RRequest(rid, prompt, n_new=n_new))
        ts.submit(TRequest(rid, prompt, n_new=n_new))
    rdone, tdone = rs.run_all(), ts.run_all()
    assert sorted(tdone) == sorted(rdone)
    for rid in rdone:
        assert tdone[rid].result.tolist() == rdone[rid].result.tolist(), rid
    assert ({c: getattr(ts, c) for c in _COUNTERS}
            == {c: getattr(rs, c) for c in _COUNTERS})


@pytest.mark.parametrize("name", MODELS)
def test_bucket_matches_solo_digital(name):
    """Digital mode: a request's tokens in a mixed-length bucket equal
    serving it alone (pads are masked and positions pad-shifted)."""
    _, port = _engines(name, "digital")
    trace = _trace()[:3]
    solo = {rid: port.generate(p[None, :], n)[0] for rid, p, n in trace}
    sched = TScheduler(port, bucket_size=3)
    for rid, p, n in trace:
        sched.submit(TRequest(rid, p, n_new=n))
    done = sched.run_all()
    for rid, _, _ in trace:
        np.testing.assert_array_equal(done[rid].result, solo[rid])


@pytest.mark.parametrize("name", MODELS)
def test_plan_explain_matches_reference(name):
    """Line for line on every slot, the staged oracle's softmax and
    dd_matmul slots included."""
    ref, port = _engines(name, "raceit_q8")
    rlines = ref.explain_plan().splitlines()
    tlines = port.explain_plan().splitlines()
    assert tlines == rlines
    assert any("attention_prefill -> raceit_fused" in t for t in tlines)


def test_launcher_serves_bucketed_on_request_of_cpu(capsys):
    """`python -m repro_torch.launch.serve --device cpu` without
    --continuous: left-padded buckets through `BatchScheduler`."""
    from repro_torch.launch.serve import main
    done = main(["--arch", "command-r-35b", "--mode", "raceit_q8",
                 "--device", "cpu", "--requests", "5", "--n-new", "3",
                 "--slots", "2", "--set", "n_layers=2", "d_model=64",
                 "n_heads=4", "n_kv_heads=2", "head_dim=16", "d_ff=128",
                 "vocab_size=256"])
    assert sorted(done) == [0, 1, 2, 3, 4]
    assert all(r.error is None and len(r.result) == 3 for r in done.values())
    out = capsys.readouterr().out
    assert "bucketed batching on cpu" in out
    assert "attention_decode  -> raceit_gqa_paged" in out
