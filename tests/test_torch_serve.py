"""The port's model stack and paged continuous batcher against the reference.

The JAX `Model.init` parameters of tiny gpt2-large (MHA, learned positions)
and tiny command-r-35b (GQA, RoPE) are carried across as numpy arrays.

* Model: resident int8 codes and scales bit-equal; `prefill_chunk` and
  `decode_step` logits on a paged slot cache within a tolerance, with the
  same argmax, in ``digital`` and in ``raceit_q8``.
* Serving: the paged ``raceit_q8`` batcher on fixed traces gives the same
  tokens, the same chunk calls and decode steps, the same block table after
  every step, and the same page, prefix-cache and router counters.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ExecConfig  # noqa: E402
from repro.models.model import quantize_model_params as r_quantize  # noqa: E402
from repro.serve import ContinuousBatcher as RBatcher  # noqa: E402
from repro.serve import GenerationEngine as REngine  # noqa: E402
from repro.serve import Request as RRequest  # noqa: E402
from repro_torch.models.model import quantize_model_params as t_quantize  # noqa: E402
from repro_torch.serve import ContinuousBatcher as TBatcher  # noqa: E402
from repro_torch.serve import GenerationEngine as TEngine  # noqa: E402
from repro_torch.serve import Request as TRequest  # noqa: E402

from _torch_helpers import (port_exec_config, port_model_config,  # noqa: E402
                            port_params)
from conftest import tiny_config  # noqa: E402

PS, N_SLOTS, N_PAGES, MAX_LEN = 8, 3, 9, 64
MODELS = ("gpt2-large", "command-r-35b")
# Logits tolerance: both stacks run float32, but LayerNorm means and
# variances and the float matmuls reduce in different orders on the two
# frameworks, so logits differ by float32 ulps (about 1e-7 here). raceit_q8
# re-rounds activations to int8 after every norm, where an ulp could move a
# code by one step at a rounding boundary; its bound leaves room for that.
ATOL = {"digital": 1e-5, "raceit_q8": 1e-4}

_ENGINES: dict = {}


def _engines(name, mode):
    """(reference engine, port engine) on the same weights, cached."""
    key = (name, mode)
    if key not in _ENGINES:
        cfg = tiny_config(get_config(name))
        ec = (ExecConfig.serving(mode="raceit") if mode == "raceit_q8"
              else ExecConfig(mode="digital", fused_attention=True))
        ref = REngine(cfg, None, ec, max_len=MAX_LEN)
        p0 = ref.model.init(jax.random.PRNGKey(0))
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


@pytest.mark.parametrize("name", MODELS)
def test_resident_codes_bit_equal(name):
    ref, port = _engines(name, "raceit_q8")
    scan = ref.params["blocks"]["scan"][0]
    for i, layer in enumerate(port.params["blocks"]):
        for group, leaves in (("attn", ("wq", "wk", "wv", "wo")),
                              ("ffn", ("w1", "w2", "w3"))):
            for leaf in leaves:
                if leaf not in scan[group]:
                    continue
                rw, tw = scan[group][leaf], layer[group][leaf]
                np.testing.assert_array_equal(tw.codes.numpy(),
                                              np.asarray(rw.codes[i]))
                np.testing.assert_array_equal(tw.scale.numpy(),
                                              np.asarray(rw.scale[i]))
                assert tw.shape == rw.shape


def _steps():
    """A chunk call (slot 0 full chunk, slot 1 partial, slot 2 idle), a
    second chunk finishing slot 0's prompt, then two decode steps."""
    rng = np.random.default_rng(1)
    bt = np.array([[3, 5, 0, 0, 0, 0, 0, 0],
                   [7, 0, 0, 0, 0, 0, 0, 0],
                   [0] * 8], np.int32)
    toks = rng.integers(0, 256, (N_SLOTS, PS)).astype(np.int32)
    toks2 = rng.integers(0, 256, (N_SLOTS, PS)).astype(np.int32)
    chunk_bt2 = bt.copy()
    chunk_bt2[1] = 0
    return [
        ("chunk", toks, np.array([0, 0, 0], np.int32),
         np.array([8, 5, 0], np.int32), bt),
        ("chunk", toks2, np.array([8, 0, 0], np.int32),
         np.array([3, 0, 0], np.int32), chunk_bt2),
        ("decode", toks[:, :1], np.array([12, 6, 0], np.int32), None, bt),
        ("decode", toks2[:, :1], np.array([13, 7, 0], np.int32), None, bt),
    ]


@pytest.mark.parametrize("mode", ["digital", "raceit_q8"])
@pytest.mark.parametrize("name", MODELS)
def test_chunk_and_decode_logits(name, mode):
    ref, port = _engines(name, mode)
    rcache = ref.model.init_slot_cache(N_SLOTS, MAX_LEN, page_size=PS,
                                       n_pages=N_PAGES)
    tcache = port.model.init_slot_cache(N_SLOTS, MAX_LEN, page_size=PS,
                                        n_pages=N_PAGES)
    t = torch.from_numpy
    for kind, toks, a, b, bt in _steps():
        if kind == "chunk":
            rl, rcache = ref._prefill_chunk(
                ref.params, jnp.asarray(toks), rcache, jnp.asarray(a),
                jnp.asarray(b), jnp.asarray(bt), PS)
            tl, tcache = port._prefill_chunk(port.params, t(toks), tcache,
                                             t(a), t(b), t(bt), PS)
            live = b > 0
        else:
            rl, rcache = ref._decode(ref.params, jnp.asarray(toks), rcache,
                                     None, None, jnp.asarray(a),
                                     jnp.asarray(bt), page_size=PS)
            tl, tcache = port._decode(port.params, t(toks), tcache, t(a),
                                      t(bt), PS)
            live = a > 0
        rl, tl = np.asarray(rl)[live], tl.numpy()[live]
        assert tl.shape == rl.shape and np.isfinite(tl).all()
        np.testing.assert_allclose(tl, rl, rtol=0, atol=ATOL[mode])
        np.testing.assert_array_equal(tl.argmax(-1), rl.argmax(-1))


def _prompt(L, cseed, shared):
    """Prompt content per (length, content seed); ``shared`` prompts are
    truncations of one 3-page prompt, so the prefix cache sees hits."""
    if shared:
        return _prompt(3 * PS, cseed, False)[:L]
    rng = np.random.default_rng(100_000 * L + cseed)
    return rng.integers(0, 255, size=L, dtype=np.int64).tolist()


def _trace(seed):
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(5):
        L = int((1, PS - 1, PS, PS + 1, 2 * PS, 3 * PS)[rng.integers(0, 6)])
        out.append((rid, _prompt(L, int(rng.integers(0, 2)),
                                 bool(rng.integers(0, 2))),
                    int(rng.integers(1, 5))))
    return out


_COUNTERS = ("requests_done", "prefills", "decode_steps", "decode_tokens",
             "tokens_out", "model_calls", "chunk_calls", "router_policy",
             "router_rejected", "queue_depths", "pages_in_use",
             "pages_shared", "pages_leaked", "pages_free",
             "pages_peak_in_use", "prefix_entries", "prefix_lookups",
             "prefix_hit_requests", "prefix_hit_pages", "prefix_miss_pages",
             "prefix_promotions", "prefix_evictions", "ttft_p50", "tpl_p50")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", MODELS)
def test_paged_serving_matches_reference(name, seed):
    ref, port = _engines(name, "raceit_q8")
    rb = RBatcher(ref, n_slots=N_SLOTS, page_size=PS, n_pages=N_PAGES)
    tb = TBatcher(port, n_slots=N_SLOTS, page_size=PS, n_pages=N_PAGES)
    for rid, prompt, n_new in _trace(seed):
        rb.submit(RRequest(rid, prompt, n_new=n_new))
        tb.submit(TRequest(rid, prompt, n_new=n_new))
    steps = 0
    while rb.queue or any(s is not None for s in rb.slots):
        assert rb.step() == tb.step()
        np.testing.assert_array_equal(tb.block_table, rb.block_table)
        steps += 1
        assert steps < 200
    assert not tb.queue and all(s is None for s in tb.slots)
    assert sorted(tb.done) == sorted(rb.done)
    for rid, req in rb.done.items():
        assert req.error is None and tb.done[rid].error is None
        assert tb.done[rid].result.tolist() == req.result.tolist(), rid
    rs, ts = rb.summary(), tb.summary()
    assert {k: ts[k] for k in _COUNTERS} == {k: rs[k] for k in _COUNTERS}


def test_launcher_serves_paged_on_request_of_cpu(capsys):
    """`python -m repro_torch.launch.serve --continuous --device cpu` at a
    tiny width: every request returns its tokens through the paged path."""
    from repro_torch.launch.serve import main
    done = main(["--arch", "gpt2-large", "--mode", "raceit_q8",
                 "--continuous", "--device", "cpu", "--requests", "3",
                 "--n-new", "3", "--page-size", "8", "--set", "n_layers=2",
                 "d_model=64", "n_heads=4", "n_kv_heads=4", "d_ff=128",
                 "vocab_size=256"])
    assert sorted(done) == [0, 1, 2]
    assert all(r.error is None and len(r.result) == 3 for r in done.values())
    assert "attention_decode  -> raceit_fused_paged" in capsys.readouterr().out
