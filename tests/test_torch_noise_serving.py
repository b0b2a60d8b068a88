"""Serving through the port's noisy plan, with real injected faults,
against the reference's batcher on the same weights and traces.

* The reference's fault scenario (tests/test_serve_continuous.py's
  ``_faulty_engine``: digital, decode attention pinned to
  raceit_noisy_staged at worst_case with ``fault_rate`` 0.5, two slots):
  the slot the port retires is the one the reference's `fault_rows` names
  (taken from the function, never from a pinned map), errors, stages,
  tokens and counters are the reference's step by step, and the surviving
  slot's tokens are bitwise the no-fault run's. The same on the paged
  batcher, where the non-paged noisy backend gets the gathered rows.
* ``fault_rate`` 1.0 on one slot: the pool is quarantined at the first
  step and the queue drains with admit-stage errors, as in the
  reference (the real-noise twin of the NaN stand-in in
  tests/test_torch_continuous_contiguous.py).
* Tiny gpt2-large in raceit_q8 with ``nominal`` noise (the serving plan:
  every raceit slot noisy) through the paged batcher: the reference's
  greedy tokens and counters (the port's norms pinned to the reference's
  values, as in tests/test_torch_generate.py).
* The launcher's ``--noise`` and ``--noise-seed``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ExecConfig  # noqa: E402
from repro.hw.noise import NoiseConfig, fault_rows, site_key  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.model import quantize_model_params as r_quantize  # noqa: E402
from repro.serve import ContinuousBatcher as RBatcher  # noqa: E402
from repro.serve import GenerationEngine as REngine  # noqa: E402
from repro.serve import Request as RRequest  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.model import quantize_model_params as t_quantize  # noqa: E402
from repro_torch.serve import ContinuousBatcher as TBatcher  # noqa: E402
from repro_torch.serve import GenerationEngine as TEngine  # noqa: E402
from repro_torch.serve import Request as TRequest  # noqa: E402

from _torch_helpers import (port_exec_config, port_model_config,  # noqa: E402
                            port_params)
from conftest import tiny_config  # noqa: E402

MAX_LEN = 64
CFG = tiny_config(get_config("gpt2-large"))
_COUNTERS = ("requests_done", "prefills", "decode_steps", "decode_tokens",
             "tokens_out", "model_calls", "queue_depths")
_PAGED_COUNTERS = _COUNTERS + ("chunk_calls", "pages_in_use", "pages_leaked",
                               "pages_free", "pages_peak_in_use")


_PAIRS: dict = {}


def _faulty_pair(fault_rate, seed=0):
    """(reference, port) digital engines on the same weights, decode
    attention on raceit_noisy_staged at worst_case with ``fault_rate``
    (cached: a batcher never changes its engine)."""
    if (fault_rate, seed) in _PAIRS:
        return _PAIRS[fault_rate, seed]
    nz = dataclasses.replace(NoiseConfig.preset("worst_case", seed=seed),
                             fault_rate=fault_rate)
    ec = ExecConfig(mode="digital", noise=nz).with_ops(
        attention_decode="raceit_noisy_staged")
    ref = REngine(CFG, None, ec, max_len=MAX_LEN)
    ref.params = ref.model.init(jax.random.PRNGKey(0))
    port = TEngine(port_model_config(CFG), port_params(ref.params, CFG),
                   port_exec_config(ec), max_len=MAX_LEN, device="cpu")
    assert port.plan.backend("attention_decode") == "raceit_noisy_staged"
    _PAIRS[fault_rate, seed] = ref, port
    return ref, port


def _run_both(ref, port, trace, counters=_COUNTERS, **kw):
    """Both batchers on one trace, step by step: the same retirements
    every step, then the same tokens, errors and counters."""
    rb, tb = RBatcher(ref, **kw), TBatcher(port, **kw)
    assert rb.paged == tb.paged
    for rid, prompt, n_new in trace:
        rb.submit(RRequest(rid, prompt, n_new=n_new))
        tb.submit(TRequest(rid, prompt, n_new=n_new))
    steps = 0
    while rb.queue or any(s is not None for s in rb.slots):
        assert rb.step() == tb.step()
        steps += 1
        assert steps < 200
    assert not tb.queue and all(s is None for s in tb.slots)
    assert sorted(tb.done) == sorted(rb.done)
    for rid, req in rb.done.items():
        got = tb.done[rid]
        assert (req.error is None) == (got.error is None), rid
        if req.error is None:
            assert got.result.tolist() == req.result.tolist(), rid
        else:
            assert (got.error.stage, got.error.step) == (req.error.stage,
                                                         req.error.step)
    rs, ts = rb.summary(), tb.summary()
    assert {k: ts[k] for k in counters} == {k: rs[k] for k in counters}
    assert tb.dead_slots == rb.dead_slots
    return rb, tb


def _dead_slot(nz, n_slots=2):
    """The slot the reference's fault map kills (its own function)."""
    fmap = np.asarray(fault_rows(nz, site_key(nz, "decode_fault",
                                              (n_slots,)), n_slots))
    assert fmap.sum() == 1
    return int(np.flatnonzero(fmap)[0])


def _trace(seed, n, length, n_new):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, 255, length).astype(np.int32), n_new)
            for rid in range(n)]


@pytest.mark.parametrize("paged", [False, True], ids=["pool", "paged"])
def test_decode_fault_retires_the_slot_the_reference_names(paged):
    """tests/test_serve_continuous.py:259 (and test_serve_paged.py's twin)
    with real injected faults: one request ends with a structured error
    (at its first decode step; paged, at its first chunk step), its slot
    is quarantined, and the survivor's tokens are bitwise the no-fault
    run's."""
    kw = (dict(n_slots=2, page_size=8, prefix_cache=False) if paged
          else dict(n_slots=2, prefill_len=6))
    counters = _PAGED_COUNTERS if paged else _COUNTERS
    trace = _trace(7, 2, 6, 5)
    ref, port = _faulty_pair(0.5)
    rb, tb = _run_both(ref, port, trace, counters, **kw)
    dead = _dead_slot(ref.plan.exec_cfg.noise)
    assert tb.dead_slots == {dead}
    failed = [r for r in tb.done.values() if r.error is not None]
    assert len(failed) == 1 and failed[0].result is None
    # a paged chunk step runs the decode backend, so the fault lands there
    assert failed[0].error.stage == ("prefill" if paged else "decode")
    clean = TBatcher(_faulty_pair(0.0)[1], **kw)  # the port's own run
    for rid, prompt, n_new in trace:
        clean.submit(TRequest(rid, prompt, n_new=n_new))
    clean.run_all()
    assert not clean.dead_slots
    for rid, r in tb.done.items():
        if r.error is None:
            np.testing.assert_array_equal(r.result, clean.done[rid].result)


@pytest.mark.parametrize("paged", [False, True], ids=["pool", "paged"])
def test_all_slots_quarantined_drains_queue(paged):
    """tests/test_serve_continuous.py:296 with real noise at fault_rate
    1.0: the one slot dies at its first decode step (paged: its first
    chunk step) and the rest of the queue retires with admit-stage errors,
    as in the reference."""
    kw = (dict(n_slots=1, page_size=8, n_pages=1 + MAX_LEN // 8) if paged
          else dict(n_slots=1, prefill_len=5))
    ref, port = _faulty_pair(1.0, seed=1)
    rb, tb = _run_both(ref, port, _trace(8, 3, 5, 4),
                       _PAGED_COUNTERS if paged else _COUNTERS, **kw)
    assert tb.dead_slots == {0}
    assert all(tb.done[r].error is not None and tb.done[r].result is None
               for r in tb.done)
    assert [tb.done[r].error.stage for r in range(3)] == \
        ["prefill" if paged else "decode", "admit", "admit"]


@pytest.fixture
def reference_norms(monkeypatch):
    """The port's norms return the reference's jitted values."""
    ref_norm = jax.jit(RL.apply_norm, static_argnums=2)

    def norm(p, x, cfg):
        y = ref_norm({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                     jnp.asarray(x.numpy()), CFG)
        return torch.from_numpy(np.array(y))
    monkeypatch.setattr(TL, "apply_norm", norm)


@pytest.mark.filterwarnings(
    "ignore:fused_attention=True requested:RuntimeWarning")
def test_nominal_noise_paged_raceit_q8_matches_reference(reference_norms):
    """The serving plan with nominal noise: resident int8 weights perturbed
    at the crossbar, the LUT and attention softmax jittered, the chunked
    prefill and decode steps on the gathered rows; the reference's
    tokens, step by step, and counters."""
    ec = ExecConfig.serving(mode="raceit",
                            noise=NoiseConfig.preset("nominal", seed=1))
    ref = REngine(CFG, None, ec, max_len=MAX_LEN)
    p0 = ref.model.init(jax.random.PRNGKey(4))
    ref.params = r_quantize(p0)
    port = TEngine(port_model_config(CFG), t_quantize(port_params(p0, CFG)),
                   port_exec_config(ec), max_len=MAX_LEN, device="cpu")
    for slot in ("matmul", "activation", "softmax", "attention_prefill",
                 "attention_decode"):
        assert port.plan.backend(slot) == ref.plan.backend(slot)
        assert port.plan.backend(slot).startswith("raceit_noisy_")
    rng = np.random.default_rng(10)
    trace = [(rid, rng.integers(0, 255, n).astype(np.int32), m)
             for rid, (n, m) in enumerate(((7, 4), (3, 2), (12, 5), (5, 3),
                                           (9, 4)))]
    rb, tb = _run_both(ref, port, trace, _PAGED_COUNTERS, n_slots=2,
                       page_size=8)
    assert tb.paged and not tb.dead_slots
    clean = TEngine(port.cfg, port.params, port_exec_config(
        ExecConfig.serving(mode="raceit")), max_len=MAX_LEN, device="cpu")
    cb = TBatcher(clean, n_slots=2, page_size=8)
    for rid, prompt, n_new in trace:
        cb.submit(TRequest(rid, prompt, n_new=n_new))
    cb.run_all()
    assert any(cb.done[r].result.tolist() != tb.done[r].result.tolist()
               for r in tb.done)  # the devices' variation shows


def test_launcher_noise_flags(capsys):
    from repro_torch.launch.serve import main
    done = main(["--arch", "gpt2-large", "--mode", "raceit_q8",
                 "--device", "cpu", "--continuous", "--noise", "nominal",
                 "--noise-seed", "1", "--requests", "3", "--n-new", "3",
                 "--slots", "2", "--page-size", "8", "--set", "n_layers=2",
                 "d_model=64", "n_heads=4", "n_kv_heads=4", "d_ff=128",
                 "vocab_size=256"])
    assert sorted(done) == [0, 1, 2]
    assert all(r.error is None and len(r.result) == 3 for r in done.values())
    out = capsys.readouterr().out
    assert ("[serve] device noise: NoiseConfig(acam_sigma=0.5, "
            "conductance_sigma=0.01, stuck_rate=0.001, readout_sigma=0.5, "
            "fault_rate=0.0, seed=1)") in out
    for line in ("matmul            -> raceit_noisy_int",
                 "activation        -> raceit_noisy_lut",
                 "softmax           -> raceit_noisy_acam",
                 "attention_prefill -> raceit_noisy_staged",
                 "attention_decode  -> raceit_noisy_staged"):
        assert line in out
    main(["--arch", "gpt2-large", "--mode", "raceit", "--device", "cpu",
          "--noise", "2.5", "--requests", "1", "--n-new", "2", "--set",
          "n_layers=1", "d_model=32", "n_heads=2", "n_kv_heads=2",
          "d_ff=64", "vocab_size=64"])
    assert "acam_sigma=1.25" in capsys.readouterr().out
