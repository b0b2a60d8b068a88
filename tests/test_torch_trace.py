"""The port's tracer (`repro_torch.trace`) on the CPU, at a tiny size:
tiny gpt2 through the paged pool and tiny mixtral (capacity factor 1.25,
so choices drop) through the contiguous one.

* Off, it is a no-op: the same tokens bit for bit as on, an empty log
  and no ``record_function`` entered.
* On, spans nest with their parents' ids, ``req.queued`` carries its rid
  and ends where the request's first prefill work starts, the train
  step's phases sit under ``train.step``.
* The expert-load counter equals a host recount of `moe.route`'s outputs.
* The anchor maps each in-memory span onto its profiler range.
"""
import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.configs import get_config
from repro_torch.configs.base import ExecConfig
from repro_torch.models import Model, moe as moe_mod, quantize_model_params
from repro_torch.serve import ContinuousBatcher, GenerationEngine, Request
from repro_torch.train import optim, trainer

CPU = torch.device("cpu")
TINY = dict(n_layers=2, d_model=64, n_heads=4, head_dim=16, d_ff=128,
            vocab_size=256, param_dtype="float32", compute_dtype="float32")
# (arch, config keys, batcher keyword arguments)
CASES = {
    "gpt2-paged": ("gpt2-large", dict(n_kv_heads=4),
                   dict(paged=True, page_size=8, prefill_chunk=8)),
    "mixtral-contiguous": ("mixtral-8x22b",
                           dict(n_kv_heads=2, n_experts=4, top_k=2,
                                capacity_factor=1.25, window=8),
                           dict(paged=False, prefill_len=16)),
}
_ENGINES: dict = {}


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    yield
    trace.disable()


def _engine(case):
    if case not in _ENGINES:
        arch, keys, _ = CASES[case]
        cfg = get_config(arch).replace(**TINY, **keys)
        gen = torch.Generator().manual_seed(3)
        params = Model(cfg, device=CPU).init(gen)
        _ENGINES[case] = GenerationEngine(
            cfg, quantize_model_params(params),
            ExecConfig.serving(mode="raceit"), max_len=48, device=CPU)
    return _ENGINES[case]


def _serve(case, n_req=5):
    """Every request's tokens, serving ``n_req`` requests on 2 slots."""
    rng = np.random.default_rng(11)
    b = ContinuousBatcher(_engine(case), n_slots=2, **CASES[case][2])
    for rid in range(n_req):
        prompt = rng.integers(1, 256, int(rng.integers(5, 15))).astype(
            np.int32)
        b.submit(Request(rid, prompt, n_new=int(rng.integers(3, 7))))
    done = b.run_all()
    return {rid: done[rid].result.tolist() for rid in sorted(done)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_off_is_a_no_op(case, monkeypatch):
    with trace.tracing():
        on = _serve(case)
    assert trace.snapshot()["spans"]
    trace.enable()  # clears the log and the counters
    trace.disable()
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return None

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    off = _serve(case)
    assert off == on
    snap = trace.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {}
    assert entered == []


def _nesting(log):
    for i, e in enumerate(log):
        assert e["start_ns"] <= e["end_ns"]
        if e["parent"] >= 0:
            up = log[e["parent"]]
            assert e["parent"] < i
            assert up["start_ns"] <= e["start_ns"] <= e["end_ns"] \
                <= up["end_ns"]


PARENTS = {"serve.admit": {"serve.step"}, "serve.chunk": {"serve.step"},
           "serve.decode": {"serve.step"},
           "serve.readback": {"serve.admit", "serve.chunk", "serve.decode"},
           "engine.decode": {"serve.decode"},
           "engine.prefill_chunk": {"serve.chunk"},
           "engine.prefill": {"serve.admit"},
           "model.layer": {"engine.decode", "engine.prefill_chunk",
                           "engine.prefill"},
           "moe.route": {"model.layer"}, "moe.experts": {"model.layer"},
           "moe.combine": {"model.layer"}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_nest_with_their_ids(case):
    with trace.tracing():
        _serve(case)
    log = trace.snapshot()["spans"]
    _nesting(log)
    names = {e["name"] for e in log}
    for name, parents in PARENTS.items():
        for e in log:
            if e["name"] == name:
                assert log[e["parent"]]["name"] in parents, (name, e)
    steps = [e for e in log if e["name"] == "serve.step"]
    assert [e["step"] for e in steps] == list(range(1, len(steps) + 1))
    for e in log:
        if e["parent"] >= 0 and e["name"] != "req.queued":
            assert e["step"] == log[e["parent"]]["step"]
        if e["name"].startswith(("plan.", "moe.")) and any(
                log[p]["name"] == "model.layer" for p in _chain(log, e)):
            assert e["layer"] in (0, 1)
    layers = [e["layer"] for e in log if e["name"] == "model.layer"]
    assert set(layers) == {0, 1}
    sites = {e["site"] for e in log if e["name"] == "serve.readback"}
    want = {"chunk", "decode"} if "paged" in case else {"admit", "decode"}
    assert sites == want
    for e in log:
        if e["name"] == "serve.readback":
            assert log[e["parent"]]["name"] == "serve." + e["site"]
    assert ("moe.route" in names) == ("mixtral" in case)


def _chain(log, e):
    p = e["parent"]
    while p >= 0:
        yield p
        p = log[p]["parent"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_queue_wait_ends_at_the_first_prefill_work(case):
    with trace.tracing():
        _serve(case)
    log = trace.snapshot()["spans"]
    waits = {e["rid"]: e for e in log if e["name"] == "req.queued"}
    assert sorted(waits) == list(range(5))
    work = "engine.prefill_chunk" if "paged" in case else "engine.prefill"
    phase = "serve.chunk" if "paged" in case else "serve.admit"
    calls = sorted(e["start_ns"] for e in log if e["name"] == work)
    for rid, w in waits.items():
        assert w["parent"] == -1 and w["start_ns"] < w["end_ns"]
        # the first prefill call at or after the wait's end starts the
        # request's work, inside the same scheduler phase
        first = next(t for t in calls if t >= w["end_ns"])
        holder = [e for e in log if e["name"] == phase
                  and e["start_ns"] <= w["end_ns"] <= e["end_ns"]]
        assert len(holder) == 1 and first <= holder[0]["end_ns"]
    # two slots: requests 2.. wait for a slot to turn over
    assert waits[4]["end_ns"] - waits[4]["start_ns"] \
        > waits[0]["end_ns"] - waits[0]["start_ns"]


def test_expert_load_counter_matches_a_host_recount(monkeypatch):
    seen = []
    route = moe_mod.route

    def recording(*a, **kw):
        r = route(*a, **kw)
        seen.append((trace.current("layer"), r.expert.clone(),
                     r.keep.clone(), r.C))
        return r
    monkeypatch.setattr(moe_mod, "route", recording)
    with trace.tracing():
        _serve("mixtral-contiguous")
    counters = trace.snapshot()["counters"]
    E = 4
    kept, rows = {}, {}
    for layer, expert, keep, C in seen:
        n = np.bincount(expert.reshape(-1)[keep].numpy(), minlength=E)
        kept[layer] = kept.get(layer, 0) + n
        rows[layer] = rows.get(layer, 0) + E * C
    assert set(kept) == {0, 1}
    assert {k: list(v) for k, v in kept.items()} == counters["moe.kept"]
    assert rows == counters["moe.rows"]
    total = sum(sum(v) for v in counters["moe.kept"].values())
    assert 0 < total < sum(rows.values())  # capacity 1.25 drops choices


def test_host_and_device_counters_add():
    assert trace.current("layer") is None
    trace.add("x", 1)  # off: nothing
    with trace.tracing():
        trace.add("n", 2, key="a")
        trace.add("n", 3, key="a")
        trace.add("t", torch.tensor([1, 2]))
        trace.add("t", torch.tensor([3, 4]))
        with trace.span("outer", layer=7):
            with trace.span("inner"):
                assert trace.current("layer") == 7
    c = trace.snapshot()["counters"]
    assert c == {"n": {"a": 5}, "t": {None: [4, 6]}}


def test_train_step_phases_nest():
    cfg = get_config("gpt2-large").replace(**TINY, n_kv_heads=4,
                                           remat="full")
    net = Model(cfg, device=CPU)
    params = net.init(torch.Generator().manual_seed(5))
    step = trainer.make_train_step(net, optim.AdamWConfig(lr=1e-3))
    state = optim.adamw_init(params)
    batch = {"tokens": torch.randint(0, 256, (2, 16),
                                     generator=torch.Generator()
                                     .manual_seed(6))}
    _, _, m_off = step(params, state, batch)
    with trace.tracing():
        _, _, m_on = step(params, state, batch)
    assert float(m_on["loss"]) == float(m_off["loss"])
    log = trace.snapshot()["spans"]
    _nesting(log)
    top = [e for e in log if e["parent"] == -1]
    assert [e["name"] for e in top] == ["train.step"]
    assert top[0]["step"] == 1
    kids = [e["name"] for e in log if e["parent"] == 0]
    assert kids == ["train.forward", "train.backward", "train.optimizer"]


def test_anchor_maps_spans_onto_the_profiler_clock():
    """Each span's stamps, mapped through the last ``rt.anchor`` range,
    land within 50 µs of its profiler range; nine in ten of them at
    least, so that a rare preemption of the test process between a stamp
    and its range does not decide."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.tracing():
            _serve("gpt2-paged", n_req=2)
    snap = trace.snapshot()
    ranges: dict = {}
    anchors = []
    for e in prof.events():
        if e.name == "rt.anchor":
            anchors.append((e.time_range.start + e.time_range.end) / 2)
        elif e.name.startswith("rt."):
            ranges.setdefault(e.name[3:], []).append(
                (e.time_range.start, e.time_range.end))
    assert len(anchors) == 2
    offset = max(anchors) - snap["anchor_ns"] / 1e3  # µs
    by_name: dict = {}
    for e in snap["spans"]:
        if e["name"] != "req.queued":
            by_name.setdefault(e["name"], []).append(e)
    assert set(by_name) == set(ranges)
    errors = []
    for name, es in by_name.items():
        rs = sorted(ranges[name])
        assert len(rs) == len(es)
        for (s, t), e in zip(rs, es):
            errors += [abs(e["start_ns"] / 1e3 + offset - s),
                       abs(e["end_ns"] / 1e3 + offset - t)]
    assert len(errors) > 100
    assert sorted(errors)[int(0.9 * len(errors))] < 50.0
