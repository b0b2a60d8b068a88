"""The second slice's reader (`bench.program`) and its five readings, on
hand-made events and on CPU profiler runs of the tiny cells; the first
slice unchanged by the program's tracer while it is off; and
`bench/program_slice.py` end to end on the CPU."""
import contextlib

import pytest

from bench import program as P

pytest.importorskip("repro_torch")

from repro_torch import trace  # noqa: E402

from . import tiny  # noqa: E402


def _run(**program):
    base = {"span_count": {}, "span_idle_s": {}, "span_syncs": {}, "log": [],
            "counters": {}}
    return {"program": {**base, **program}}


def test_readings_on_hand_made_runs():
    run = _run(span_count={"serve.step": 4, "engine.decode": 2,
                           "train.step": 3, "train.optimizer": 3},
               span_syncs={"serve.step": 14},
               span_idle_s={"engine.decode": 0.5, "train.optimizer": 0.3},
               log=[{"name": "req.queued", "start_ns": 0,
                     "end_ns": 2_000_000},
                    {"name": "req.queued", "start_ns": 5,
                     "end_ns": 4_000_005},
                    {"name": "serve.step", "start_ns": 0, "end_ns": 9}],
               counters={"moe.kept": {0: [3, 5], 1: [4, 4]},
                         "moe.rows": {0: 10, 1: 10}})
    got = {k: f(run) for k, f in P.METRICS.items()}
    assert got == pytest.approx({
        "syncs_per_step": 3.5, "queue_wait_ms": 3.0, "decode_idle_ms": 250.0,
        "moe_slot_fill": 80.0, "optimizer_idle_ms.train": 100.0})


@pytest.mark.parametrize("name", sorted(P.METRICS))
def test_readings_are_none_with_nothing_to_read(name):
    assert P.METRICS[name]({}) is None
    assert P.METRICS[name](_run()) is None


def test_optimizer_without_idle_reads_zero():
    run = _run(span_count={"train.step": 2, "train.optimizer": 2},
               span_idle_s={"train.optimizer": 0.0})
    assert P.optimizer_idle_ms(run) == 0.0


def _events():
    """A step: host spans, the device's work and annotations, two syncs.

    host  serve.step 0..100 > serve.decode 10..90 > engine.decode 10..60,
          serve.readback 70..80 (site decode)
    device kernels 0..20, 30..40, 85..95; an rt. annotation 0..100 and a
          bench. one 0..100 on the device timeline
    syncs cudaStreamSynchronize at 75 and at 95 (in serve.step alone)
    """
    return [("rt.anchor", 0, 0, False),
            ("rt.serve.step", 0, 100, False),
            ("rt.serve.decode", 10, 90, False),
            ("rt.engine.decode", 10, 60, False),
            ("rt.serve.readback", 70, 80, False),
            ("kernel_a", 0, 20, True), ("kernel_b", 30, 40, True),
            ("kernel_c", 85, 95, True),
            ("rt.serve.step", 0, 100, True), ("bench.step", 0, 100, True),
            ("ProfilerStep#1", 0, 100, True),
            ("cudaStreamSynchronize", 75, 76, False),
            ("cudaStreamSynchronize", 95, 96, False),
            ("cudaMemcpyAsync", 74, 75, False),
            ("aten::add", 12, 13, False)]


def _snap():
    def e(name, s, t, parent, **ids):
        return {"name": name, "start_ns": s, "end_ns": t, "parent": parent,
                **ids}
    return {"anchor_ns": 0, "counters": {}, "spans": [
        e("serve.step", 0, 100, -1, step=1),
        e("serve.decode", 10, 90, 0, step=1),
        e("engine.decode", 10, 60, 1, step=1),
        e("serve.readback", 70, 80, 1, step=1, site="decode")]}


def test_read_program_on_hand_made_events():
    p = P.read_program(_events(), _snap(), 2e-4)
    # the annotations are left out of busy time: 20 + 10 + 10 µs
    assert p["busy_s"] == pytest.approx(40e-6)
    assert p["span_count"] == {"serve.step": 1, "serve.decode": 1,
                               "engine.decode": 1, "serve.readback": 1}
    # gaps 20..30 and 40..85; engine.decode 10..60 holds 10 + 20 of them
    assert p["span_idle_s"]["engine.decode"] == pytest.approx(30e-6)
    assert p["span_idle_s"]["serve.step"] == pytest.approx(55e-6)
    assert p["span_idle_s"]["serve.readback"] == pytest.approx(10e-6)
    assert p["span_syncs"] == {"serve.step": 2, "serve.decode": 1,
                               "engine.decode": 0, "serve.readback": 1}
    assert p["syncs"] == {"serve.readback[decode]": 1, "serve.step": 1}
    # gap 20..30 (mid 25) lies in engine.decode, 40..85 (mid 62.5) in
    # serve.decode alone
    assert p["idle_by_program_span"] == [
        ["serve.decode", pytest.approx(45e-6)],
        ["engine.decode", pytest.approx(10e-6)]]
    assert P.syncs_per_step({"program": p}) == 2.0
    assert P.decode_idle_ms({"program": p}) == pytest.approx(0.03)


def test_gaps_outside_every_span_are_labelled_so():
    events = [("kernel_a", 0, 10, True), ("kernel_b", 50, 60, True),
              ("rt.serve.step", 40, 70, False)]
    p = P.read_program(events, {"spans": []}, 1e-4)
    assert p["idle_by_program_span"] == [[P.OUTSIDE, pytest.approx(40e-6)]]
    assert p["span_idle_s"]["serve.step"] == pytest.approx(10e-6)


def _profiled(cell, steps=4):
    """A tiny cell's loop under a CPU profiler with the tracer on: (the
    profiler's events, the snapshot, wall)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from bench import weights
    from bench.entries import serve as S
    from bench.run import context
    from bench.traffic import generate
    import torch
    ctx = context(cell, 4_000_000_007, 0, True, torch.device("cpu"),
                  overrides=tiny.TINY[cell])
    engine, batcher = S.build(ctx, weights.make(ctx.spec, ctx.seed,
                                                ctx.device))
    loop = S.ClosedLoop(batcher, generate.requests(
        ctx.mix, ctx.seed, ctx.spec["vocab_size"]), ctx.mix["clients"])
    loop.step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.tracing():
            t0 = time.perf_counter()
            for _ in range(steps):
                loop.step()
            wall = time.perf_counter() - t0
    return P.events_of(prof), trace.snapshot(), wall


@pytest.mark.parametrize("cell", ["gpt2l-long", "mixtral4-decode"])
def test_read_program_on_a_cpu_profiler_run(cell):
    events, snap, wall = _profiled(cell)
    assert any(n.startswith("rt.") for n, *_ in events)
    # the rt. ranges as the device timeline shows them too: still no work
    events += [(n, s, t, True) for n, s, t, _ in events
               if n.startswith("rt.")]
    p = P.read_program(events, snap, wall)
    assert p["busy_s"] == 0.0
    logged: dict = {}
    for e in snap["spans"]:
        if e["name"] != "req.queued":
            logged[e["name"]] = logged.get(e["name"], 0) + 1
    assert p["span_count"] == logged
    assert p["span_count"]["serve.step"] == 4
    run = {"program": p}
    assert P.syncs_per_step(run) == 0.0  # no card: nothing synchronises
    assert P.decode_idle_ms(run) == 0.0
    fill = P.moe_slot_fill(run)
    if cell == "mixtral4-decode":
        assert 0.0 < fill <= 100.0
    else:
        assert fill is None


def _slice1(cell, stub):
    """The first slice's span names, its calls' counted work and the
    spans its profile saw, with the tracer off (or stubbed out)."""
    with contextlib.ExitStack() as stack:
        if stub:
            mp = stack.enter_context(pytest.MonkeyPatch.context())
            mp.setattr(trace, "span",
                       lambda *a, **k: contextlib.nullcontext())
            for fn in ("queued", "started", "add"):
                mp.setattr(trace, fn, lambda *a, **k: None)
        _, out = tiny.run(cell, trace=True)
    t = out["trace"]
    calls = [{k: v.tolist() if hasattr(v, "tolist") else v
              for k, v in c.items()} for c in t["calls"]]
    return ([name for name, _ in t["spans"]], calls,
            sorted(t["profile"]["span_count"].items()))


@pytest.mark.parametrize("cell", ["gpt2l-long", "mixtral4-decode"])
def test_first_slice_unchanged_by_the_tracer_off(cell):
    trace.enable()  # clears the log
    trace.disable()
    off = _slice1(cell, stub=False)
    assert trace.snapshot()["spans"] == []
    assert off == _slice1(cell, stub=True)
    assert off[0] and off[1]


@pytest.mark.parametrize("cell", ["gpt2l-long", "mixtral4-decode",
                                  "gpt2l-train"])
def test_program_slice_end_to_end_on_the_cpu(cell):
    import torch

    from bench import program_slice as PS
    from bench.run import context
    ctx = context(cell, 4_000_000_007, 0, True, torch.device("cpu"),
                  overrides=tiny.TINY[cell])
    body = PS.train if cell.endswith("train") else PS.serve
    res = PS.summary(ctx, body(ctx, 5))
    assert not trace.on
    m = res["metrics"]
    want = {"gpt2l-long": ("syncs_per_step", "queue_wait_ms",
                           "decode_idle_ms"),
            "mixtral4-decode": ("syncs_per_step", "queue_wait_ms",
                                "decode_idle_ms", "moe_slot_fill"),
            "gpt2l-train": ("optimizer_idle_ms.train",)}[cell]
    assert {k for k, v in m.items() if v is not None} == set(want)
    for side in ("off", "on"):
        assert res["cost"]["step_ms"][side][1] == 5
    assert res["slice1"]["wall_s"] > 0 and res["slice2"]["wall_s"] > 0
