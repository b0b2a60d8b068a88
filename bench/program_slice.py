"""The program's own spans on the card: a cell's second traced slice.

    python3 bench/program_slice.py --workload <cell> --seed <n> [--cost <steps>]

Builds and warms the cell as ``bench/run.py --trace 1`` does and runs the
same first slice (the bench's `Tracer` and synchronised spans, read by
`harness.read_profile`). Then a second slice of the same ``trace_steps``
steps runs with the bench's patches removed and the program's tracer
(`repro_torch.trace`) on, under its own profiler, read by
`bench.program.read_program`. Last, with no profiler, blocks of 5 steps
with the tracer off and on in turn, ``--cost`` steps a side: the host ms
of each decode call (serving; unsynchronised, the host's dispatch) and of
each step (training: to its ``float(loss)``).

Prints one JSON line: both slices' idle shares, `bench.program.METRICS`,
``idle_by_program_span``, the syncs by innermost span, the spans a decode
call opens and the tracer's cost. Writes nothing; the check and the
window's end-to-end metrics are `bench/run.py`'s alone.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness, program, run as R, weights  # noqa: E402

BLOCK = 5


def _slice2(dev, steps: int, once) -> dict:
    """``steps`` calls of ``once`` under a profiler with the program's
    tracer on: the run's ``program`` entry."""
    from repro_torch import trace
    from bench.entries.serve import profiler
    sync = harness.Spans(dev).sync
    gc.collect()  # the first slice's profiler events, collected before
    prof = profiler(dev)
    prof.__enter__()
    trace.enable()
    t0 = time.perf_counter()
    for _ in range(steps):
        once()
    sync()
    wall = time.perf_counter() - t0
    trace.disable()
    prof.__exit__(None, None, None)
    events = program.events_of(prof)
    out = program.read_program(events, trace.snapshot(), wall)
    calls: dict = {}
    for name, _, _, on_device in events:
        if not on_device and name.startswith("cuda"):
            calls[name] = calls.get(name, 0) + 1
    out["runtime_calls"] = calls
    return out


def _cost(steps: int, once) -> dict:
    """Host ms of each call of ``once`` with the tracer off and on, in
    blocks of `BLOCK` in turn."""
    from repro_torch import trace
    ms = {"off": [], "on": []}
    gc.collect()
    for b in range(2 * -(-steps // BLOCK)):
        side = "on" if b % 2 else "off"
        trace.enable() if side == "on" else trace.disable()
        for _ in range(BLOCK):
            t0 = time.perf_counter()
            once()
            ms[side].append(1e3 * (time.perf_counter() - t0))
    trace.disable()
    return ms


def _median(xs):
    return statistics.median(xs) if xs else None


def _under(log: list, name: str) -> float:
    """Spans opened inside each ``name`` span, on average."""
    top = [i for i, e in enumerate(log) if e["name"] == name]
    if not top:
        return None
    inside, keep = 0, set(top)
    for e in log:
        p = e.get("parent", -1)
        while p >= 0 and p not in keep:
            p = log[p]["parent"]
        inside += p >= 0
    return inside / len(top)


def serve(ctx, cost_steps: int) -> dict:
    from bench.entries import serve as S
    from bench.traffic import generate
    dev, mix = ctx.device, ctx.mix
    params = weights.make(ctx.spec, ctx.seed, dev)
    engine, batcher = S.build(ctx, params)
    stream = generate.requests(mix, ctx.seed, ctx.spec["vocab_size"])
    spans = harness.Spans(dev)
    loop = S.ClosedLoop(batcher, stream, mix["clients"])
    first, steps = list(loop.recs), 0
    while not loop.completed(first) or steps < 2:
        loop.step()
        steps += 1
    spans.sync()
    n = ctx.workload["trace_steps"]
    # the first slice, as `bench.entries.serve.run` traces it
    tracer = S.Tracer(engine, batcher, ctx.spec, spans)
    tracer.install()
    spans.on = True
    prof = S.profiler(dev)
    prof.__enter__()
    t0 = time.perf_counter()
    for _ in range(n):
        loop.step()
    spans.sync()
    wall1 = time.perf_counter() - t0
    prof.__exit__(None, None, None)
    spans.on = False
    tracer.remove()
    first = harness.read_profile(prof)
    first["wall_s"] = wall1
    del prof
    prog = _slice2(dev, n, loop.step)
    decode_ms = {"off": [], "on": []}
    orig = engine._decode

    def timed(*a, **kw):
        from repro_torch import trace
        t = time.perf_counter()
        out = orig(*a, **kw)
        decode_ms["on" if trace.on else "off"].append(
            1e3 * (time.perf_counter() - t))
        return out
    engine._decode = timed
    step_ms = _cost(cost_steps, loop.step)
    del engine._decode
    return {"first": first, "program": prog,
            "spans_per_decode": _under(prog["log"], "engine.decode"),
            "cost": {"decode_call_host_ms": decode_ms, "step_ms": step_ms}}


def train(ctx, cost_steps: int) -> dict:
    import torch
    from bench.entries.serve import port_config, profiler
    from repro_torch.models import Model
    from repro_torch.train import optim, trainer
    dev, spec, tr, mix = ctx.device, ctx.spec, ctx.workload["train"], ctx.mix
    cfg = port_config(ctx.config, spec).replace(remat=tr["remat"])
    net = Model(cfg, device=dev)
    params = weights.make(spec, ctx.seed, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(ctx.seed) + 1)
    B, S = mix["batch"], mix["seq"]
    step = trainer.make_train_step(net, optim.AdamWConfig(
        lr=tr["lr"], b1=0.9, schedule=optim.warmup_cosine(
            tr["warmup"], tr["total_steps"])))
    state = optim.adamw_init(params)
    box = {"params": params, "state": state}

    def once():
        batch = torch.randint(0, spec["vocab_size"], (B, S), generator=gen,
                              device=dev)
        box["params"], box["state"], m = step(box["params"], box["state"],
                                              {"tokens": batch})
        float(m["loss"])

    for _ in range(4):  # the entry's three checked steps and one more
        once()
    spans = harness.Spans(dev)
    spans.sync()
    n = ctx.workload["trace_steps"]
    # the first slice, as `bench.entries.train.run` traces it
    spans.on = True
    prof = profiler(dev)
    prof.__enter__()
    t0 = time.perf_counter()
    for _ in range(n):
        with spans("train_step"):
            once()
    wall1 = time.perf_counter() - t0
    prof.__exit__(None, None, None)
    spans.on = False
    first = harness.read_profile(prof)
    first["wall_s"] = wall1
    del prof
    prog = _slice2(dev, n, once)
    return {"first": first, "program": prog,
            "cost": {"step_ms": _cost(cost_steps, once)}}


def summary(ctx, out: dict) -> dict:
    """The line: readings, both slices' idle shares, the breakdown, the
    syncs and the cost's medians."""
    first, prog = out["first"], out["program"]
    run = {"program": prog}
    cost = {k: {side: [_median(v), len(v)] for side, v in sides.items()}
            for k, sides in out["cost"].items()}
    res = {"cell": ctx.workload["name"], "seed": ctx.seed,
           "metrics": {k: f(run) for k, f in program.METRICS.items()},
           "slice1": {"busy_s": first["busy_s"], "wall_s": first["wall_s"],
                      "idle_share": 1 - first["busy_s"] / first["wall_s"],
                      "idle_gaps": first["breakdown"]["idle_gaps"]},
           "slice2": {"busy_s": prog["busy_s"], "wall_s": prog["wall_s"],
                      "idle_share": 1 - prog["busy_s"] / prog["wall_s"]},
           "breakdown": {"idle_by_program_span":
                         prog["idle_by_program_span"]},
           "syncs": prog["syncs"], "span_syncs": prog["span_syncs"],
           "span_count": prog["span_count"],
           "span_idle_s": prog["span_idle_s"],
           "runtime_calls": prog["runtime_calls"], "cost": cost}
    if "spans_per_decode" in out:
        res["spans_per_decode"] = out["spans_per_decode"]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--cost", type=int, default=20,
                    help="steps a side of the tracer's cost (0: none)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("program_slice: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    ctx = R.context(args.workload, args.seed, 0, True, torch.device("cuda"))
    print(f"program_slice: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{harness.nvidia_smi()}", file=sys.stderr, flush=True)
    body = train if ctx.workload["entry"] == "train" else serve
    print(json.dumps(summary(ctx, body(ctx, args.cost))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
