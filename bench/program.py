"""The program's own spans and counters (`repro_torch.trace`), read from a
profiled slice that carries none of the bench's patches.

`read_program(events, snap, wall_s)` turns such a slice into the run's
``program`` entry: the slice's device busy seconds and wall; per program
span name its count, the device-idle seconds inside it (each gap counted
only for its part inside the span) and the synchronising runtime calls
inside it; each such call put down to its innermost ``rt.`` span
(``serve.readback`` by its ``site``); the top idle gaps by the innermost
``rt.`` span open on the host (``idle_by_program_span``); and the
tracer's log and counters (`repro_torch.trace.snapshot`). `events_of`
reads a ``torch.profiler`` run into the events it takes.

The five per-layer readings of that entry, each ``f(run)`` of a run
holding ``program``, None where there is nothing to read, are `METRICS`.
"""
from __future__ import annotations

import bisect
import heapq

RT = "rt."
SKIP = ("rt.", "bench.")  # annotations: on the device timeline, not work
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})
OUTSIDE = "outside the program's spans"


def events_of(prof) -> list:
    """(name, start µs, end µs, on_device) of every event of a
    ``torch.profiler`` run."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.start, e.time_range.end,
             e.device_type == DeviceType.CUDA) for e in prof.events()]


def _busy(dev: list) -> tuple:
    """(busy µs, idle gaps [(start, end)]) of the device intervals."""
    dev.sort()
    busy, gaps, cur = 0.0, [], None
    for s, t in dev:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], s))
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy, gaps


def _innermost(ranges: list, points: list) -> list:
    """For each point (sorted), the shortest range (start, end, name)
    holding it, or None: a sweep with a heap by length, ranges that ended
    dropped when they reach the top."""
    ranges = sorted(ranges)
    out, heap, i = [], [], 0
    for p in points:
        while i < len(ranges) and ranges[i][0] <= p:
            s, t, _ = ranges[i]
            heapq.heappush(heap, (t - s, t, i))
            i += 1
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        out.append(ranges[heap[0][2]] if heap else None)
    return out


def _ids(ranges: dict, log: list) -> dict:
    """Each profiler range's log entry, matched by order within its name
    (both are in the order the spans opened); a name whose counts differ
    is left unmatched."""
    by_name: dict = {}
    for e in log:
        by_name.setdefault(e["name"], []).append(e)
    out = {}
    for name, rs in ranges.items():
        es = sorted(by_name.get(name, []), key=lambda e: e["start_ns"])
        if len(es) == len(rs):
            for r, e in zip(sorted(rs), es):
                out[r] = e
    return out


def _label(r, entries: dict) -> str:
    e = entries.get(r)
    if r[2] == "serve.readback" and e is not None and "site" in e:
        return f"serve.readback[{e['site']}]"
    return r[2]


def read_program(events: list, snap: dict, wall_s: float) -> dict:
    """The ``program`` entry of a run from the second slice's events
    (`events_of`), the tracer's snapshot and the slice's wall seconds."""
    dev, ranges, syncs = [], {}, []
    for name, s, t, on_device in events:
        if on_device:
            if not name.startswith(SKIP) and "ProfilerStep" not in name:
                dev.append((s, t))
        elif name.startswith(RT) and name != RT + "anchor":
            short = name[len(RT):]
            ranges.setdefault(short, []).append((s, t, short))
        elif name in SYNCS:
            syncs.append(s)
    busy, gaps = _busy(dev)
    flat = [r for rs in ranges.values() for r in rs]
    entries = _ids(ranges, snap.get("spans", []))
    gap_starts = [g[0] for g in gaps]
    syncs.sort()
    count, idle, inside = {}, {}, {}
    for name, rs in ranges.items():
        count[name] = len(rs)
        tot, n = 0.0, 0
        for s, t, _ in rs:
            j = max(0, bisect.bisect_right(gap_starts, s) - 1)
            while j < len(gaps) and gaps[j][0] < t:
                tot += max(0.0, min(t, gaps[j][1]) - max(s, gaps[j][0]))
                j += 1
            n += bisect.bisect_right(syncs, t) - bisect.bisect_left(syncs, s)
        idle[name], inside[name] = tot / 1e6, n
    by_site: dict = {}
    for r in _innermost(flat, syncs):
        lab = OUTSIDE if r is None else _label(r, entries)
        by_site[lab] = by_site.get(lab, 0) + 1
    gap_idle: dict = {}
    mids = sorted(((s + t) / 2, t - s) for s, t in gaps)
    for (_, d), r in zip(mids, _innermost(flat, [m for m, _ in mids])):
        lab = OUTSIDE if r is None else r[2]
        gap_idle[lab] = gap_idle.get(lab, 0.0) + d / 1e6
    return {"busy_s": busy / 1e6, "wall_s": wall_s,
            "span_count": count, "span_idle_s": idle, "span_syncs": inside,
            "syncs": by_site,
            "idle_by_program_span": sorted(
                ([n, s] for n, s in gap_idle.items()),
                key=lambda kv: -kv[1])[:10],
            "log": snap.get("spans", []), "counters": snap.get("counters", {})}


# ------------------------------------------------------------ the metrics
def _per(run, table: str, name: str, per: str, scale: float = 1.0):
    """``scale`` x the ``table`` entry of span ``name`` over the count of
    span ``per``; None where ``per`` never ran."""
    p = run.get("program")
    n = p["span_count"].get(per, 0) if p else 0
    return scale * p[table].get(name, 0) / n if n else None


def syncs_per_step(run):
    """Synchronising runtime calls inside the program's ``serve.step``
    spans, per step."""
    return _per(run, "span_syncs", "serve.step", "serve.step")


def queue_wait_ms(run):
    """Mean host ms of ``req.queued`` over the requests whose first prefill
    work fell in the slice."""
    waits = [(e["end_ns"] - e["start_ns"]) / 1e6
             for e in (run.get("program") or {}).get("log", [])
             if e["name"] == "req.queued"]
    return sum(waits) / len(waits) if waits else None


def decode_idle_ms(run):
    """Device-idle ms inside the program's ``engine.decode`` spans, per
    decode call."""
    return _per(run, "span_idle_s", "engine.decode", "engine.decode", 1e3)


def moe_slot_fill(run):
    """Kept (token, choice) pairs over the E x C dispatch rows the expert
    products computed, over the slice's MoE calls, in %."""
    c = (run.get("program") or {}).get("counters", {})
    rows = sum(c.get("moe.rows", {}).values())
    if not rows:
        return None
    return 100.0 * sum(sum(v) for v in c["moe.kept"].values()) / rows


def optimizer_idle_ms(run):
    """Device-idle ms inside the program's ``train.optimizer`` spans, per
    train step."""
    return _per(run, "span_idle_s", "train.optimizer", "train.step", 1e3)


METRICS = {"syncs_per_step": syncs_per_step, "queue_wait_ms": queue_wait_ms,
           "decode_idle_ms": decode_idle_ms, "moe_slot_fill": moe_slot_fill,
           "optimizer_idle_ms.train": optimizer_idle_ms}
