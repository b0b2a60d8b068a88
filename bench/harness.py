"""What every run shares: finding a cell's files by name, the device, the
bench's spans, reading the profiler, and printing the result.

Files are found by the names in ``BENCHMARK.json``: a cell in
``bench/workloads/<cell>.json``, its configuration in
``bench/configs/<config>.json``, its traffic mix in
``bench/traffic/<mix>.json``, each per-layer metric's reader in
``bench/metrics/<metric>.py``.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SPAN = "bench."  # the prefix of every span the bench records


def load_json(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def metric_reader(name: str):
    """The ``read(run)`` function of ``bench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a cell reports: its end-to-end ones, or with
    ``trace`` its per-layer ones."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def process_age() -> float:
    """Seconds since this process started (Linux), else since import."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        up = float(Path("/proc/uptime").read_text().split()[0])
        return up - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


_T_IMPORT = time.perf_counter()


def forbidden_loaded() -> list:
    """Top-level module names in ``sys.modules`` that a run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


# --------------------------------------------------------------- spans
class Spans:
    """The bench's spans around the calls into each layer. Off, a span is
    nothing; on (the traced slice), it is a ``record_function`` range, and
    a ``timed`` one also logs its host milliseconds on a clock synchronised
    with the card at both ends. Only the step and the model calls are
    timed: a synchronisation inside a model call would stop the host from
    running ahead of the card, and the trace would read more idle time than
    the untraced run has."""

    def __init__(self, device):
        self.device = device
        self.on = False
        self.log: list = []   # (name, host ms)

    def sync(self):
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def __call__(self, name: str, timed: bool = True):
        if not self.on:
            yield
            return
        import torch
        if not timed:
            with torch.profiler.record_function(SPAN + name):
                yield
            return
        self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(SPAN + name):
            yield
            self.sync()
        self.log.append((name, 1e3 * (time.perf_counter() - t0)))


def _launch_event(name: str) -> bool:
    return "LaunchKernel" in name or "LaunchCooperativeKernel" in name


def read_profile(prof) -> dict:
    """From a torch.profiler run: device busy seconds (the union of every
    device activity), each span's device seconds and launches, the top
    device operations and the idle gaps by the span open on the host."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    dev, spans, launches = [], [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(SPAN) and "ProfilerStep" not in e.name:
                dev.append((tr.start, tr.end, e.name))
        elif e.name.startswith(SPAN):
            d = (e.device_time_total if hasattr(e, "device_time_total")
                 else e.cuda_time_total)
            spans.append((tr.start, tr.end, e.name[len(SPAN):], d))
        elif _launch_event(e.name):
            launches.append(tr.start)
    dev.sort()
    busy, gaps, cur = 0.0, [], None
    for s, t, _ in dev:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], s))
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        busy += cur[1] - cur[0]
    by_name: dict = {}
    for s, t, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (t - s) / 1e6
    span_dev, span_n, span_launch = {}, {}, {}
    launches.sort()
    for s, t, n, d in spans:
        span_dev[n] = span_dev.get(n, 0.0) + d / 1e6
        span_n[n] = span_n.get(n, 0) + 1
        span_launch[n] = (span_launch.get(n, 0)
                          + bisect.bisect_right(launches, t)
                          - bisect.bisect_left(launches, s))

    def host_label(at):
        inner = [(t - s, n) for s, t, n, _ in spans if s <= at <= t]
        return min(inner)[1] if inner else "outside the bench's spans"

    idle: dict = {}
    for s, t in gaps:
        lab = host_label((s + t) / 2)
        idle[lab] = idle.get(lab, 0.0) + (t - s) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e6, "span_device_s": span_dev,
            "span_count": span_n, "span_launches": span_launch,
            "launches": len(launches),
            "breakdown": {
                "device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                                    key=lambda kv: -kv[1])[:10]}}


# --------------------------------------------------------------- output
def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of the
    values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    k = max(1, -(-len(v) * q // 100))
    return float(v[int(k) - 1])


def verdict(checks: dict) -> bool:
    """Every compared number at or under its limit; an unset limit or a
    missing number is no verdict of correct."""
    return bool(checks) and all(
        c["limit"] is not None and c["value"] is not None
        and c["value"] <= c["limit"] for c in checks.values())


def emit(result: dict) -> None:
    """Each compared number beside its limit as the last lines on stderr,
    then the result as the last line on stdout, its checks key last."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
