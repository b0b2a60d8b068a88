"""One benchmark run of one cell on one card.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's files are found by name (`bench/harness.py`). With ``--trace
0`` the result carries the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics, read from a short profiled slice of the window.
The last line on standard output is the result; the last lines on
standard error are the numbers the correctness check compared, each with
its limit. A run without the cards its cell asks for, or one that finds
JAX or the JAX package loaded once the window has closed, exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import os
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "bench"]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
CACHE = ROOT / "build" / "bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)

from bench import harness  # noqa: E402


def context(cell: str, seed: int, seconds: float, trace: bool, device,
            control: bool = False, fault=None, overrides: dict = None):
    """Everything a cell's entry reads. ``overrides`` (tests) replaces
    entries of the model description (``model``), the cell's ``serve`` or
    ``train`` block and the traffic mix (``mix``)."""
    wl = harness.load_json("workloads", cell)
    config = harness.load_json("configs", wl["config"])
    mix = harness.load_json("traffic", wl["traffic"])
    spec = dict(config["model"])
    ov = overrides or {}
    spec.update(ov.get("model", {}))
    mix.update(ov.get("mix", {}))
    for block in ("serve", "train"):
        if block in wl:
            wl[block] = {**wl[block], **ov.get(block, {})}
    if "check" in ov:
        wl["check"] = {**wl["check"], **ov["check"]}
    return types.SimpleNamespace(
        workload=wl, config=config, mix=mix, spec=spec, seed=int(seed),
        seconds=float(seconds), trace=bool(trace), device=device,
        control=control, fault=fault)


def entry(ctx):
    import importlib
    return importlib.import_module(f"bench.entries.{ctx.workload['entry']}")


def result(bench: dict, ctx, out: dict, device_kind: str) -> dict:
    wl = ctx.workload
    metrics = {}
    for m in harness.metrics_of(bench, wl["name"], ctx.trace):
        value = (harness.metric_reader(m["name"])(out["trace"]) if ctx.trace
                 else out["e2e"].get(m["name"]))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": wl["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    res = {"correct": False, "attempted": out["attempted"],
           "failed": out["failed"], "metrics": metrics, "device": device}
    if ctx.trace:
        prof = out["trace"]["profile"]
        device.update(busy_s=prof["busy_s"], window_s=out["trace"]["wall_s"])
        res["breakdown"] = prof["breakdown"]
    checks = {k: {"value": out["readings"].get(k), "limit": lim}
              for k, lim in wl["check"]["limits"].items()}
    res["correct"] = harness.verdict(checks)
    res["checks"] = checks
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = harness.benchmark()
    import torch
    ctx = context(args.workload, args.seed, args.seconds, args.trace,
                  torch.device("cuda"))
    need = ctx.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"bench: the cell {args.workload} needs {need} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)  # the host's load: one process, one thread
    kind = torch.cuda.get_device_name(0)
    print(f"bench: device {kind}, {torch.cuda.device_count()} card(s); "
          f"nvidia-smi: {harness.nvidia_smi()}", file=sys.stderr, flush=True)
    out = entry(ctx).run(ctx)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"bench: the run loaded {bad}; no result", file=sys.stderr)
        return 1
    res = result(bench, ctx, out, kind)
    print(f"bench: readings {out['readings']}", file=sys.stderr)
    harness.emit(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
