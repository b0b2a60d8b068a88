"""Readings for a cell's correctness limits, on the card, in one process.

    python bench/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 3]
                              [--fault <name>]

For each seed: a whole run of the cell with a short window, then the
numbers its check compares, read from the program and from each variant
of the reference in the program's place: the controls, a step down in
precision (int4 codes for the serving cells' int8, TF32 and bfloat16
experts for mixtral's float32 experts, TF32 for training's float32), and
the sound reorder (`reference.decoder`'s ``order="apart"``). Each side is
judged by `run.result`, as a benchmark run is: a control has to come out
not correct, a sound side correct. With ``--fault`` a fault of
`bench.faults` is planted under the timed path first. One JSON line a
seed on standard output. The benchmark's own runs never run a variant or
a fault.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent.parent)]

from bench import run as R  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    import torch
    from bench.faults import FAULTS
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    bench, kind = R.harness.benchmark(), torch.cuda.get_device_name(0)
    for seed in args.seeds.split(","):
        ctx = R.context(args.workload, int(seed), args.seconds, False,
                        torch.device("cuda"), control=True)
        if args.fault:
            ctx.fault = FAULTS[ctx.workload["entry"]][args.fault]
        out = R.entry(ctx).run(ctx)
        judged = {"program": R.result(bench, ctx, out, kind)["correct"]}
        for name, reading in out["variants"].items():
            res = R.result(bench, ctx, {**out, "readings": reading}, kind)
            judged[name] = res["correct"]
            reading["correct"] = res["correct"]
            if res["correct"] != reading["sound"]:
                print(f"calibrate: seed {seed}: {name} came out "
                      f"{'' if res['correct'] else 'not '}correct",
                      file=sys.stderr, flush=True)
        print(json.dumps({"seed": int(seed), "fault": args.fault,
                          "judged": judged, "readings": out["readings"],
                          "variants": out["variants"], "e2e": out["e2e"],
                          "memory_peak_bytes": out["memory_peak_bytes"]}),
              flush=True)
        del out, ctx
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
