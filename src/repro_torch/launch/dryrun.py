"""Dry-run: trace every (arch x shape x mesh) cell on ``meta``.

The port of `repro.launch.dryrun`. For each cell it says, before anything
runs on a card, whether the step fits one H100 of the production mesh
(`launch.mesh.make_production_mesh`: 256 cards as data 32 x model 8, or
two such pods) and what bounds its time, from the card's datasheet
constants:

* memory per device: parameters, optimizer state, cache and inputs by
  their shard shapes under the sharding policy, plus the step's own
  storage (its traced peak of live storage less its arguments, split over
  the devices that share one batch shard); ``fits_80GB``;
* the roofline terms: ``compute_s`` (products at the BF16 peak, int8
  products and kernel operations at the int8 peak), ``memory_s`` (the
  traced op bytes over HBM) and ``collective_s`` (the bytes reckoned on
  each mesh axis over that axis's link: NVLink for ``model``, InfiniBand
  for ``data`` and ``pod``).

The step is traced once per cell by `op_analysis.analyze_ops` on meta
tensors (nothing is allocated, no card is needed), at the batch one data
shard holds (the global batch over the data axes when they divide it, else
all of it), then split evenly over the ``model`` axis when the weights are
sharded on it (resident int8 codes replicate, as in the reference, so a
raceit_q8 step is not split), or over every device when the policy shards
the cache's sequence instead of the batch. Modes: ``digital``; ``raceit``
and ``raceit_q8`` serve through the port's fused-kernel plan
(`ExecConfig.serving`, the main path; the reference's dry-run takes the
staged plan) and train through ``ExecConfig(mode="raceit")``;
``raceit_q8`` holds resident int8 weights, so its train cells are skipped
(codes are not trained). No ``XLA_FLAGS`` are set: there is no compiler.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape decode_32k \\
      --mesh single --mode raceit_q8 --out build/dryrun.json
  python -m repro_torch.launch.dryrun --all --mode raceit_q8
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

__all__ = ["valid_cells", "run_cell", "trace_step", "main"]

TRAIN_Q8_SKIP = ("skip:raceit_q8 holds resident int8 weight codes, which "
                 "are served, not trained")


def valid_cells(arch_names=None, shape_names=None):
    """The assigned 40-cell grid, minus the reference's documented skips."""
    from ..configs import SHAPES, get_config
    from ..configs.catalog import ASSIGNED

    cells = []
    for arch in arch_names or ASSIGNED:
        cfg = get_config(arch)
        for shp in shape_names or list(SHAPES):
            shape = SHAPES[shp]
            if shape.kind == "decode" and cfg.family == "encoder":
                cells.append((arch, shp, "skip:encoder-only, no decode step"))
                continue
            if shp == "long_500k" and not cfg.supports_long_context:
                cells.append((arch, shp,
                              "skip:full-attention at 500k (DESIGN §5)"))
                continue
            cells.append((arch, shp, None))
    return cells


def _exec_config(mode: str, kind: str):
    from ..configs.base import ExecConfig
    if mode == "digital":
        return ExecConfig(mode="digital")
    if kind == "train":
        return ExecConfig(mode="raceit")
    return ExecConfig.serving(mode="raceit")


def trace_step(model, spec: dict, shape, batch: int):
    """`analyze_ops` over one step of ``model`` (on meta) at ``batch``
    rows, with ``spec``'s parameters (and optimizer state)."""
    import torch

    from ..train import optim, trainer
    from .op_analysis import analyze_ops

    cfg = model.cfg
    meta = torch.device("meta")
    S = shape.seq_len
    tokens = torch.zeros((batch, S), dtype=torch.int32, device=meta)
    enc = None
    if "enc_feats" in spec.get("batch", {}):
        enc = torch.zeros((batch,) + tuple(spec["batch"]["enc_feats"].shape[1:]),
                          dtype=torch.bfloat16, device=meta)
    if shape.kind == "train":
        step = trainer.make_train_step(model, optim.AdamWConfig(
            schedule=optim.warmup_cosine(100, 10_000)))
        data = {"tokens": tokens}
        if enc is not None:
            data["enc_feats"] = enc
        return analyze_ops(step, spec["params"], spec["opt_state"], data)[0]
    if shape.kind == "prefill":
        if cfg.family == "encoder":
            return analyze_ops(lambda p, b: model.forward(p, b,
                                                          use_remat=False),
                               spec["params"], {"tokens": tokens})[0]
        cache = model.init_cache(batch, S)
        return analyze_ops(lambda p, t, c: model.prefill(p, t, c,
                                                         enc_feats=enc),
                           spec["params"], tokens, cache)[0]
    token = torch.zeros((batch, 1), dtype=torch.int32, device=meta)
    cache = model.init_cache(batch, S)
    return analyze_ops(model.decode_step, spec["params"], token, cache)[0]


def run_cell(arch: str, shape_name: str, mesh_kind: str, mode: str = "digital",
             overrides: dict | None = None) -> dict:
    from ..configs import SHAPES, get_config
    from ..models import Model
    from . import inputs, op_analysis
    from .mesh import (AXIS_BW, HBM_BW, HBM_BYTES, PEAK_BF16_FLOPS,
                       PEAK_INT8_OPS, make_production_mesh)

    t0 = time.time()
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "mode": mode}
    if mode == "raceit_q8" and shape.kind == "train":
        return {**base, "status": "skipped", "reason": TRAIN_Q8_SKIP}
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    mshape = mesh.shape
    n_chips = math.prod(mshape.values())
    policy = inputs.make_policy(mesh, cfg, shape)
    model = Model(cfg, _exec_config(mode, shape.kind), device="meta")
    spec = inputs.input_specs(cfg, shape, policy, model,
                              quantize=(mode == "raceit_q8"))

    dp = math.prod(int(mshape[a]) for a in ("pod", "data") if a in mshape)
    B = shape.global_batch
    batch_shards = dp if B % dp == 0 else 1
    # the layers' products split over ``model`` only where their weights do
    tp = op_analysis.row_parallel_count(
        spec["param_specs"], ("wo", "w2", "out_proj")) > 0
    split = (n_chips if batch_shards == 1
             else (int(mshape["model"]) if tp else 1))
    cost = trace_step(model, spec, shape, B // batch_shards)
    t_trace = time.time() - t0

    # per-device bytes of the step's arguments, by shard shape
    def shard_bytes(values, specs):
        return inputs.tree_bytes(values, specs, mshape)
    mem = {"param_bytes": shard_bytes(spec["params"], spec["param_specs"]),
           "opt_bytes": (shard_bytes(spec["opt_state"], spec["ospecs"])
                         if "opt_state" in spec else 0),
           "cache_bytes": (shard_bytes(spec["cache"], spec["cspecs"])
                           if "cache" in spec else 0),
           "input_bytes": (shard_bytes(spec["batch"], spec["bspecs"])
                           if "batch" in spec else
                           shard_bytes(spec["token"], spec["tspec"]))}
    argument = sum(mem.values())
    temp = max(0, cost.peak_live_bytes - cost.arg_bytes) / split
    per_device = argument + temp
    mem.update(argument_bytes=argument, temp_bytes=temp,
               traced_peak_bytes=cost.peak_live_bytes,
               per_device_bytes=per_device,
               fits_80GB=bool(per_device < HBM_BYTES))

    # the activation rows one model group holds: the batch over the data
    # axes, or, where the policy shards the sequence instead, the tokens
    # split over every device outside the model axis
    groups = n_chips // int(mshape["model"])
    tokens = B * (1 if shape.kind == "decode" else shape.seq_len)
    act_rows = tokens // groups if tokens >= groups else 1
    out_rows = (act_rows if shape.kind == "train" or cfg.family == "encoder"
                else max(1, B // groups))
    op_analysis.collectives(
        cost, spec["param_specs"], mem["param_bytes"], mshape,
        act_rows=act_rows, out_rows=out_rows, d_model=cfg.d_model,
        vocab=cfg.vocab_size, act_itemsize=model.compute_dtype.itemsize,
        train=shape.kind == "train")
    flops = cost.flops / split
    int8 = cost.int8_ops / split
    compute_s = (flops - int8) / PEAK_BF16_FLOPS + int8 / PEAK_INT8_OPS
    memory_s = cost.memory_bytes / split / HBM_BW
    collective_s = sum(b / AXIS_BW[a] for a, b in
                       cost.collective_by_axis.items())
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    mf = inputs.model_flops(cfg, spec["params"], shape)
    ops = cost.to_dict()
    ops.update(flops=flops, memory_bytes=cost.memory_bytes / split,
               int8_ops=int8, traced_flops=cost.flops,
               traced_memory_bytes=cost.memory_bytes, split=split,
               trace_batch=B // batch_shards)
    return {
        **base, "status": "ok", "n_chips": n_chips,
        "trace_s": round(t_trace, 1),
        "memory": mem,
        "ops": ops,
        "model_flops_global": mf,
        "model_flops_per_chip": mf / n_chips,
        "useful_flops_ratio": (mf / n_chips) / flops if flops else None,
        "roofline": {**terms, "dominant": dominant,
                     "bound_s": max(terms.values()),
                     "roofline_fraction": (mf / n_chips / PEAK_BF16_FLOPS)
                     / max(max(terms.values()), 1e-30)},
    }


def main(argv=None):
    from . import parse_overrides

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--mode", default="digital",
                    choices=["digital", "raceit", "raceit_q8"])
    ap.add_argument("--out", default="build/dryrun.json")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (repeatable)")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.set)

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = json.loads(out_path.read_text()) if out_path.exists() else {}

    if args.all:
        cells = [(a, s, skip, m) for (a, s, skip) in valid_cells()
                 for m in ("single", "multi")]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, None, args.mesh)]

    failed = 0
    for arch, shp, skip, mesh_kind in cells:
        key = f"{arch}|{shp}|{mesh_kind}|{args.mode}"
        if key in results and results[key].get("status") in ("ok", "skipped"):
            continue
        if skip:
            results[key] = {"arch": arch, "shape": shp, "mesh": mesh_kind,
                            "status": "skipped", "reason": skip}
        else:
            print(f"=== {key}", flush=True)
            try:
                r = results[key] = run_cell(arch, shp, mesh_kind, args.mode,
                                            overrides or None)
                if r["status"] == "ok":
                    print(f"    ok: trace={r['trace_s']}s mem/dev="
                          f"{r['memory']['per_device_bytes'] / 1e9:.2f}GB "
                          f"fits_80GB={r['memory']['fits_80GB']} "
                          f"dominant={r['roofline']['dominant']} "
                          f"frac={r['roofline']['roofline_fraction']:.3f}",
                          flush=True)
                else:
                    print(f"    {r['status']}: {r['reason']}", flush=True)
            except Exception as e:  # noqa: BLE001 — record and continue
                failed += 1
                results[key] = {"arch": arch, "shape": shp, "mesh": mesh_kind,
                                "status": "error", "error": str(e),
                                "traceback": traceback.format_exc()[-4000:]}
                print(f"    ERROR: {e}", flush=True)
        out_path.write_text(json.dumps(results, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
