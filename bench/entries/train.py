"""Training cells: the port's train step (`trainer.make_train_step`, as
``launch.train`` builds it, remat on, AdamW with its warm-up and cosine),
one ``float(loss)`` a step, a fresh batch every step.

Set-up builds the step, its model and optimizer state once and drives
them from the seed through their first three steps, the ones the check
reads: each step's loss, the first gradient as the optimizer took it
(its first moment after one step over 1 - beta1) and each leaf's change
after three steps. One more step warms up; the window then runs the same
object on. After the window the program is freed and the reference
(`bench.reference.train`) runs the same three steps from the same
weights on the same batches.
"""
from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from .. import harness, weights
from ..reference import train as ref_train
from ..yardstick import cost, peaks
from .serve import port_config, profiler

CHECKED = 3


def _norms(tree) -> list:
    return [float(t.float().norm()) for _, t in ref_train.leaves(tree)]


def gaps(prog: dict, ref: dict) -> dict:
    """The compared numbers: each step's loss, the first gradient's norm
    and the change's norm, by the worst leaf against the reference's norm
    of that leaf or of the median leaf, whichever is larger. Leaves whose
    reference gradient is under a thousandth of the median leaf's are left
    out of the change (round-off moves them under AdamW)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"]))
    gr, dr = ref["grad_norms"], ref["change_norms"]
    gmed = statistics.median(gr)
    grad = max(abs(a - b) / max(b, gmed)
               for a, b in zip(prog["grad_norms"], gr))
    kept = [i for i, g in enumerate(gr) if g >= 1e-3 * gmed]
    dmed = statistics.median(dr[i] for i in kept)
    change = max(abs(prog["change_norms"][i] - dr[i]) / max(dr[i], dmed)
                 for i in kept)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "leaves_out": len(gr) - len(kept)}


def reference_side(params0, batches, tr) -> dict:
    out = ref_train.run(params0, batches, ref_train.AdamW(
        tr["lr"], tr["warmup"], tr["total_steps"]))
    p0 = [t for _, t in ref_train.leaves(params0)]
    return {"losses": out["losses"],
            "grad_norms": [float(g.norm()) for g in out["grads"]],
            "change_norms": [float((p - q).norm())
                             for p, q in zip(out["params"], p0)]}


def run(ctx) -> dict:
    from repro_torch.models import Model
    from repro_torch.train import optim, trainer
    dev, spec, tr, mix = ctx.device, ctx.spec, ctx.workload["train"], ctx.mix
    cfg = port_config(ctx.config, spec).replace(remat=tr["remat"])
    net = Model(cfg, device=dev)
    params0 = weights.make(spec, ctx.seed, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(ctx.seed) + 1)
    B, S = mix["batch"], mix["seq"]
    draw = lambda: torch.randint(0, spec["vocab_size"], (B, S), generator=gen,
                                 device=dev)
    b1 = 0.9
    opt_cfg = optim.AdamWConfig(lr=tr["lr"], b1=b1, schedule=optim.warmup_cosine(
        tr["warmup"], tr["total_steps"]))
    step = trainer.make_train_step(net, opt_cfg)
    if ctx.fault is not None:
        step = ctx.fault(step)
    state = optim.adamw_init(params0)
    params, checked, prog = params0, [], {"losses": []}
    for i in range(CHECKED + 1):
        batch = draw()
        params, state, m = step(params, state, {"tokens": batch})
        loss = float(m["loss"])
        if i < CHECKED:
            checked.append(batch)
            prog["losses"].append(loss)
        if i == 0:
            prog["grad_norms"] = [x / (1 - b1) for x in _norms(state["mu"])]
        if i == CHECKED - 1:
            prog["change_norms"] = [
                float((p.float() - q.float()).norm()) for (_, p), (_, q) in
                zip(ref_train.leaves(params), ref_train.leaves(params0))]
    spans = harness.Spans(dev)
    spans.sync()
    setup_s = harness.process_age()
    t0 = time.perf_counter()
    n = failed = 0
    prof, trace_wall = None, None
    while True:
        if ctx.trace and n == 0:
            spans.on = True
            prof = profiler(dev)
            prof.__enter__()
            tw0 = time.perf_counter()
        with spans("train_step"):
            params, state, m = step(params, state, {"tokens": draw()})
            loss = float(m["loss"])
        failed += not math.isfinite(loss)
        n += 1
        if prof is not None and trace_wall is None \
                and n == ctx.workload["trace_steps"]:
            trace_wall = time.perf_counter() - tw0
            prof.__exit__(None, None, None)
            spans.on = False
        if time.perf_counter() - t0 >= ctx.seconds and (
                prof is None or trace_wall is not None):
            break
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    del params, state, step, net, m
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_side(params0, checked, tr)
    readings, var = gaps(prog, ref), {}
    if ctx.control:  # the reference in TF32 in the program's place
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        low = reference_side(params0, checked, tr)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        var["tf32"] = {**gaps(low, ref), "sound": False}
    e2e = {"train_tokens_per_s": n * B * S / (t1 - t0), "setup_s": setup_s,
           "window_s": t1 - t0, "steps": n}
    out = {"e2e": e2e, "readings": readings, "variants": var,
           "memory_peak_bytes": peak, "attempted": n, "failed": failed}
    if prof is not None:
        out["trace"] = {"profile": harness.read_profile(prof),
                        "wall_s": trace_wall, "spans": spans.log,
                        "steps": ctx.workload["trace_steps"],
                        "step_flops": cost.train_step_flops(spec, B, S),
                        "peaks": peaks.PEAKS, "spec": spec,
                        "workload": ctx.workload}
    return out
