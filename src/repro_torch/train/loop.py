"""Fault-tolerant outer training loop.

The port of `repro.train.loop`:

* auto-resume from the latest checkpoint (params, optimizer state and the
  data iterator's state);
* an asynchronous checkpoint every ``ckpt_every`` steps (atomic publish,
  retention), and a blocking one when the loop ends for any reason;
* preemption: SIGTERM or SIGINT ends the loop after the current step (the
  final checkpoint is then written); the previous handlers come back on
  exit;
* straggler flags: a step slower than ``straggler_factor`` times the median
  of at least 8 earlier steps is flagged (on a cluster this would feed the
  controller that evicts a slow host; here it is counted);
* a metrics CSV (step, loss, grad norm, lr, step seconds, straggler).

``float(m["loss"])`` is each step's synchronisation point, so a step's time
is its device time as well.
"""
from __future__ import annotations

import csv
import dataclasses
import math
import signal
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from ..ckpt.manager import CheckpointManager

__all__ = ["TrainLoopConfig", "run_training"]


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    metrics_path: Optional[str] = None


def run_training(train_step: Callable, params, opt_state, data_iter,
                 cfg: TrainLoopConfig, make_batch=None, log=print):
    """Run ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` to ``cfg.steps``.

    Returns (params, opt_state, {"history", "stragglers", "final_step"}).
    ``data_iter`` exposes ``next_batch()`` and, to be checkpointed,
    ``state()``/``set_state()`` (see `repro_torch.data.SyntheticLM`).
    Restored leaves land where the given ``params``/``opt_state`` live:
    placed on a mesh, a checkpoint of any mesh resumes onto theirs.
    """
    mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
    start_step = 0
    if mgr.latest_step() is not None:
        (params, opt_state), extra = mgr.restore((params, opt_state))
        start_step = int(extra.get("step", 0))
        if "data_state" in extra and hasattr(data_iter, "set_state"):
            data_iter.set_state(extra["data_state"])
        log(f"[loop] resumed from step {start_step}")

    stop = {"flag": False}

    def _handler(signum, frame):  # preemption: checkpoint and exit cleanly
        stop["flag"] = True

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, _handler)
        except ValueError:  # not the main thread
            pass

    def extra_of(step):
        return {"step": step,
                "data_state": (data_iter.state()
                               if hasattr(data_iter, "state") else {})}

    history = []
    step_times: list[float] = []
    stragglers = 0
    metrics_file = None
    writer = None
    if cfg.metrics_path:
        Path(cfg.metrics_path).parent.mkdir(parents=True, exist_ok=True)
        metrics_file = open(cfg.metrics_path, "a", newline="")
        writer = csv.writer(metrics_file)

    step = start_step
    try:
        while step < cfg.steps and not stop["flag"]:
            batch = data_iter.next_batch()
            if make_batch is not None:
                batch = make_batch(batch)
            t0 = time.perf_counter()
            params, opt_state, m = train_step(params, opt_state, batch)
            loss = float(m["loss"])  # waits for the step: its real time
            dt = time.perf_counter() - t0
            step += 1

            is_straggler = (len(step_times) >= 8 and dt > cfg.straggler_factor
                            * float(np.median(step_times)))
            stragglers += int(is_straggler)
            step_times.append(dt)
            rec = {"step": step, "loss": loss,
                   "grad_norm": float(m.get("grad_norm", math.nan)),
                   "lr": float(m.get("lr", math.nan)),
                   "step_time_s": dt, "straggler": is_straggler}
            history.append(rec)
            if writer:
                writer.writerow(list(rec.values()))
            if step % cfg.log_every == 0:
                log(f"[loop] step {step} loss {loss:.4f} ({dt*1e3:.0f} ms)"
                    + (" STRAGGLER" if is_straggler else ""))
            if step % cfg.ckpt_every == 0:
                mgr.save(step, (params, opt_state), extra=extra_of(step),
                         block=False)
    finally:
        try:
            mgr.save(step, (params, opt_state), extra=extra_of(step),
                     block=True)
        finally:
            if metrics_file:
                metrics_file.close()
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
    return params, opt_state, {"history": history, "stragglers": stragglers,
                               "final_step": step}
