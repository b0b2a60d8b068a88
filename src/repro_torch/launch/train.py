"""Training launcher of the port, on one card or a data x model mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --steps 20 --set n_layers=2 d_model=128 vocab_size=512 \\
      [--data 2 --model 2] [--device cpu]

The port of `repro.launch.train`: the configuration in float32 (``--set``
overrides fields), weights from seed 0, AdamW at lr 3e-4 with a 20-step
warm-up and a cosine to ``--steps``, `SyntheticLM` batches of ``--batch``
x ``--seq`` tokens (stream seed 0), and `run_training` with a checkpoint
every max(10, steps // 4) steps under ``--ckpt-dir``, which a second run
resumes. Runs on ``--device`` (default ``cuda``; with no card it stops
rather than fall back to the CPU).

``--data D --model M`` above 1 builds the ``data x model`` mesh (the
reference's ``make_host_mesh(data, model)``) over the run's devices:
``cuda:0 .. D*M-1`` on the card, stopping when the process has fewer
cards; every position ``cpu`` with ``--device cpu``. The weights are
placed on it under `param_specs` (with the FSDP axis map when the config
sets ``fsdp``), AdamW's moments live with their stripes, each step splits
the batch over the ``data`` replicas and, with ``--model`` above 1, each
replica's products over its ``model`` positions: heads, FFN columns,
vocab rows, sequence shards and SSM heads or chunks, the reference's
`use_policy` partitioning (`train.trainer.make_train_step`,
`repro_torch.dist.tp`). Checkpoints hold whole leaves, so a run resumes
on any mesh.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from . import parse_overrides


def train(arch: str, steps: int = 100, batch: int = 8, seq: int = 256,
          data: int = 1, model: int = 1, ckpt_dir: str | None = None,
          overrides: dict | None = None, device=None, log=print, mesh=None):
    """Train ``arch`` as the launcher does; returns (params, opt_state,
    run_training's record). ``mesh``: an already built mesh (say, every
    position on one card: ``make_host_mesh(2, 2, devices=["cuda:0"] *
    4)``), in place of the ``data`` x ``model`` one."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import place_model_params, replica_devices
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.train import TrainLoopConfig, optim, run_training, trainer

    device = resolve_device(device)
    if mesh is None and data * model > 1:
        mesh = make_host_mesh(data=data, model=model, kind=device.type)
    if mesh is not None:  # the loss lands on replica 0's model position 0
        replicas = replica_devices(mesh)
        if batch % len(replicas):
            raise ValueError(f"a batch of {batch} rows does not split over "
                             f"{len(replicas)} data replicas")
        device = replicas[0]
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch).replace(param_dtype="float32",
                                   compute_dtype="float32",
                                   **(overrides or {}))
    net = Model(cfg, device=device)
    params = net.init(torch.Generator(device=device).manual_seed(0))
    if mesh is not None:
        params = place_model_params(params, cfg, mesh)
    opt_state = optim.adamw_init(params)
    step = trainer.make_train_step(net, optim.AdamWConfig(
        lr=3e-4, schedule=optim.warmup_cosine(20, steps)), mesh=mesh)
    stream = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                         global_batch=batch, seed=0)
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(),
                                        "repro_torch_launch_train")
    # hand the initial state over: held here, it would stay alive (weights
    # and moments, three times the weights' bytes) for the whole run
    state = {"params": params, "opt_state": opt_state}
    del params, opt_state
    return run_training(
        step, state.pop("params"), state.pop("opt_state"), stream,
        TrainLoopConfig(steps=steps, ckpt_dir=ckpt_dir,
                        ckpt_every=max(10, steps // 4)),
        make_batch=lambda b: {k: torch.as_tensor(v, device=device)
                              for k, v in b.items()}, log=log)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel replicas (the batch splits over "
                         "them)")
    ap.add_argument("--model", type=int, default=1,
                    help="model-axis positions: the weights stripe over "
                         "them and each computes its share of every "
                         "product")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: "
                         "repro_torch_launch_train in the temp directory)")
    ap.add_argument("--set", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, _, out = train(args.arch, steps=args.steps, batch=args.batch,
                      seq=args.seq, data=args.data, model=args.model,
                      ckpt_dir=args.ckpt_dir,
                      overrides=parse_overrides(args.set),
                      device=args.device)
    h = out["history"]
    if h:
        print(f"[train] {args.arch}: step {out['final_step']} "
              f"loss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f}")


if __name__ == "__main__":
    main()
