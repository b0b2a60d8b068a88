"""Training launcher of the port, on one card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --steps 20 --set n_layers=2 d_model=128 vocab_size=512 [--device cpu]

The port of `repro.launch.train`: the configuration in float32 (``--set``
overrides fields), weights from seed 0, AdamW at lr 3e-4 with a 20-step
warm-up and a cosine to ``--steps``, `SyntheticLM` batches of ``--batch``
x ``--seq`` tokens (stream seed 0), and `run_training` with a checkpoint
every max(10, steps // 4) steps under ``--ckpt-dir``, which a second run
resumes. Runs on ``--device`` (default ``cuda``; with no card it stops
rather than fall back to the CPU). ``--data`` and ``--model`` above 1 are
refused: one process on one card cannot place shards on distinct cards.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from . import parse_overrides


def check_one_card(data: int, model: int) -> None:
    """Refuse a data or model axis above 1: one process on one card cannot
    place shards on distinct cards."""
    if data > 1 or model > 1:
        raise ValueError(
            f"--data {data} --model {model}: data- and model-parallel "
            f"training is not ported (ROADMAP.md item 11's remainder: "
            f"shards on distinct cards); train with --data 1 --model 1")


def train(arch: str, steps: int = 100, batch: int = 8, seq: int = 256,
          data: int = 1, model: int = 1, ckpt_dir: str | None = None,
          overrides: dict | None = None, device=None, log=print):
    """Train ``arch`` as the launcher does; returns (params, opt_state,
    run_training's record)."""
    check_one_card(data, model)
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model
    from repro_torch.train import TrainLoopConfig, optim, run_training, trainer

    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch).replace(param_dtype="float32",
                                   compute_dtype="float32",
                                   **(overrides or {}))
    net = Model(cfg, device=device)
    params = net.init(torch.Generator(device=device).manual_seed(0))
    opt_state = optim.adamw_init(params)
    step = trainer.make_train_step(net, optim.AdamWConfig(
        lr=3e-4, schedule=optim.warmup_cosine(20, steps)))
    stream = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                         global_batch=batch, seed=0)
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(),
                                        "repro_torch_launch_train")
    return run_training(
        step, params, opt_state, stream,
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
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: "
                         "repro_torch_launch_train in the temp directory)")
    ap.add_argument("--set", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        check_one_card(args.data, args.model)
    except ValueError as e:
        raise SystemExit(f"[train] {e}") from None
    _, _, out = train(args.arch, steps=args.steps, batch=args.batch,
                      seq=args.seq, ckpt_dir=args.ckpt_dir,
                      overrides=parse_overrides(args.set),
                      device=args.device)
    h = out["history"]
    if h:
        print(f"[train] {args.arch}: step {out['final_step']} "
              f"loss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f}")


if __name__ == "__main__":
    main()
