"""Serving launcher of the port, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-large \\
      --mode raceit_q8 [--continuous]

The port of `repro.launch.serve`: without ``--continuous`` requests are
served in left-padded buckets of ``--slots`` by `BatchScheduler` over
`GenerationEngine.generate` (the reference's default); with it, by the
continuous batcher, block-paged when the model qualifies, or on the
contiguous slot cache when ``--prefill-len`` pins the admission width (or
the model has no paged cache form); ``--staged-attention`` serves the
stage-by-stage oracle attention instead of the fused kernels;
``--noise PRESET|SIGMA`` (and ``--noise-seed``) serves on device-varied
arrays through the ``raceit_noisy_*`` backends; ``--mesh`` (``4``,
``model=4``, ``data=2,model=4``) places the weights on the mesh (FSDP
stripes over the data axes too when the config sets ``fsdp``) and shards
attention heads and the KV cache over the ``raceit_*_tp`` backends and
the MoE FFNs over the mesh, one
process driving every shard (``--device cpu`` puts every shard on the
CPU; on the card a mesh takes ``cuda:0 .. n-1`` and stops when the
process has fewer cards). An
encoder-decoder (whisper-tiny) serves bucketed, its decoder attending to
zero cross keys and values as the reference's launcher leaves them (no
frame embeddings are passed); the slot pools refuse it. Weights are
made from ``--seed`` at the configuration's published width unless
``--ckpt`` names a reference checkpoint directory; ``--set`` overrides
config fields (e.g. ``n_layers=2`` for a shallow run). Runs on
``--device`` (default ``cuda``; with no card it stops rather than fall
back to the CPU).
"""
from __future__ import annotations

import argparse

from . import parse_overrides


def parse_tenant_weights(pairs: list[str]) -> dict:
    """["tenant=weight", ...] -> AdmissionRouter weights dict."""
    weights = {}
    for pair in pairs:
        tenant, _, w = pair.partition("=")
        try:
            weights[tenant] = float(w)
        except ValueError:
            w = ""
        if not tenant or not w:
            raise SystemExit(f"--tenant-weights entries are tenant=weight, "
                             f"got {pair!r}")
    return weights


def parse_exec_plan(pairs: list[str]) -> tuple:
    """["slot=backend", ...] -> ExecConfig.op_overrides tuple."""
    overrides = []
    for pair in pairs:
        slot, _, backend = pair.partition("=")
        if not slot or not backend:
            raise SystemExit(f"--exec-plan entries are slot=backend, got "
                             f"{pair!r}")
        overrides.append((slot, backend))
    return tuple(overrides)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mode", default="digital",
                    choices=["digital", "raceit", "raceit_q8"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--n-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="reference checkpoint directory (leaves.npz + "
                         "meta.json), read without JAX")
    ap.add_argument("--continuous", action="store_true",
                    help="serve with the continuous batcher (default: "
                         "bucketed batching)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--prefill-len", type=int, default=None,
                    help="pin the contiguous admission-prefill width (opts "
                         "out of paged serving; prompts are then capped at "
                         "this width)")
    ap.add_argument("--router", default="fifo",
                    choices=["fifo", "priority", "wfq"])
    ap.add_argument("--tenant-weights", nargs="*", default=[],
                    metavar="TENANT=WEIGHT")
    ap.add_argument("--tenant-cap", type=int, default=None)
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=None)
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false")
    ap.add_argument("--staged-attention", action="store_true",
                    help="opt out of the fused-attention serving default "
                         "(sugar for --exec-plan attention_prefill="
                         "raceit_staged attention_decode=raceit_staged)")
    ap.add_argument("--exec-plan", nargs="*", default=[],
                    metavar="SLOT=BACKEND")
    ap.add_argument("--noise", default=None, metavar="PRESET|SIGMA",
                    help="serve on device-varied analog arrays: a "
                         "repro_torch.hw.noise preset (clean/nominal/"
                         "worst_case) or a float scale of the nominal "
                         "profile; routes the raceit slots to the "
                         "raceit_noisy_* backends (fused kernels degrade, "
                         "reason in the plan table)")
    ap.add_argument("--noise-seed", type=int, default=0,
                    help="device-variation seed (--noise); one seed = one "
                         "simulated chip, reproducibly")
    ap.add_argument("--mesh", default=None, metavar="AXES",
                    help="serve on a device mesh: '4' / 'model=4' / "
                         "'data=2,model=4' (repro_torch.dist.MeshSpec "
                         "syntax). A 'model' axis shards attention heads "
                         "and the KV cache over the raceit_*_tp backends "
                         "and the MoE FFNs over the mesh; params load "
                         "under FSDP specs when the config sets fsdp=True "
                         "(the data axes stripe the weights too). On "
                         "--device cpu every shard runs on the CPU")
    ap.add_argument("--set", nargs="*", default=[])
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ExecConfig
    from repro_torch.models import Model, quantize_model_params
    from repro_torch.serve import (BatchScheduler, ContinuousBatcher,
                                   GenerationEngine, Request)

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
    torch.backends.cudnn.allow_tf32 = False
    mesh = None
    if args.mesh is not None:
        from repro_torch.dist import MeshSpec
        mesh = MeshSpec.parse(args.mesh)
        mesh.build(kind=device.type)  # before the weights: fail fast
        print(f"[serve] device mesh: {mesh.describe()} "
              f"({mesh.n_devices} devices)")
    cfg = get_config(args.arch).replace(
        param_dtype="float32", compute_dtype="float32",
        **parse_overrides(args.set))
    if args.ckpt:
        from repro_torch.ckpt import load_reference_checkpoint
        params = load_reference_checkpoint(args.ckpt, cfg, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = Model(cfg, device=device).init(gen)
    noise = None
    if args.noise is not None:
        from repro_torch.hw.noise import NoiseConfig
        noise = NoiseConfig.parse(args.noise, seed=args.noise_seed)
        print(f"[serve] device noise: {noise}")
    exec_cfg = ExecConfig.serving(
        mode="raceit" if args.mode.startswith("raceit") else "digital",
        fused_attention=not args.staged_attention,
        op_overrides=parse_exec_plan(args.exec_plan), noise=noise, mesh=mesh)
    if args.mode == "raceit_q8":
        params = quantize_model_params(params)
        print("[serve] weights quantized to resident int8 crossbar codes")
    eng = GenerationEngine(cfg, params, exec_cfg=exec_cfg,
                           max_len=args.max_len, device=device)
    print("[serve] resolved execution plan:")
    print("\n".join("  " + line for line in eng.explain_plan().splitlines()))
    weights = parse_tenant_weights(args.tenant_weights)
    if args.continuous:
        sched = ContinuousBatcher(eng, n_slots=args.slots,
                                  prefill_len=args.prefill_len,
                                  page_size=args.page_size,
                                  prefill_chunk=args.prefill_chunk,
                                  router=args.router,
                                  tenant_weights=weights or None,
                                  tenant_cap=args.tenant_cap,
                                  prefix_cache=args.prefix_cache)
        if sched.paged:
            print(f"[serve] block-paged KV on {device}: page_size="
                  f"{sched.page_size}, prefill_chunk={sched.prefill_chunk}, "
                  f"{sched.n_pages} pages ({sched.n_pages - 1} allocatable "
                  f"+ trash); prefix cache "
                  f"{'on' if sched.prefix is not None else 'off'}")
        else:
            print(f"[serve] contiguous slot KV on {device}: {args.slots} "
                  f"slots of {args.max_len}, admission prefill width "
                  f"{args.prefill_len or 'locked at the first admission'}")
    else:
        if (args.router != "fifo" or weights or args.tenant_cap is not None
                or args.prefix_cache is not None
                or args.prefill_len is not None):
            raise SystemExit("--router/--tenant-weights/--tenant-cap/"
                             "--prefix-cache/--prefill-len belong to the "
                             "continuous batcher; add --continuous")
        sched = BatchScheduler(eng, bucket_size=args.slots)
        print(f"[serve] bucketed batching on {device}: buckets of "
              f"{args.slots}, contiguous KV of {args.max_len}")
    tenants = sorted(weights) or ["default"]
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        sched.submit(Request(rid, rng.integers(0, cfg.vocab_size,
                                               rng.integers(4, 9)).astype(np.int32),
                             n_new=args.n_new,
                             tenant=tenants[rid % len(tenants)]))
    done = sched.run_all()
    for rid in sorted(done):
        r = done[rid]
        if r.error is not None:
            print(f"[serve] req{rid}: FAILED at {r.error.stage} "
                  f"step {r.error.step}: {r.error.reason}")
        else:
            print(f"[serve] req{rid}: {r.result.tolist()}")
    occ = (sched.decode_tokens / sched.decode_steps
           if sched.decode_steps else float("nan"))
    if not args.continuous:
        print(f"[serve] bucketed: {sched.model_calls} model calls, "
              f"{sched.decode_steps} decode steps, {occ:.2f} tokens/step "
              f"occupancy")
        return done
    s = sched.summary()
    print(f"[serve] continuous: {sched.prefills} prefills, "
          f"{sched.chunk_calls} chunk calls, {sched.decode_steps} decode "
          f"steps, {occ:.2f} tokens/step occupancy")
    if sched.paged:
        print(f"[serve] pages: {s['pages_in_use']} private + "
              f"{s['pages_shared']} shared in use, {s['pages_free']} free "
              f"(peak {s['pages_peak_in_use']} of {s['pages_allocatable']})")
    return done


if __name__ == "__main__":
    main()
