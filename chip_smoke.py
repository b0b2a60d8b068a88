"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device   the card's name and power limit; TF32 off for matmuls and cuDNN.
2. build    the attention kernel's CUDA source with nvcc into
            build/repro_torch/, timed.
3. kernels  each kernel against its plain PyTorch version on the card, at the
            shapes the main path gives it. Times: the kernel's own device time
            (its two launches, pass A + pass B, from torch.profiler), the
            wrapper's per-call time (CUDA events around back-to-back calls,
            host work included), the plain version's device and per-call
            times, and the bound (bytes over 3.35 TB/s, int8 operations over
            1979 TOP/s). The kernels line reports the device times.
4. main     gpt2-large at its published width (36 layers, d 1280, 20 heads,
            vocab 50257, random weights from a seed, resident int8) served by
            the paged continuous batcher: 8 slots, 64-token pages and chunks,
            16 requests of 64..512 prompt tokens and 32 new tokens each. The
            attention launch count must be 2 x 36 x (chunk calls + decode
            steps): every model call went through the kernel.
   profile  the same 16 requests served again under torch.profiler: device
            time by kernel over every model call of the trace, and the
            card's idle share (1 - device busy time / wall time).
5. agree    the same path at 4 layers with the kernel swapped for its plain
            version gives the same tokens.

The line before the last is one JSON object describing every kernel; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core peak
SEED = 0


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_table(prof) -> list:
    """(name, device ms, launches) of every device activity a torch.profiler
    run recorded, largest first."""
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    rows = [(e.key, dev(e) / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and dev(e) > 0]
    return sorted(rows, key=lambda r: -r[1])


def is_attention_kernel(name: str) -> bool:
    return "pass_a" in name or "pass_b" in name


def profiled(fn, warm) -> tuple[list, float]:
    """One run of ``fn()`` under torch.profiler (CUPTI), after a warm-up step
    of the profiler itself that runs ``warm()`` and is not recorded.
    Returns (kernel_table rows, wall seconds of ``fn()``)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    rows = kernel_table(prof)
    check(bool(rows), "torch.profiler recorded no device activity")
    return rows, wall


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ----------------------------------------------------------------- phase 3

def attention_case(name, *, n_slots, gps, sq, d, page_size, max_pages, mode,
                   lens, chunk_mask=False, device="cuda", seed=SEED):
    """Int8 operands of one paged attention call at a main-path shape."""
    gen = np.random.default_rng(seed)
    n_pages = 1 + n_slots * max_pages
    G = n_slots * gps
    perm = gen.permutation(np.arange(1, n_pages))  # shuffled physical pages
    bt = np.zeros((n_slots, max_pages), np.int32)
    for s, ln in enumerate(lens):
        need = -(-ln // page_size)
        bt[s, :need] = perm[s * max_pages: s * max_pages + need]
    q = gen.integers(-128, 128, (G, sq, d), dtype=np.int8)
    k = gen.integers(-128, 128, (n_pages * gps, page_size, d), dtype=np.int8)
    v = gen.integers(-128, 128, (n_pages * gps, page_size, d), dtype=np.int8)
    # logits of a few LOGIT units: s1 ~ 4 / std(q.k)
    s1 = np.float32(4.0 / (np.sqrt(d) * 128 * 128 / 3))
    kv = np.repeat(np.asarray(lens, np.int32), gps)
    mask = None
    sk = max_pages * page_size
    if chunk_mask:  # query j of slot b attends columns <= offs[b] + j
        offs = np.maximum(np.asarray(lens) - sq, 0)
        cols = np.arange(sk)[None, None, :]
        mask = cols <= (offs[:, None, None] + np.arange(sq)[None, :, None])
        mask = torch.from_numpy(mask).to(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return dict(name=name, mode=mode, q=t(q), k=t(k), v=t(v),
                s1=torch.tensor(s1, device=device), mask=mask, kv_len=t(kv),
                bt=t(bt), page_size=page_size, gps=gps, lens=list(lens))


def attention_bound_ms(c) -> tuple[float, str]:
    """Least time for the call: every input byte read once (live pages
    only), the output written once, against the operations at int8 peak."""
    G, sq, d = c["q"].shape
    live = int(sum(c["lens"])) * c["gps"]  # live key rows over all groups
    nbytes = (c["q"].numel() + 2 * live * d + 4 * G * sq * d
              + c["bt"].numel() * 4 + c["kv_len"].numel() * 4)
    if c["mask"] is not None:
        nbytes += c["mask"].numel()
    ops = 2 * 2 * sq * live * d  # q.K and P.V, a multiply and an add each
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def check_attention_case(c):
    from repro_torch.kernels import acam_attention as A
    args = (c["q"], c["k"], c["v"], c["s1"], c["mask"])
    kw = dict(kv_len=c["kv_len"], mode=c["mode"], block_table=c["bt"],
              page_size=c["page_size"], groups_per_slot=c["gps"])
    plain = lambda: A.acam_attention_codes_plain(
        *args, torch.clamp(c["kv_len"], max=c["bt"].shape[1] * c["page_size"]),
        c["mode"], c["bt"], c["page_size"], c["gps"])
    kernel = lambda: A.acam_attention_codes(*args, **kw)
    out_k, cmax_k = kernel()
    out_p, cmax_p = plain()
    torch.cuda.synchronize()
    check(int(cmax_k) == int(cmax_p),
          f"{c['name']}: cmax {int(cmax_k)} != plain {int(cmax_p)}")
    diff = (out_k.long() - out_p.long()).abs().max().item()
    if diff:
        # the float contract: |d out| * p_scale <= PROB ulp * max|v| codes
        p_scale = float(A.requant_scale(cmax_p))
        check(diff * p_scale <= 2.0 ** -8 * 127,
              f"{c['name']}: out32 differs by {diff}")
    # the kernel's own time: the mean device time of a pass A launch plus
    # that of a pass B launch, each over the launches the profiler saw
    rows, _ = profiled(lambda: [kernel() for _ in range(20)], kernel)
    passes = [r for r in rows if is_attention_kernel(r[0])]
    check(len(passes) == 2, f"profiler saw {[r[0] for r in passes]}")
    ms = sum(r[1] / r[2] for r in passes)
    seen = sum(r[2] for r in passes)
    wrapper_ms = cuda_ms(kernel, 20)
    rows, _ = profiled(lambda: [plain() for _ in range(3)], plain)
    plain_ms = sum(r[1] for r in rows) / 3
    plain_call_ms = cuda_ms(plain, 3, warmup=1)
    bound_ms, bound_by = attention_bound_ms(c)
    return dict(max_abs_err=float(diff), ms=ms, profiled_launches=seen,
                wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, plain_call_ms=plain_call_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_kernels(device_desc: str) -> list:
    slots, mp, ps = 8, 16, 64
    gen = np.random.default_rng(SEED + 1)
    rows = []
    for mode in ("pot", "pot_fine", "uniform"):
        lens = gen.integers(1, mp * ps + 1, slots).tolist()
        gqa_lens = gen.integers(1, mp * ps + 1, slots).tolist()
        gqa_lens[3] = 0  # a zero-length slot
        chunk_lens = gen.integers(64, mp * ps + 1, slots).tolist()
        cases = [
            attention_case(f"gpt2-large decode {mode}", n_slots=slots, gps=20,
                           sq=1, d=64, page_size=ps, max_pages=mp, mode=mode,
                           lens=lens),
            attention_case(f"gpt2-large chunk {mode}", n_slots=slots, gps=20,
                           sq=64, d=64, page_size=ps, max_pages=mp, mode=mode,
                           lens=chunk_lens, chunk_mask=True),
            attention_case(f"command-r gqa decode {mode}", n_slots=slots,
                           gps=8, sq=8, d=128, page_size=ps, max_pages=mp,
                           mode=mode, lens=gqa_lens),
        ]
        for c in cases:
            r = check_attention_case(c)
            print(f"[kernels] {c['name']}: max|out - plain| = "
                  f"{r['max_abs_err']:g}, cmax equal; kernel device "
                  f"{r['ms']:.4f} ms ({r['profiled_launches']} of 40 launches "
                  f"profiled; wrapper call {r['wrapper_ms']:.4f} ms), "
                  f"plain device {r['plain_ms']:.3f} ms (call "
                  f"{r['plain_call_ms']:.3f} ms), bound "
                  f"{1e3 * r['bound_ms']:.3f} us ({r['bound_by']}); no library "
                  f"call computes this integer LUT pipeline ({device_desc})",
                  flush=True)
            rows.append(dict(case=c["name"], **r))
    return rows


# ----------------------------------------------------------------- phase 4

def build_engine(n_layers=None, device="cuda"):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ExecConfig
    from repro_torch.models import Model, quantize_model_params
    from repro_torch.serve import GenerationEngine
    cfg = get_config("gpt2-large").replace(param_dtype="float32",
                                           compute_dtype="float32")
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    model = Model(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = quantize_model_params(model.init(gen))
    return GenerationEngine(cfg, params, ExecConfig.serving(mode="raceit"),
                            max_len=1024, device=device)


def trace(cfg, n_requests=16, lo=64, hi=512, n_new=32):
    from repro_torch.serve import Request
    gen = np.random.default_rng(SEED + 2)
    return [Request(rid, gen.integers(0, cfg.vocab_size,
                                      int(gen.integers(lo, hi + 1))
                                      ).astype(np.int32), n_new=n_new)
            for rid in range(n_requests)]


def serve(eng, requests, timed=False):
    from repro_torch.serve import ContinuousBatcher
    cb = ContinuousBatcher(eng, n_slots=8, page_size=64, prefill_chunk=64)
    sync = (torch.cuda.synchronize if eng.device.type == "cuda"
            else (lambda: None))
    times = {"decode": [], "chunk": []}
    if timed:
        for kind, attr in (("decode", "_decode"), ("chunk", "_prefill_chunk")):
            inner = getattr(eng, attr)

            def wrapped(*a, _inner=inner, _kind=kind, **kw):
                sync()
                t0 = time.perf_counter()
                out = _inner(*a, **kw)
                sync()
                times[_kind].append(time.perf_counter() - t0)
                return out
            setattr(eng, attr, wrapped)
    peak_pages = 0
    for r in requests:
        cb.submit(r)
    t0 = time.perf_counter()
    try:
        while cb.queue or any(s is not None for s in cb.slots):
            cb.step()
            peak_pages = max(peak_pages, cb.allocator.pages_in_use)
        sync()
    finally:
        if timed:  # back to the engine's own methods
            del eng._decode, eng._prefill_chunk
    return cb, time.perf_counter() - t0, times, peak_pages


def phase_main(device_desc: str):
    from repro_torch.kernels import acam_attention as A
    eng = build_engine()
    cfg = eng.cfg
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab_size)
          == (36, 1280, 20, 50257), "gpt2-large is not at published width")
    print("[main] plan:\n" + eng.explain_plan(), flush=True)
    # warm-up: one short request builds the library and the allocator state
    serve(eng, trace(cfg, n_requests=1, lo=64, hi=64, n_new=2))
    torch.cuda.reset_peak_memory_stats()
    requests = trace(cfg)
    A.launches["acam_attention"] = 0
    cb, secs, times, peak_pages = serve(eng, requests, timed=True)
    launches = A.launches["acam_attention"]
    for r in requests:
        done = cb.done[r.rid]
        check(done.error is None, f"request {r.rid} failed: {done.error}")
        check(len(done.result) == r.n_new == 32,
              f"request {r.rid} returned {len(done.result)} tokens")
    calls = cb.chunk_calls + cb.decode_steps
    check(launches > 0 and launches == 2 * cfg.n_layers * calls,
          f"{launches} attention launches for {calls} model calls")
    tokens = sum(len(cb.done[r.rid].result) for r in requests)
    res = dict(tokens=tokens, seconds=secs, tokens_per_s=tokens / secs,
               decode_steps=cb.decode_steps, chunk_calls=cb.chunk_calls,
               decode_ms=1e3 * float(np.mean(times["decode"])),
               chunk_ms=1e3 * float(np.mean(times["chunk"])),
               peak_pages=peak_pages, pages=cb.n_pages - 1,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches)
    print(f"[main] gpt2-large 36L d1280 raceit_q8 paged: {tokens} tokens in "
          f"{secs:.2f} s = {res['tokens_per_s']:.1f} tok/s; "
          f"{cb.decode_steps} decode steps (mean {res['decode_ms']:.1f} ms), "
          f"{cb.chunk_calls} chunk calls (mean {res['chunk_ms']:.1f} ms); "
          f"peak pages {peak_pages}/{cb.n_pages - 1}; peak memory "
          f"{res['peak_mem_gib']:.2f} GiB; attention launches {launches} = "
          f"2 x 36 x {calls} ({device_desc})", flush=True)
    return res, eng


def phase_profile(eng, main: dict) -> dict:
    """Phase 4's trace served again under torch.profiler: device time by
    kernel over every model call, and the card's idle share, 1 - device
    busy time / wall time, against this run's wall (profiler on) and
    phase 4's (profiler off, a synchronisation around each call)."""
    requests, out = trace(eng.cfg), {}
    rows, wall = profiled(
        lambda: out.update(cb=serve(eng, requests)[0]),
        lambda: serve(eng, trace(eng.cfg, n_requests=1, lo=64, hi=64,
                                 n_new=2)))
    cb = out["cb"]
    calls = cb.chunk_calls + cb.decode_steps
    check((cb.chunk_calls, cb.decode_steps)
          == (main["chunk_calls"], main["decode_steps"]),
          "the profiled run made other model calls than phase 4")
    busy_ms = sum(r[1] for r in rows)
    attn = [r for r in rows if is_attention_kernel(r[0])]
    attn_ms = sum(r[1] for r in attn)
    attn_n = sum(r[2] for r in attn)
    check(attn_n == main["launches"],
          f"profiler saw {attn_n} attention launches, phase 4 counted "
          f"{main['launches']}")
    res = dict(requests=len(requests), calls=calls, wall_ms=1e3 * wall,
               device_busy_ms=busy_ms, idle_share=1 - busy_ms / (1e3 * wall),
               idle_share_phase4=1 - busy_ms / (1e3 * main["seconds"]),
               attention_ms=attn_ms, attention_launches=attn_n,
               attention_share=attn_ms / busy_ms,
               top=[dict(kernel=k[:90], ms=ms, count=n, share=ms / busy_ms)
                    for k, ms, n in rows[:12]])
    print(f"[profile] phase-4 trace again ({len(requests)} requests, "
          f"{cb.chunk_calls} chunk calls + {cb.decode_steps} decode steps): "
          f"wall {res['wall_ms']:.1f} ms, device busy {busy_ms:.1f} ms, idle "
          f"share {res['idle_share']:.3f} (against phase 4's wall "
          f"{res['idle_share_phase4']:.3f}); attention kernel {attn_ms:.1f} ms "
          f"over {attn_n} launches = {res['attention_share']:.3f} of busy",
          flush=True)
    for r in res["top"]:
        print(f"[profile]   {r['ms']:9.2f} ms {r['share']:6.3f} "
              f"{r['count']:7d}x  {r['kernel']}", flush=True)
    return res


# ----------------------------------------------------------------- phase 5

def phase_agree() -> None:
    from repro_torch.kernels import acam_attention as A
    eng = build_engine(n_layers=4)
    requests = lambda: trace(eng.cfg, n_requests=3, lo=64, hi=200, n_new=8)
    cb_k, *_ = serve(eng, requests())
    kernel = A._launch_kernel
    A._launch_kernel = A.acam_attention_codes_plain
    try:
        cb_p, *_ = serve(eng, requests())
    finally:
        A._launch_kernel = kernel
    for rid in cb_k.done:
        got = cb_k.done[rid].result.tolist()
        want = cb_p.done[rid].result.tolist()
        check(got == want, f"request {rid}: kernel {got} != plain {want}")
    print(f"[agree] 4-layer gpt2-large: kernel and plain attention give the "
          f"same tokens for {len(cb_k.done)} requests", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False)")
    from repro_torch.kernels import build
    desc = device_line()
    print(desc, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    t0 = time.perf_counter()
    build.library("acam_attention")
    print(f"[build] acam_attention: {time.perf_counter() - t0:.1f} s (nvcc "
          f"sm_90a)", flush=True)
    for line in build.build_log("acam_attention").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}", flush=True)

    kernel_rows = phase_kernels(desc)
    main_res, eng = phase_main(desc)
    prof_res = phase_profile(eng, main_res)
    del eng
    phase_agree()

    # the kernel line: main-path decode shape (pot) is the kernel's headline
    head = next(r for r in kernel_rows if r["case"] == "gpt2-large decode pot")
    worst = max(r["max_abs_err"] for r in kernel_rows)
    print("[record] " + json.dumps({"cases": kernel_rows, "main": main_res,
                                    "profile": prof_res}), flush=True)
    print(desc, flush=True)
    print(json.dumps({"kernels": [{
        "name": "acam_attention_paged",
        "route": "cuda",
        "source": "src/repro_torch/csrc/acam_attention.cu",
        "replaces": "src/repro/kernels/acam_attention.py:182",
        "launches": main_res["launches"],
        "max_abs_err": worst,
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
