"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device   the card's name and power limit; TF32 off for matmuls and cuDNN.
2. build    the kernels' CUDA sources with nvcc into build/repro_torch/, one
            nvcc per source, all started together, timed.
3. kernels  each kernel against its plain PyTorch version on the card, at the
            shapes the main paths give it, in the three softmax modes: the
            paged kernel (paged_sums + paged_probv), the contiguous two-pass
            kernel (contiguous_sums + contiguous_probv) and the one-tile
            kernel (single_tile), with paged edge shapes (a zero-length group,
            lengths ending mid-page, pages of 8, 96, 1056 and 2048 keys, D 36,
            70 rows, a page whose row sum only the reference's order of its
            run totals gets right, the tensor-parallel exact calls' cmax
            floors: a flat decode at 250 and a GQA decode at 90) and
            contiguous edge shapes (300, 600 and
            1100 keys, zero-length groups, fully masked rows, 70 rows, causal
            at q_offset 9, D 36, cmax floors; the one-tile kernel at 70 rows,
            zero-length GQA groups and 64 keys); out32 and cmax must be
            equal. Times, all by CUDA events: the device time of the
            kernel's launch function and of the plain version
            (`device_ms`: a spin kernel holds the stream while the host
            enqueues the calls, so host gaps do not count),
            the wrapper's and the plain version's per-call times
            (back-to-back calls, host work included), and the bound (bytes
            over 3.35 TB/s, int8 operations over 1979 TOP/s). The kernels
            line reports the device times. The paged entries' operand
            prolog (prolog_max + prolog_quant) at gpt2-large's pool (513
            pages of 64 x 20 x 64, 32 slots of 200..1000 keys on shuffled
            pages, stale values elsewhere), a decode call and a 256-row
            chunk: q's codes, the named pages' K/V codes, the scales and
            amaxes equal to its plain version bit for bit, timed against
            it, bound from the live rows; and one paged decode call under
            torch.profiler in a record_function range, to show whether the
            range's device time takes the prolog's and the attention
            kernels' launches.
4. main     gpt2-large at its published width (36 layers, d 1280, 20 heads,
            vocab 50257, random weights from a seed, resident int8) served by
            the paged continuous batcher: 8 slots, 64-token pages and chunks,
            16 requests of 64..512 prompt tokens and 32 new tokens each. The
            paged launch count must be 2 x 36 x (chunk calls + decode steps),
            and the prolog's the same (phases 12, 15 and 20 likewise).
   profile  the first 4 requests of phase 4's trace, 8 new tokens each,
            served again under torch.profiler: device time by kernel over
            every model call, and the card's idle share (1 - device busy
            time / wall time). torch.profiler can drop launches; a trace
            whose attention launches differ from the counters' is taken
            again once, and if it is short again the phase reports its
            numbers as not measured.
5. agree    the paged path at 4 layers with the kernel swapped for its plain
            version gives the same tokens.
6. bucketed gpt2-large as in phase 4 served by BatchScheduler in left-padded
            buckets of 4 on the contiguous KV cache (max_len 512): 16
            requests of 64..448 prompt tokens and 32 new tokens. The
            contiguous launch count must be 2 x 36 x (prefills + decode
            steps).
7. solo     command-r-35b at its published width (d 8192, 64 heads, 8 KV
            heads, head_dim 128, d_ff 22528, vocab 256000) cut to 8 of its 40
            layers (float32 init of all 40 is about 113 GB), resident int8
            from a seed, GenerationEngine.generate on 4 prompts of 64..256
            tokens one at a time, 32 new tokens, max_len 512. Every decode
            step must launch the one-tile kernel once per layer and every
            prefill the two-pass kernel twice per layer.
   profile  the first bucket of phase 6 and the first prompt of phase 7
            served again under torch.profiler: device time by kernel, idle
            share, the attention kernels' share (taken again once, as the
            phase-4 profile, when the profiler drops launches).
8. agree    the bucketed path at 4 layers and the solo path at 2 layers with
            the contiguous and one-tile kernels swapped for their plain
            versions give the same tokens.
9. kernel API  the public kernel entries at gpt2-large and command-r-35b
            widths on the card: acam_activation (gelu on a 512-token FFN
            hidden (512, 5120), silu at command-r's d_ff (256, 22528)),
            raceit_linear (fc1 (512, 1280) x (1280, 5120), fc2 (512, 5120) x
            (5120, 1280), a decode fc1 at M = 8; exact ADC and quantizing at
            adc_bits 8 and 6) and acam_softmax_kernel (staged-prefill rows:
            20 heads x 512 queries of 512 causally masked keys; decode rows:
            160 rows of 1024 keys). Each of the LUT, MVM and softmax kernels
            must launch; small inputs agree with the CPU's plain path bit
            for bit, and the exact linear layer is within 5% of the float
            product.
10. staged  gpt2-large as in phase 6 served with ExecConfig.serving(
            fused_attention=False), as --staged-attention asks: 4 prompts of
            64..256 tokens, 16 new tokens, one bucket of 4. The plan must
            show raceit_staged on both attention slots and raceit_acam on
            softmax, and no attention kernel may launch (the reference's
            staged path is jnp, so the port's is plain PyTorch). Prints
            tokens/s, prefill and decode ms, peak memory, and the share of
            greedy tokens equal to the fused path's on the same prompts (not
            gated: the fused kernel's contract with the staged oracle is at
            most 1 PROB ulp), and the bucket served again under
            torch.profiler (device time by kernel, idle share).
11. pool    olmo-1b at its published width (16 layers, d 2048, 16 heads of
            128, d_ff 8192, vocab 50304, non-parametric LayerNorm, tied
            embeddings), resident int8 from a seed, served by the
            contiguous slot pool (ContinuousBatcher(paged=False,
            prefill_len=512), 8 slots, max_len 1024) on phase 4's trace:
            tokens/s, prefill and decode ms, peak memory, the contiguous
            launch count (2 x 16 x (prefills + decode steps)) and the trace
            again under torch.profiler. Then: the kernels against their
            plain versions on a 4-layer pool (same tokens); the same float
            weights in digital mode, where the first 4 requests' pool tokens
            must be their solo `generate` tokens (parting only at a near tie
            of the solo logits, < 1e-3: batch-8 and batch-1 float sums);
            the first 4 raceit_q8 requests against their solo runs,
            counted, not held (whole-tensor quantizer scales couple the
            slots).
12. gqa-paged  starcoder2-15b (GQA 48:4, qkv biases) at its published width
            cut to 8 of its 40 layers (float32 init of 40 is about 62 GB),
            resident int8, through the paged batcher: 8 requests of 64..256
            tokens, 16 new; the paged launch count; the kernel against its
            plain version on a 2-layer run.
13. gemma3 gemma3-4b at the reference's width, nothing cut (34 layers: 29
            sliding-window layers with 1024-column ring caches and 5 global
            ones; d 2560, 8 heads and 4 KV heads of 320, d_ff 10240, vocab
            262144, RMSNorm, GELU-GLU, tied embeddings), resident int8 from
            a seed, through the contiguous slot pool (8 slots, max_len 2048,
            admission pinned at one window, 1024 tokens): 16 requests of
            128..1024 prompt tokens, 64 new each; tokens/s, prefill and
            decode ms, peak memory, the contiguous launch count (2 x 34 x
            (prefills + decode steps)) and the first 8 requests again under
            torch.profiler. Then: the kernels against their plain versions
            on a 6-layer pool (one period, every ring wrapping) and on a
            solo 1536-token prompt (the prefill past the ring and the band
            over 1536 keys); the same float weights' first 6 layers (one
            period) in digital mode, where the first 2 requests' tokens in
            a pool of the first 8 (32 new)
            must be their solo `generate` tokens (phase 11's near-tie rule);
            raceit_q8 against solo runs on 2 requests, counted, not held.
14. moe pool  mixtral-8x22b at its published width (d 6144, 48 heads and 8
            KV heads of 128, 8 experts of d_ff 16384, top-2, sliding window
            4096, vocab 32768) cut to 4 of its 56 layers (float32 weights of
            56 are about 562 GB, of 4 about 42 GB), resident int8 attention
            and lm head with float32 experts (as the reference keeps them),
            through the contiguous slot pool (8 slots, max_len 2048,
            prefill_len 1024): 16 requests of 128..1024 tokens, 32 new;
            tokens/s, prefill and decode ms, peak memory, the contiguous
            launch count (2 x 4 x (prefills + decode steps)); one layer's
            three expert products alone at the decode and the prefill
            capacity, by CUDA events, beside their bound; the first 8
            requests again under torch.profiler, with the expert bmm as one
            row. Then: layer 0's router logits of a 1024-token prefill
            routed on the card and on the CPU (expert ids, gates, kept
            choices and slots equal bit for bit); the kernels against their
            plain versions on a 2-layer pool (same tokens); digital pool
            tokens against solo runs on the same float weights, counted,
            not held (an expert's capacity counts pad rows and idle slots).
15. moe paged  llama4-scout-17b-a16e at its published width (d 5120, 40
            heads padded to 48 over 8 KV heads of 128, 16 experts of d_ff
            8192, top-1, vocab 202048) cut to 4 of its 48 layers (about 43
            GB), resident int8, through the paged batcher: 8 requests of
            64..256 tokens, 16 new; the paged launch count (2 x 4 x (chunk
            calls + decode steps)), tokens/s, step ms, peak memory, one
            layer's expert products at decode; the kernel against its plain
            version on a 2-layer run, every attention output finite (the
            padded heads 40..47 too, which are multiplied by zero after the
            kernel).
16. ssm pool  mamba2-130m at its published width, nothing cut (24 Mamba-2
            layers, d 768, d_inner 1536 in 24 SSM heads of 64, state 128,
            chunk 128, vocab 50280, tied embeddings, no attention and no
            FFN), resident int8 projections from a seed, through the
            contiguous slot pool (8 slots, prefill_len 512, max_len 1024) on
            phase 4's trace: tokens/s, prefill and decode ms, peak memory,
            no kernel launch at all, the first 8 requests again under
            torch.profiler. Then, on the float weights in digital mode:
            layer 0's mixer on a 1024-token prefill on the card against the
            CPU (TF32 off, within 1e-4 of the largest output); prefill(200)
            and 8 decode steps against one prefill of the 208 tokens (the
            reference's 2e-3 rule); pool tokens against solo runs for the
            first 2 requests, counted, not held (the SSM scans the left
            pads), in digital and raceit_q8.
17. hybrid pool  jamba-v0.1-52b at its published width (d 4096, 32 heads
            and 8 KV heads of 128, d_inner 8192 in 128 SSM heads, 16 experts
            of d_ff 14336 top-2, vocab 65536, no positional embedding) cut
            to 8 of its 32 layers, one period (7 Mamba-2 layers and the
            attention layer 4; dense and MoE FFNs in turn; float32 of 8
            layers is about 53 GB, of 32 about 206 GB), resident int8 with
            float32 experts, through the contiguous slot pool (8 slots,
            max_len 2048, prefill_len 1024): 16 requests of 128..1024
            tokens, 32 new; tokens/s, prefill and decode ms, peak memory at
            init and serving, the contiguous launch count (2 x 1 x
            (prefills + decode steps)); the first 8 requests again under
            torch.profiler with the expert bmm as one row; the kernels
            against their plain versions on the pool (same tokens); pool
            tokens against solo runs on 2 requests, counted, not held (the
            solo decode takes the one-tile kernel at rep 4), in raceit_q8
            and, on the float weights, digital.
18. encoder bert-base (12 layers, d 768, 12 heads, d_ff 3072) and
            bert-large (24 layers, d 1024, 16 heads, d_ff 4096; vocab 30522,
            bidirectional, learned positions) at their published widths,
            nothing cut, resident int8 from a seed, through `Model.forward`
            on 8 sequences of 384 tokens (the paper's length): ms per
            forward (5 forwards), sequences/s, peak memory, the contiguous
            launch count (2 x layers a forward), one forward under
            torch.profiler; bert-large cut to 2 layers with the kernels
            swapped for their plain versions gives bit-equal logits.
19. whisper whisper-tiny at its published width (4 encoder and 4 decoder
            layers, d 384, 6 heads, 1500 encoder frames, vocab 51865, tied
            embeddings), resident int8, frame embeddings from a seed,
            through `GenerationEngine.generate(enc_feats=...)`: 4 prompts
            of 16..64 tokens one at a time, 32 new; every prefill must
            launch the two-pass kernel 2 x (4 encoder + 4 cross) times and
            the one-tile kernel 4 times (decoder self-attention, one key
            block), every decode step the one-tile kernel 4 times and the
            two-pass kernel 2 x 4 times (cross over 1500 keys); prefill and
            decode ms, peak memory, one generate of 8 new tokens under
            torch.profiler. Then prefill logits and tokens equal
            with the kernels swapped for their plain versions, and in
            digital mode prefill(24) + 16 decode steps within 2e-3 of
            `Model.forward` (the reference's rule).
20. mrope  qwen2-vl-2b at its published width, nothing cut (28 layers, d
            1536, 12 heads over 2 KV heads of 128, d_ff 8960, vocab 151936,
            tied embeddings, M-RoPE sections 16/24/24), resident int8,
            through the paged batcher: 8 requests of 64..512 tokens, 32
            new, 64-token pages and chunks; the paged launch count (2 x 28 x
            (chunk calls + decode steps)), tokens/s, step ms, peak memory,
            the first 4 requests (8 new) under torch.profiler. Then a
            2-layer prefill with distinct t/h/w positions (a 2 x 8 x
            8 patch grid and 32 text tokens) on the card against the CPU:
            within 1e-4 of the largest logit in digital mode, and moved by
            far more than that against text-only positions; raceit_q8
            reported.
21. noise  gpt2-large at its published width (d 1280, 20 heads, vocab
            50257), resident int8 from a seed, its first 12 of 36 layers
            (the script's time; the later checks take all 36), served with
            ExecConfig.serving(mode="raceit", noise=nominal, seed 1) by the
            paged batcher: 8 requests of 64..256 tokens, 16 new. The plan
            must put raceit_noisy_int, raceit_noisy_lut, raceit_noisy_acam
            and raceit_noisy_staged (both attention slots) on the raceit
            slots, and no kernel may launch (the reference computes the
            noisy path in jnp). The trace is served twice: the first run
            makes the host draws (their time and the cache's bytes are
            printed), the second is timed (tokens/s, decode and chunk ms,
            peak memory) and must give the first run's tokens; the clean
            staged plan serves the same trace for comparison, and the first
            2 requests (4 new) are served again by both under
            torch.profiler (device time by kernel, idle share). Then, at 2
            layers: a zero-sigma NoiseConfig() gives prefill logits, paged
            tokens and generate tokens bit-equal to the clean staged plan
            (fused_attention=False); at worst_case, one call of each noisy
            backend on the card and on the CPU on identical inputs, their
            integer outputs equal (perturbed weight codes and their int32
            product, LUT codes, PROB codes, the staged attention's int32
            products, the decode's softmax on the card's own scores), the
            draws the card injected equal to fresh host draws, and a
            2-slot trace's tokens counted against the CPU's; and digital
            serving with the decode attention on raceit_noisy_staged at
            worst_case with fault_rate 0.5 on 2 slots retires exactly the
            slot `fault_rows` names, the survivor's tokens equal to the
            no-fault run's.
22. tp     tensor and expert parallelism, run after phase 15 (it reuses
            phase 15's llama4-scout engine): every shard on cuda:0, each
            mesh spec built onto ["cuda:0"] * n. (a) Each TP backend
            (raceit_fused_tp prefill and decode, raceit_gqa_tp) against its
            single-device backend on the same float operands, bit for bit:
            causal and padded-bucket prefill, contiguous flat decode with
            per-row lengths, paged flat decode and a 64-row chunk, and for
            GQA the contiguous and paged GQA decode, at gpt2-large's shapes
            (20 heads of 64, model 2 and 4) and command-r-35b's (64 heads
            over 8 KV heads of 128, model 2, 4 and 8); every TP call makes
            two wrapper calls a shard (probe and exact), and its time (CUDA
            events, host included) is printed beside the single call's.
            (b) gpt2-large at its published width (36 layers), resident
            int8, paged (8 slots, 64-token pages and chunks, max_len 1024),
            4 requests of 64..256 tokens, 16 new, served with no mesh and
            with model=2 on the same weights: tokens equal, 2 x 2 x 2 x 36
            paged launches a model call, tokens/s, decode and chunk ms and
            peak memory of both. (c) llama4-scout (4 of 48 layers), model=2
            (raceit_gqa_tp, EP over two shards): layer 0's routing of each
            EP shard in a first chunk call routed again on the card and on
            the CPU, equal bit for bit, each shard at its own capacity;
            4 requests, 8 new, with and without the mesh: the TP launch
            count, tokens/s, step ms, and the tokens equal to no mesh
            counted, not held (with EP the capacity is per shard, as in the
            reference).
23. train  training (no kernel but in (d)), TF32 off. (a) gpt2-large's
            width cut to 2 layers, weights from a seed made on the CPU and
            copied to the card, batch 2 x 64: loss and every gradient leaf
            of `trainer.value_and_grad` on the card against the CPU's
            (the CPU tests' tolerances: loss rtol 1e-6, each leaf
            max|diff| <= 1e-4 max|g| + 1e-7). (b) gpt2-large at its
            published width, nothing cut, through `launch.train.train` at
            the launcher's defaults (8 x 256 tokens a step, float32, AdamW
            with remat "dots"), 6 steps with its checkpoint under build/
            (25 (b) restores one of this size bit for bit, and (c) resumes
            the loop); every loss finite, step 6's below step 1's. Step ms
            (median after the first), tokens/s, peak memory, checkpoint
            write seconds and bytes, one
            step split into forward, backward and optimizer (CUDA
            synchronised host clock), forward + backward and its peak
            memory under each remat policy (none, full, dots), and one
            step under torch.profiler (idle share, top device kernels). The directory is deleted.
            (c) tests/test_substrate.py's tiny olmo-1b: 10 steps against 5,
            then a resume to 10; final params within rtol 1e-5, atol 1e-6
            (the embedding's backward accumulates with atomics on the
            card). (d) tests/test_system.py's tiny gpt2-large (2 layers, d
            128) trains 120 steps, its last loss under 0.7 of its first;
            then `Model.forward` under ExecConfig.serving(mode="raceit") on
            resident int8 launches the contiguous kernel (2 a layer), its
            argmax agrees with the digital forward on more than 0.7 of the
            positions, and it equals the forward with the kernel swapped
            for its plain version bit for bit.
24. dryrun  the dry-run and the static analysis against the card.
            gpt2-large at its published width, resident int8 through
            ExecConfig.serving(mode="raceit"), one decode step at
            ShapeSpec("decode_1k", 1024, 8, "decode") on `init_cache` (the
            contiguous kernel runs). (a) The dry-run's bytes of params plus
            cache (`launch.inputs.tree_bytes` over the same trees made on
            meta) equal the bytes the card's caching allocator was asked
            for them (its requested_bytes), exactly, and its blocks hold at
            least those bytes in 512-byte granules; its traced peak of live
            storage (`op_analysis.analyze_ops` on meta) beside the card's
            peak over the step (max_memory_allocated, and requested). (b) `analyze_ops`
            over the real step on the card gives the flops, memory bytes,
            op counts and kernel launches (names, bytes, operations) of the
            trace on meta. (c) Every dynamic shared-memory layout the
            kernelcheck plan checks meet (`analysis.kernelcheck`, the
            serving domain) equals the sources' own export
            (acam_attention_{paged,contiguous,single}_smem) and is at most
            the card's cudaDevAttrMaxSharedMemoryPerBlockOptin.
25. mesh    parameters placed on a data=2,model=2 mesh, every position on
            cuda:0. (a) Right after phase 22, phase 22's gpt2-large (36
            layers, resident int8) with fsdp=True served by an engine on
            that mesh (placed at load: every stripe a view, nothing
            allocated) on phase 22's trace: tokens equal to phase 22's
            no-mesh run, 2 x 2 x 2 x 36 paged launches a model call, stripe
            bytes per position against the whole tree's, tokens/s and
            decode and chunk ms beside the no-mesh run's. (b) After phase
            24, gpt2-large at its published width with fsdp=True: 3 steps
            through `launch.train.train` on the mesh (the batch split over
            the two data replicas) against 3 no-mesh steps of the
            launcher's weights, schedule and batches; losses within rtol
            1e-6, params within a tenth of the summed learning rate; step
            ms, peak memory and one step under torch.profiler (idle share)
            of both; the mesh run's checkpoint restored without a mesh,
            equal bit for bit. Its directory is deleted.

Phase 9 also drives the float attention wrappers with the reference's
default fold_scale=False at D 128 (the kernels divide by sqrt(d)), with
their launch counts, and the staged oracle's Compute-ACAM emulation on the
card: `mult8_codes` on all 65536 pairs of int8 codes by the 4-bit
two-variable tables and by their match lines (``hw=True``), and
`dd_matmul_codes(fidelity="acam")` on a (4, 16, 64) x (64, 16) case, each
equal to the integer product.


Phase 3 also holds the LUT kernel (int8 and int32 codes), the crossbar MVM
kernel (exact, and quantizing at adc_bits 8 and 6; with edge shapes off
every tile multiple, bk 64 and 100, and K split over blocks) and the Fig.-8
softmax kernel (pot, pot_fine, uniform) bit for bit against their plain
versions at phase 9's shapes, with the time of one PyTorch call computing
the same function where there is one (an index gather for the LUT,
torch._int_mm for the exact MVM where its shape rules allow). Last in
phase 3, a split sweep: every split of the pages (paged kernel), of each
group's keys into spans of runs (contiguous two-pass kernel at the three
main-path contiguous shapes, and the one-tile kernel at the solo GQA
decode) and of K (MVM kernel) over blocks at the main-path shapes, each
split's result equal to the plan's, its device time beside the split the
plan picks. Phase 3 also holds the division by sqrt(d) inside the kernels
(D 32 and 128, every mode, paged decode and chunk, contiguous decode with
per-group lengths, causal prefill at a q_offset, masked prefill, one tile),
logits an ulp from a LOGIT rounding step where dividing and multiplying by
the reciprocal part, and head dims 36 and 256; and head dim 320, gemma3-4b's,
in every mode at its serving shapes (the pool's admission prefill with the
local and left-pad masks, a 1536-token solo prefill with the banded mask, the
pool's GQA decode over a 1024-key ring and over 2048 keys) and in the paged
and one-tile kernels. Phase 3 also holds GQA at 6 query heads a KV head,
the two MoE models', in every mode: the mixtral pool's decode (64 groups
of 6 rows over 2048-key rings) and admission prefill (48 heads, 1024 x
1024, local and left-pad masks), llama4-scout's paged GQA decode (8 slots
x 8 groups, 6 rows) and flat 64-row paged chunk; and at 4 query heads a KV
head, jamba's, in every mode: its pool's decode (64 groups of 4 rows over
2048 keys, per-group lengths) and admission prefill (32 heads, 1024 x 1024,
left-pad mask, no local band); and the encoder families' calls in every
mode: bert-large's bidirectional attention (8 sequences x 16 heads, 384 x
384, the all-true mask), whisper-tiny's encoder (6 heads, 1500 x 1500: three
key blocks, the last of 476 real keys), its cross attention over 1500 keys
at a 64-row prefill and at a decode step, and qwen2-vl-2b's paged GQA decode
(8 slots x 2 groups of 6 rows, D 128) and 12-head chunk. The build phase
prints
each kernel's registers, static shared memory and spills (`nvcc -Xptxas
-v`), and each attention kernel's dynamic shared memory at D 320 from the
launchers' own layout code.

The line before the last is one JSON object describing every kernel; the
last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --headline [ROOT]

times the attention kernels' main-path cases of phase 3 in mode pot (the
minimum of 3 rounds of `device_ms`) in the tree at ROOT (default: this
checkout), with its own kernels and case builders, and where that tree
takes ``scale_by_sqrt_d`` the D 128 cases again divided by sqrt(d) in the
kernel. Two commits compare in one call: parent, change, change, parent
(the parent unpacked with `git archive` into a directory .gitignore lists).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
SEED = 0
DEVICE = "cuda"  # the card; phases 3 (new kernels), 9 and 10 read it


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


# the device kernels of each attention kernel, as torch.profiler names them
KERNEL_NAMES = {"acam_attention_paged": ("paged_sums", "paged_probv"),
                "acam_attention": ("contiguous_sums", "contiguous_probv"),
                "acam_attention_single": ("single_tile",)}
KERNEL_SOURCES = {"acam_attention_paged": "acam_attention",
                  "acam_attention": "acam_attention",
                  "acam_attention_single": "acam_attention_single"}


def kernel_of(name: str):
    """Which attention kernel a profiler row belongs to, or None."""
    for kernel, parts in KERNEL_NAMES.items():
        if any(re.search(rf"(^|[^\w]){part}($|[^\w])", name)
               for part in parts):
            return kernel
    return None


def profiled(fn, warm) -> tuple[list, float]:
    """One run of ``fn()`` under torch.profiler (CUPTI), after a warm-up step
    of the profiler itself that runs ``warm()`` and is not recorded.
    Returns (kernel_table rows, wall seconds of ``fn()``); the rows may miss
    launches, or be empty, when CUPTI drops records."""
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
    return kernel_table(prof), wall


def launches_seen(rows) -> tuple[dict, dict]:
    """Launches and device ms of each attention kernel in profiler rows."""
    seen = {k: 0 for k in KERNEL_NAMES}
    ms = {k: 0.0 for k in KERNEL_NAMES}
    for name, t, n in rows:
        k = kernel_of(name)
        if k is not None:
            seen[k] += n
            ms[k] += t
    return seen, ms


def profiled_complete(fn, warm, expect: dict, tries: int = 2):
    """``profiled(fn, warm)`` until the profiler sees exactly the ``expect``
    launches of each attention kernel, at most ``tries`` times. Returns
    (rows, wall, seen launches, complete)."""
    for _ in range(tries):
        rows, wall = profiled(fn, warm)
        seen = launches_seen(rows)[0]
        if seen == expect:
            return rows, wall, seen, True
    return rows, wall, seen, False


@functools.cache
def spin_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    torch.cuda._sleep(1000)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(10 ** 7)
    b.record()
    torch.cuda.synchronize()
    return 1e7 / a.elapsed_time(b)


def device_ms(fn, iters: int, reps: int = 1) -> tuple[float, bool]:
    """Mean device milliseconds of one ``fn()``, by CUDA events with host
    gaps excluded: a spin kernel holds the stream while the host enqueues
    ``iters`` calls, which the card then runs back to back; ``reps`` such
    windows. Also returns whether the host had enqueued every call before
    the hold ended, in every window; if not (a call that waits for the
    card, or more launches than the launch queue takes), host time is in
    the number."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    hold_ms = 2e3 * (time.perf_counter() - t0) + 5.0
    total, host_free = 0.0, True
    for _ in range(reps):
        held, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        t0 = time.perf_counter()
        held.record()
        torch.cuda._sleep(int(hold_ms * spin_cycles_per_ms()))
        start.record()
        for _ in range(iters):
            fn()
        enqueue_ms = 1e3 * (time.perf_counter() - t0)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
        host_free = host_free and enqueue_ms < held.elapsed_time(start)
    return total / (reps * iters), host_free


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
                   lens, chunk_mask=False, sqrt_d=None, floor=None,
                   device="cuda", seed=SEED):
    """Int8 operands of one paged attention call at a main-path shape;
    ``sqrt_d`` is the call's ``scale_by_sqrt_d`` (None: folded), ``floor``
    its ``cmax_floor`` (the tensor-parallel exact call's), a device int32
    scalar as `tp_exact_call` passes it."""
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
                bt=t(bt), page_size=page_size, gps=gps, lens=list(lens),
                sqrt_d=sqrt_d,
                floor=None if floor is None else torch.tensor(
                    floor, dtype=torch.int32, device=device))


def attention_bound_ms(c) -> tuple[float, str]:
    """Least time for the call (`kernels/cost.py`): every input byte read
    once (live pages only), the output written once, against the operations
    at int8 peak."""
    from repro_torch.kernels import cost
    G, sq, d = c["q"].shape
    live = int(sum(c["lens"])) * c["gps"]  # live key rows over all groups
    return cost.bound_ms(*cost.total(cost.paged_attention(
        G, sq, d, live, c["bt"].numel(), c["kv_len"].numel(),
        0 if c["mask"] is None else c["mask"].numel())))


def contiguous_case(name, *, G, sq, sk, d, mode, kv_len=None, causal=False,
                    pad=None, heads=1, q_offset=0, lens=None,
                    masked_rows=None, floor=None, sqrt_d=None, window=None,
                    device="cuda", seed=SEED):
    """Int8 operands of one contiguous call at a main-path shape. ``pad``
    (B,) left-pad lengths give one mask row per batch row of ``heads``
    groups (causal on top when ``causal``, and inside the last ``window``
    keys of each row when ``window``: a local layer's banded mask); else
    ``causal`` is in-kernel with ``q_offset``. ``lens`` gives a per-group
    kv_len vector (zeros are zero-length groups), ``masked_rows`` a random
    mask with those rows masked whole, ``floor`` a cmax floor, ``sqrt_d``
    the call's ``scale_by_sqrt_d``."""
    gen = np.random.default_rng(seed)
    q = gen.integers(-128, 128, (G, sq, d), dtype=np.int8)
    k = gen.integers(-128, 128, (G, sk, d), dtype=np.int8)
    v = gen.integers(-128, 128, (G, sk, d), dtype=np.int8)
    s1 = np.float32(4.0 / (np.sqrt(d) * 128 * 128 / 3))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    mask = None
    if pad is not None:
        cols = np.arange(sk)[None, None, :]
        m = np.broadcast_to(cols >= np.asarray(pad)[:, None, None],
                            (len(pad), sq, sk))
        rows = np.arange(sq)[None, :, None] + (sk - sq)
        if causal:
            m = m & (cols <= rows)
        if window is not None:
            m = m & (cols > rows - window)
        mask = t(np.array(m))  # a writable copy of the broadcast
        causal = False
    elif masked_rows is not None:
        m = gen.random((G, sq, sk)) < 0.6
        m[:, list(masked_rows)] = False
        mask = t(m)
    kv = None
    if lens is not None:
        kv = torch.tensor(lens, dtype=torch.int32, device=device)
        lens = np.minimum(np.asarray(lens, np.int32), sk)
    else:
        if kv_len is not None:
            kv = torch.tensor(kv_len, dtype=torch.int32, device=device)
        lens = np.full(G, sk if kv_len is None else kv_len, np.int32)
    return dict(name=name, mode=mode, q=t(q), k=t(k), v=t(v),
                s1=torch.tensor(s1, device=device), mask=mask, kv_len=kv,
                lens=t(lens), per_row=kv is not None and kv.ndim == 1,
                causal=causal, q_offset=q_offset, heads=heads,
                floor=None if floor is None else torch.tensor(
                    floor, dtype=torch.int32, device=device), sqrt_d=sqrt_d)


def contiguous_bound_ms(c) -> tuple[float, str]:
    """Least time for a contiguous call (`kernels/cost.py`): q, K and V of
    the live keys, the mask and the int32 output moved once; q.K over the
    pairs that are not masked (a masked key skips its product) and PROB.V
    over the live keys, a multiply and an add each, at the int8 peak."""
    from repro_torch.kernels import cost
    G, sq, d = c["q"].shape
    lens = c["lens"].long()
    live = int(lens.sum())
    sk = c["k"].shape[1]
    kpos = torch.arange(sk, device=lens.device)
    valid = kpos[None, None, :] < lens[:, None, None]          # (G, 1, Sk)
    if c["mask"] is not None:
        g = torch.arange(G, device=lens.device)
        m = c["mask"][g // (G // c["mask"].shape[0])] != 0
        pairs = int((m & valid).sum())
    elif c["causal"]:
        rows = torch.arange(sq, device=lens.device) + c["q_offset"]
        pairs = int(((kpos[None, :] <= rows[:, None])[None] & valid).sum())
    else:
        pairs = live * sq
    return cost.bound_ms(*cost.total(cost.contiguous_attention(
        G, sq, d, live, pairs,
        0 if c["mask"] is None else c["mask"].numel())))


def sqrt_d_args(c):
    """The logit scale and ``rsd`` the wrapper hands its kernel and plain
    version for ``c["sqrt_d"]`` (`sqrt_d_rule`)."""
    from repro_torch.kernels import acam_attention as A
    return A.sqrt_d_rule(c["s1"], c["sqrt_d"])


def check_attention_case(c):
    """The paged kernel against its plain version on one case."""
    from repro_torch.kernels import acam_attention as A
    s1, rsd = sqrt_d_args(c)
    args = (c["q"], c["k"], c["v"], s1, c["mask"])
    kw = dict(kv_len=c["kv_len"], mode=c["mode"], block_table=c["bt"],
              page_size=c["page_size"], groups_per_slot=c["gps"],
              cmax_floor=c["floor"])
    kv = torch.clamp(c["kv_len"], max=c["bt"].shape[1] * c["page_size"])
    plain = lambda: A.acam_attention_codes_plain(
        *args, kv, c["mode"], c["bt"], c["page_size"], c["gps"], c["floor"],
        rsd=rsd)
    kernel = lambda: A.acam_attention_codes(
        c["q"], c["k"], c["v"], c["s1"], c["mask"],
        scale_by_sqrt_d=c["sqrt_d"], **kw)
    mask8 = None if c["mask"] is None else c["mask"].to(torch.int8)
    launch = lambda: A._padded_to_4(A._launch_paged, 3)(
        c["q"], c["k"], c["v"], s1, mask8, kv, c["mode"], c["bt"],
        c["page_size"], c["gps"], c["floor"], rsd=rsd)
    bound_ms, bound_by = attention_bound_ms(c)
    return compare_and_time("acam_attention_paged", 2, kernel, launch, plain,
                            bound_ms, bound_by)


def contiguous_launch(c, plan=None):
    """The launch function the wrapper would call on ``c``'s operands,
    with ``plan`` (the call's own by default)."""
    from repro_torch.kernels import acam_attention as A
    G, sq, _ = c["q"].shape
    fn = (A._launch_single if A.one_tile(G, sq, c["k"].shape[1])
          else A._launch_contiguous)
    mask8 = None if c["mask"] is None else c["mask"].to(torch.int8)
    s1, rsd = sqrt_d_args(c)
    fn = A._padded_to_4(fn, 3)
    return lambda: fn(c["q"], c["k"], c["v"], s1, mask8, c["lens"],
                      c["per_row"], c["mode"], c["floor"], c["q_offset"],
                      c["causal"], plan, rsd=rsd)


def check_contiguous_case(c):
    """The contiguous two-pass or the one-tile kernel against its plain
    version on one case; the wrapper's shape rule picks the kernel."""
    from repro_torch.kernels import acam_attention as A
    G, sq, _ = c["q"].shape
    single = A.one_tile(G, sq, c["k"].shape[1])
    s1, rsd = sqrt_d_args(c)
    plain_fn = (A.acam_attention_single_plain if single
                else A.acam_attention_contiguous_plain)
    plain = lambda: plain_fn(c["q"], c["k"], c["v"], s1, c["mask"],
                             c["lens"], c["per_row"], c["mode"], c["floor"],
                             c["q_offset"], c["causal"], rsd=rsd)
    kernel = lambda: A.acam_attention_codes(
        c["q"], c["k"], c["v"], c["s1"], c["mask"], kv_len=c["kv_len"],
        mode=c["mode"], cmax_floor=c["floor"], q_offset=c["q_offset"],
        causal=c["causal"], scale_by_sqrt_d=c["sqrt_d"])
    bound_ms, bound_by = contiguous_bound_ms(c)
    name = "acam_attention_single" if single else "acam_attention"
    return compare_and_time(name, 1 if single else 2, kernel,
                            contiguous_launch(c), plain, bound_ms, bound_by)


def compare_and_time(kernel_name, launches_per_call, kernel, launch, plain,
                     bound_ms, bound_by):
    """``kernel()`` (the wrapper) against ``plain()`` bit for bit, and the
    times of ``launch()``, the wrapper's launch function on the operands
    the wrapper would pass it (the kernel's launches and its one-word cell
    fills), of the wrapper and of the plain version."""
    from repro_torch.kernels import acam_attention as A
    before = A.launches[kernel_name]
    out_k, cmax_k = kernel()
    check(A.launches[kernel_name] == before + launches_per_call,
          f"{kernel_name} was not the kernel launched")
    out_p, cmax_p = plain()
    out_l, cmax_l = launch()
    torch.cuda.synchronize()
    check(int(cmax_k) == int(cmax_p),
          f"{kernel_name}: cmax {int(cmax_k)} != plain {int(cmax_p)}")
    diff = (out_k.long() - out_p.long()).abs().max().item()
    check(diff == 0, f"{kernel_name}: out32 differs from plain by {diff}")
    check(int(cmax_l) == int(cmax_k) and torch.equal(out_l, out_k),
          f"{kernel_name}: the launch function differs from the wrapper")
    ms, host_free = device_ms(launch, 20)
    wrapper_ms = cuda_ms(kernel, 20)
    plain_ms, plain_host_free = device_ms(plain, 1, reps=3)
    plain_call_ms = cuda_ms(plain, 3, warmup=1)
    return dict(kernel=kernel_name, max_abs_err=float(diff), ms=ms,
                ms_host_free=host_free, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, plain_host_free=plain_host_free,
                plain_call_ms=plain_call_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def report_case(name, r, device_desc):
    gaps = lambda ok: "" if ok else ", host gaps included"
    print(f"[kernels] {name} ({r['kernel']}): out32 and cmax equal to plain; "
          f"kernel device {r['ms']:.4f} ms (CUDA events{gaps(r['ms_host_free'])}"
          f"; wrapper call {r['wrapper_ms']:.4f} ms), plain device "
          f"{r['plain_ms']:.3f} ms{gaps(r['plain_host_free'])} (call "
          f"{r['plain_call_ms']:.3f} ms), bound {1e3 * r['bound_ms']:.3f} us "
          f"({r['bound_by']}); no library call computes this integer LUT "
          f"pipeline ({device_desc})", flush=True)


# a page of 2048 keys (64 runs: two `sum_chunks` groups of 32 run totals)
# of LOGIT codes (i * 37) % 80 - 60 with these (key, code) overrides: its
# pot_fine exp values added in the reference's order and run total by run
# total give row sums on two sides of a LOG(S) step, so only the first
# order gives the plain version's output (tests/test_torch_decomposed.py
# holds the page against the Pallas kernel)
ORDER_PAGE = ((0, -45), (26, -54), (46, -21), (67, -128), (147, -128),
              (227, -128), (307, -128), (387, -128), (467, -128), (547, -128),
              (627, -128), (707, -128), (787, -128), (867, 3))


def order_case():
    """A pot_fine decode over `ORDER_PAGE`, then the trash page: q . k is
    each key's first code and s1 = 1/8 makes it the LOGIT code."""
    c = attention_case("paged edge ps 2048 run order", n_slots=1, gps=1,
                       sq=1, d=64, page_size=2048, max_pages=2,
                       mode="pot_fine", lens=[2048])
    codes = np.arange(2048) * 37 % 80 - 60
    for i, code in ORDER_PAGE:
        codes[i] = code
    c["q"].zero_()
    c["q"][0, 0, 0] = 1
    c["k"][int(c["bt"][0, 0]), :, 0] = torch.from_numpy(
        codes.astype(np.int8)).to(c["k"].device)
    c["s1"] = torch.tensor(np.float32(0.125), device=c["q"].device)
    return c


def paged_edge_cases() -> list:
    """Shapes off the paged kernels' tiles: a flat decode with a zero-length
    group and lengths ending mid-page over more pages than one split; pages
    of 8 keys with D 36 (4-byte copies, D padded) and 70 masked rows (two
    row tiles); pages of 96 keys (three runs, key tiles of 32), GQA rows;
    pages of 1056 keys (33 runs, in two groups) and `order_case`; and the
    tensor-parallel exact calls, seeded with a cmax floor: a flat decode of
    gpt2-large's 10 heads a shard (floor 250) and a GQA decode of
    command-r's 4 KV heads a shard, 8 rows each (floor 90)."""
    return [
        attention_case("paged edge floor 250", n_slots=8, gps=10, sq=1,
                       d=64, page_size=64, max_pages=16, mode="pot",
                       lens=[0, 1, 63, 65, 1000, 1024, 130, 511], floor=250),
        attention_case("paged edge gqa floor 90", n_slots=8, gps=4, sq=8,
                       d=128, page_size=64, max_pages=16, mode="pot_fine",
                       lens=[700, 1, 0, 64, 1024, 333, 96, 512], floor=90),
        attention_case("paged edge decode mid-page", n_slots=8, gps=20,
                       sq=1, d=64, page_size=64, max_pages=16, mode="pot",
                       lens=[0, 1, 63, 65, 1000, 1024, 130, 511]),
        attention_case("paged edge ps 8 D 36 70 rows", n_slots=3, gps=4,
                       sq=70, d=36, page_size=8, max_pages=12, mode="pot",
                       lens=[0, 17, 93], chunk_mask=True),
        attention_case("paged edge ps 96 gqa", n_slots=4, gps=8, sq=8,
                       d=128, page_size=96, max_pages=6, mode="pot",
                       lens=[576, 0, 97, 300]),
        attention_case("paged edge ps 1056", n_slots=2, gps=2, sq=1, d=64,
                       page_size=1056, max_pages=2, mode="pot",
                       lens=[2112, 1500]),
        order_case(),
    ]


def paged_main_cases(gen, mode) -> list:
    """The paged kernel's main-path calls: gpt2-large decode and 64-row
    chunk (G 160, D 64) and command-r GQA decode (8 rows, D 128), 8 slots of
    16 pages of 64 keys."""
    slots, mp, ps = 8, 16, 64
    lens = gen.integers(1, mp * ps + 1, slots).tolist()
    gqa_lens = gen.integers(1, mp * ps + 1, slots).tolist()
    gqa_lens[3] = 0  # a zero-length slot
    chunk_lens = gen.integers(64, mp * ps + 1, slots).tolist()
    return [
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


def contiguous_main_cases(gen, mode) -> list:
    """The contiguous kernels' main-path calls: gpt2-large bucket decode
    (G 80, 512 keys, a pad mask per batch row of 20 groups) and prefill
    (448 rows, causal and pad), command-r prefill (G 64, 256 rows, D 128,
    causal in-kernel), and the one-tile command-r solo GQA decode."""
    pads = gen.integers(0, 200, 4)
    pads[int(gen.integers(0, 4))] = 0  # the bucket's longest prompt
    return [
        contiguous_case(f"gpt2-large bucket decode {mode}", G=80, sq=1,
                        sk=512, d=64, mode=mode, heads=20,
                        kv_len=int(gen.integers(449, 481)),
                        pad=np.minimum(pads, 100)),
        contiguous_case(f"gpt2-large bucket prefill {mode}", G=80,
                        sq=448, sk=448, d=64, mode=mode, heads=20,
                        causal=True, pad=pads),
        contiguous_case(f"command-r prefill {mode}", G=64, sq=256,
                        sk=256, d=128, mode=mode, causal=True),
        contiguous_case(f"command-r solo gqa decode {mode}", G=8, sq=8,
                        sk=512, d=128, mode=mode,
                        kv_len=int(gen.integers(65, 289))),
    ]


def contiguous_edge_cases() -> list:
    """Shapes off the contiguous kernels' main path: one key block of 300
    keys (runs 22 + 32 x 8 + 22) with per-group lengths ending mid-run and
    zero-length groups; 600 keys (two key blocks, the last padded) causal
    at q_offset 9 over 70 rows (two row tiles); 1100 keys (three blocks) at
    D 36 with a mask whose rows 0 and 3 see no key; a cmax floor of 250;
    and the one-tile kernel with 70 masked rows of 300 keys, zero-length
    GQA groups, and 64 keys (one padded tile of 128) with a floor of 90."""
    return [
        contiguous_case("contiguous edge Sk 300 lens", G=12, sq=1, sk=300,
                        d=64, mode="pot", lens=[0, 1, 21, 22, 23, 54, 299,
                                                300, 150, 0, 77, 280]),
        contiguous_case("contiguous edge Sk 600 causal q_offset 9 70 rows",
                        G=10, sq=70, sk=600, d=64, mode="pot", causal=True,
                        q_offset=9),
        contiguous_case("contiguous edge Sk 1100 masked rows D 36", G=12,
                        sq=5, sk=1100, d=36, mode="pot_fine",
                        masked_rows=(0, 3)),
        contiguous_case("contiguous edge floor 250", G=16, sq=1, sk=448,
                        d=64, mode="pot", kv_len=300, floor=250),
        contiguous_case("one-tile edge Sk 300 70 masked rows", G=2, sq=70,
                        sk=300, d=64, mode="pot", masked_rows=(0, 69)),
        contiguous_case("one-tile edge gqa zero-length groups", G=8, sq=8,
                        sk=512, d=128, mode="uniform",
                        lens=[0, 512, 1, 33, 200, 0, 480, 96]),
        contiguous_case("one-tile edge Sk 64 floor 90", G=3, sq=1, sk=64,
                        d=64, mode="pot", floor=90),
    ]


def sqrt_d_cases(gen, d, mode) -> list:
    """The in-kernel division by sqrt(d) (``scale_by_sqrt_d=d``, sqrt(d)
    not a power of two) in every layout: paged decode and 64-row chunk (8
    slots x 16 heads, 16 pages of 64 keys), contiguous decode with
    per-group lengths (olmo-1b's slot pool: 8 slots x 16 heads of 1024
    keys), causal prefill at q_offset 536 over 600 keys, masked prefill
    with two rows masked whole, and the one-tile kernel."""
    slots, mp, ps = 8, 16, 64
    lens = gen.integers(1, mp * ps + 1, slots).tolist()
    chunk_lens = gen.integers(64, mp * ps + 1, slots).tolist()
    glens = gen.integers(0, 1025, 128).tolist()
    glens[5] = 0
    tag = f"sqrt-d D {d} {mode}"
    return [
        attention_case(f"paged decode {tag}", n_slots=slots, gps=16, sq=1,
                       d=d, page_size=ps, max_pages=mp, mode=mode,
                       lens=lens, sqrt_d=d),
        attention_case(f"paged chunk {tag}", n_slots=slots, gps=16, sq=64,
                       d=d, page_size=ps, max_pages=mp, mode=mode,
                       lens=chunk_lens, chunk_mask=True, sqrt_d=d),
        contiguous_case(f"contiguous decode lens {tag}", G=128, sq=1,
                        sk=1024, d=d, mode=mode, lens=glens, sqrt_d=d),
        contiguous_case(f"causal prefill q_offset 536 {tag}", G=16, sq=64,
                        sk=600, d=d, mode=mode, causal=True, q_offset=536,
                        sqrt_d=d),
        contiguous_case(f"masked prefill {tag}", G=16, sq=96, sk=512, d=d,
                        mode=mode, masked_rows=(0, 5), sqrt_d=d),
        contiguous_case(f"one-tile {tag}", G=8, sq=8, sk=300, d=d,
                        mode=mode, lens=[300, 0, 1, 77, 299, 150, 32, 64],
                        sqrt_d=d),
    ]


def boundary_s1(d, r0, n):
    """An s1 at which ``r0 * s1`` then ``/ sqrt(d)`` and ``* f32(1/sqrt(d))``
    round to different LOGIT codes at half step ``n + 0.5`` (as
    tests/test_torch_sqrt_d.py builds its sweep), or None."""
    f32 = np.float32
    sd = np.sqrt(f32(d), dtype=f32)
    s = f32((n + 0.5) / 8 * float(sd) / r0)
    for k in range(-8, 9):
        t = s
        for _ in range(abs(k)):
            t = np.nextafter(t, f32(np.inf) if k > 0 else f32(-np.inf))
        x = f32(f32(r0) * t)
        if np.round(f32(x / sd) * f32(8)) != np.round(
                f32(x * (f32(1) / sd)) * f32(8)):
            return t
    return None


def boundary_cases() -> list:
    """Logits an ulp from a LOGIT half step, where dividing by sqrt(d) and
    multiplying by its reciprocal round apart: every key of a group at one
    dot product r0 = a * b (half the keys elsewhere), s1 from
    `boundary_s1`; one-tile (4 groups of 40 keys), contiguous (10 groups of
    64 keys) and paged (10 slots of two 32-key pages), D 32 and 128."""
    gen = np.random.default_rng(SEED + 11)
    out = []
    for d in (32, 128):
        for layout in ("one-tile", "contiguous", "paged"):
            while True:
                a, b = (int(x) for x in gen.integers(20, 128, 2))
                s1 = boundary_s1(d, a * b, int(gen.integers(-120, 120)))
                if s1 is not None:
                    break
            G, sk = (4, 40) if layout == "one-tile" else (10, 64)
            name = f"boundary {layout} sqrt-d D {d}"
            if layout == "paged":
                c = attention_case(name, n_slots=G, gps=1, sq=2, d=d,
                                   page_size=32, max_pages=2, mode="pot",
                                   lens=[sk] * G, sqrt_d=d)
            else:
                c = contiguous_case(name, G=G, sq=2, sk=sk, d=d, mode="pot",
                                    sqrt_d=d)
            keys = np.zeros((G, sk), np.int8)
            keys[:, :] = b
            keys[:, sk // 2:] = gen.integers(-128, 128, (G, sk - sk // 2))
            c["q"].zero_()
            c["q"][:, :, 0] = a
            if layout == "paged":  # the slots' pages, in table order
                k = c["k"]
                k.zero_()
                bt = c["bt"].long().cpu().numpy()
                for g in range(G):
                    for j in range(2):
                        k[int(bt[g, j]), :, 0] = torch.from_numpy(
                            keys[g, 32 * j: 32 * (j + 1)].copy())
            else:
                c["k"].zero_()
                c["k"][:, :, 0] = torch.from_numpy(keys)
            c["s1"] = torch.tensor(s1, device=c["q"].device)
            out.append(c)
    return out


def wide_head_cases() -> list:
    """Head dims at the CUDA kernels' limit: D 256 (the paged chunk takes
    two PROB . V sweeps, a warp holding a row tile alone) and D 36 with the
    division by sqrt(36) (q, k and v padded to a multiple of 4)."""
    return [
        attention_case("paged edge D 256 chunk 64 rows", n_slots=4, gps=8,
                       sq=64, d=256, page_size=64, max_pages=8, mode="pot",
                       lens=[512, 65, 300, 0], chunk_mask=True),
        attention_case("paged edge D 256 gqa decode", n_slots=8, gps=4,
                       sq=2, d=256, page_size=64, max_pages=16, mode="pot",
                       lens=[1024, 1, 700, 64, 0, 333, 900, 128]),
        contiguous_case("contiguous edge D 256 causal 70 rows", G=8, sq=70,
                        sk=600, d=256, mode="pot_fine", causal=True,
                        q_offset=530),
        contiguous_case("contiguous edge D 256 decode lens", G=32, sq=1,
                        sk=1024, d=256, mode="pot",
                        lens=list(range(0, 1024, 32))),
        contiguous_case("one-tile edge D 256", G=8, sq=8, sk=512, d=256,
                        mode="uniform", kv_len=400),
        contiguous_case("contiguous edge D 36 sqrt-d", G=12, sq=5, sk=700,
                        d=36, mode="pot", masked_rows=(1,), sqrt_d=36),
        attention_case("paged edge D 36 sqrt-d", n_slots=3, gps=4, sq=1,
                       d=36, page_size=32, max_pages=8, mode="pot",
                       lens=[0, 17, 250], sqrt_d=36),
    ]


def head_dim_320_cases(gen, mode) -> list:
    """gemma3-4b's head dim 320 on its serving path (8 heads over 4 KV
    heads, window 1024, the pool's 8 slots, max_len 2048): the pool's
    admission prefill (G 8, 1024 x 1024, the local mask and a left-pad mask
    together; at a pinned width of one window the band cuts nothing), a
    solo prompt past the window (1536 x 1536, the banded mask alone, which
    drops the keys a window behind each row), the pool's GQA decode (G 32 = 8 slots x 4 KV
    heads, 2 query rows, per-group lengths with zeros) over a 1024-key ring
    and over 2048 keys; then the paged decode and chunk and the one-tile
    kernel at D 320, which gemma3-4b's path does not reach."""
    d, tag = 320, f"D 320 {mode}"
    ring = gen.integers(0, 1025, 32).tolist()
    ring[3] = ring[17] = 0
    ring[5] = 1024
    full = gen.integers(0, 2049, 32).tolist()
    full[9] = 0
    slots, mp, ps = 8, 16, 64
    return [
        contiguous_case(f"gemma3 pool prefill local band + pad {tag}", G=8,
                        sq=1024, sk=1024, d=d, mode=mode, heads=8,
                        pad=[int(gen.integers(1, 896))], causal=True,
                        window=1024),
        contiguous_case(f"gemma3 solo prefill 1536 local band {tag}", G=8,
                        sq=1536, sk=1536, d=d, mode=mode, heads=8, pad=[0],
                        causal=True, window=1024),
        contiguous_case(f"gemma3 pool decode ring 1024 lens {tag}", G=32,
                        sq=2, sk=1024, d=d, mode=mode, lens=ring),
        contiguous_case(f"gemma3 pool decode 2048 lens {tag}", G=32, sq=2,
                        sk=2048, d=d, mode=mode, lens=full),
        attention_case(f"paged decode {tag}", n_slots=slots, gps=4, sq=2,
                       d=d, page_size=ps, max_pages=mp, mode=mode,
                       lens=gen.integers(1, mp * ps + 1, slots).tolist()),
        attention_case(f"paged chunk {tag}", n_slots=slots, gps=8, sq=64,
                       d=d, page_size=ps, max_pages=mp, mode=mode,
                       lens=gen.integers(64, mp * ps + 1, slots).tolist(),
                       chunk_mask=True),
        contiguous_case(f"one-tile gqa decode {tag}", G=4, sq=2, sk=512,
                        d=d, mode=mode, lens=[512, 0, 301, 77]),
    ]


def rep6_cases(gen, mode) -> list:
    """GQA at 6 query heads a KV head, the two MoE models' (mixtral-8x22b
    48:8, llama4-scout-17b-a16e 40 heads padded to 48 over 8), D 128: the
    mixtral pool's decode (8 slots x 8 groups, 6 rows, 2048-key rings,
    per-group lengths with zeros) and admission prefill (48 heads, 1024 x
    1024, the local mask (window 4096) and a left-pad mask together), then
    llama4's paged GQA decode (8 slots x 8 groups, 6 rows, 16 pages of 64
    keys, a zero-length slot) and its flat paged chunk (48 heads a slot,
    64 rows)."""
    tag = f"rep 6 {mode}"
    lens = gen.integers(0, 2049, 64).tolist()
    lens[7] = lens[40] = 0
    lens[12] = 2048
    slots, mp, ps = 8, 16, 64
    paged = gen.integers(1, mp * ps + 1, slots).tolist()
    paged[2] = 0
    return [
        contiguous_case(f"mixtral pool decode 2048 lens {tag}", G=64, sq=6,
                        sk=2048, d=128, mode=mode, lens=lens),
        contiguous_case(f"mixtral pool prefill local + pad {tag}", G=48,
                        sq=1024, sk=1024, d=128, mode=mode, heads=48,
                        pad=[int(gen.integers(1, 896))], causal=True,
                        window=4096),
        attention_case(f"llama4 paged gqa decode {tag}", n_slots=slots,
                       gps=8, sq=6, d=128, page_size=ps, max_pages=mp,
                       mode=mode, lens=paged),
        attention_case(f"llama4 paged chunk {tag}", n_slots=slots, gps=48,
                       sq=64, d=128, page_size=ps, max_pages=mp, mode=mode,
                       lens=gen.integers(64, mp * ps + 1, slots).tolist(),
                       chunk_mask=True),
    ]


def rep4_cases(gen, mode) -> list:
    """GQA at 4 query heads a KV head, jamba-v0.1-52b's attention layer (32
    heads over 8 KV heads of 128, no positional embedding, global): the
    pool's decode (8 slots x 8 groups, 4 rows, 2048 keys, per-group lengths
    with zeros and one full group) and its admission prefill (32 heads, 1024
    x 1024, causal with a left-pad mask, no local band)."""
    tag = f"rep 4 {mode}"
    lens = gen.integers(0, 2049, 64).tolist()
    lens[5] = lens[33] = 0
    lens[20] = 2048
    return [
        contiguous_case(f"jamba pool decode 2048 lens {tag}", G=64, sq=4,
                        sk=2048, d=128, mode=mode, lens=lens),
        contiguous_case(f"jamba pool prefill pad {tag}", G=32, sq=1024,
                        sk=1024, d=128, mode=mode, heads=32,
                        pad=[int(gen.integers(1, 896))], causal=True),
    ]


def encoder_cases(gen, mode) -> list:
    """The encoder families' calls, D 64 unless named: bert-large's
    bidirectional attention (8 sequences x 16 heads, 384 x 384, the all-true
    mask array, one row per sequence), whisper-tiny's encoder (6 heads,
    1500 x 1500: three key blocks of 512, the last with 476 real keys, six
    row blocks of 256) and its cross attention over the 1500 encoder keys
    at a 64-token prefill and at a decode step (Sq 1, two-pass); then
    qwen2-vl-2b's paged calls at D 128, 12 heads over 2 KV heads: the GQA
    decode (8 slots x 2 groups of 6 rows, 16 pages of 64 keys, a zero-length
    slot) and the flat 64-row chunk (12 heads a slot)."""
    slots, mp, ps = 8, 16, 64
    lens = gen.integers(1, mp * ps + 1, slots).tolist()
    lens[5] = 0
    return [
        contiguous_case(f"bert-large bidir 384 {mode}", G=128, sq=384,
                        sk=384, d=64, mode=mode, heads=16, pad=[0] * 8),
        contiguous_case(f"whisper encoder bidir 1500 {mode}", G=6, sq=1500,
                        sk=1500, d=64, mode=mode, heads=6, pad=[0]),
        contiguous_case(f"whisper cross prefill 64 x 1500 {mode}", G=6,
                        sq=64, sk=1500, d=64, mode=mode, heads=6, pad=[0]),
        contiguous_case(f"whisper cross decode 1 x 1500 {mode}", G=6, sq=1,
                        sk=1500, d=64, mode=mode, heads=6, pad=[0]),
        attention_case(f"qwen2-vl paged gqa decode rep 6 {mode}",
                       n_slots=slots, gps=2, sq=6, d=128, page_size=ps,
                       max_pages=mp, mode=mode, lens=lens),
        attention_case(f"qwen2-vl paged chunk {mode}", n_slots=slots,
                       gps=12, sq=64, d=128, page_size=ps, max_pages=mp,
                       mode=mode, chunk_mask=True,
                       lens=gen.integers(64, mp * ps + 1, slots).tolist()),
    ]


def phase_kernels(device_desc: str) -> list:
    rows = []
    extra = []
    for mode in ("pot", "pot_fine", "uniform"):
        extra += encoder_cases(np.random.default_rng(SEED + 20), mode)
    for mode in ("pot", "pot_fine", "uniform"):
        extra += rep4_cases(np.random.default_rng(SEED + 19), mode)
    for mode in ("pot", "pot_fine", "uniform"):
        extra += rep6_cases(np.random.default_rng(SEED + 18), mode)
    gen = np.random.default_rng(SEED + 1)
    for mode in ("pot", "pot_fine", "uniform"):
        extra += head_dim_320_cases(gen, mode)
    extra.append(contiguous_case(
        "gemma3 pool decode ring 1024 D 320 sqrt-d", G=32, sq=2, sk=1024,
        d=320, mode="pot", lens=gen.integers(0, 1025, 32).tolist(),
        sqrt_d=320))
    for d in (32, 128):
        for mode in ("pot", "pot_fine", "uniform"):
            extra += sqrt_d_cases(gen, d, mode)
    extra += boundary_cases() + wide_head_cases()
    for c in extra:
        r = (check_attention_case(c) if "bt" in c
             else check_contiguous_case(c))
        report_case(c["name"], r, device_desc)
        rows.append(dict(case=c["name"], **r))
    for mode in ("pot", "pot_fine", "uniform"):
        cases = paged_main_cases(gen, mode)
        if mode == "pot":
            cases += paged_edge_cases()
        for c in cases:
            r = check_attention_case(c)
            report_case(c["name"], r, device_desc)
            rows.append(dict(case=c["name"], **r))
        contiguous = contiguous_main_cases(gen, mode)
        if mode == "pot":
            contiguous += contiguous_edge_cases()
        for c in contiguous:
            r = check_contiguous_case(c)
            report_case(c["name"], r, device_desc)
            rows.append(dict(case=c["name"], **r))
    return rows


# ------------------------------------ phase 3: LUT, MVM and softmax kernels

# the TPU kernel each of this slice's kernels replaces
NEW_KERNELS = {"acam_lut": "src/repro/kernels/acam_lut.py:25",
               "acam_mvm": "src/repro/kernels/acam_mvm.py:32",
               "acam_softmax": "src/repro/kernels/acam_softmax.py:27"}
LUT_SHAPES = (("gpt2-large gelu", "gelu", 512, 5120),
              ("command-r silu", "silu", 256, 22528))
MVM_SHAPES = (("gpt2-large fc1", 512, 1280, 5120),
              ("gpt2-large fc2", 512, 5120, 1280),
              ("gpt2-large decode fc1", 8, 1280, 5120))
# shapes off every tile multiple, bk 64 at fc1, bk 100 (a crossbar tile
# padded to 128 in shared memory); fc2 and the decode shapes split K
MVM_EDGE = (("edge", 77, 1000, 203, None), ("gpt2-large fc1 bk 64", 512,
                                             1280, 5120, 64),
            ("edge bk 100", 40, 700, 96, 100))
SOFTMAX_SHAPES = (("gpt2-large staged prefill", 20, 512, 512),
                  ("gpt2-large decode at n_ctx", 160, 1, 1024))


def bound_of(launches) -> tuple[float, str]:
    """Least time of a call's launches (`kernels/cost.py`): bytes over 3.35
    TB/s against int8 operations over 1979 TOP/s."""
    from repro_torch.kernels import cost
    return cost.bound_ms(*cost.total(launches))


def check_codes_case(kernel_name, kernel, launch, plain, bound, library=None):
    """An int32-codes kernel: the wrapper ``kernel()`` against ``plain()``
    bit for bit (one launch counted), its launch function ``launch()``
    against the wrapper, the library call (if any) against both; then the
    times, as `compare_and_time`."""
    counts = launch_counts
    before = counts()[kernel_name]
    got = kernel()
    check(counts()[kernel_name] == before + 1,
          f"{kernel_name} was not the kernel launched")
    want = plain()
    got_l = launch()
    torch.cuda.synchronize()
    diff = (got.long() - want.long()).abs().max().item()
    check(diff == 0, f"{kernel_name}: differs from plain by {diff}")
    check(torch.equal(got_l, got),
          f"{kernel_name}: the launch function differs from the wrapper")
    ms, host_free = device_ms(launch, 20)
    wrapper_ms = cuda_ms(kernel, 20)
    plain_ms, plain_host_free = device_ms(plain, 1, reps=3)
    plain_call_ms = cuda_ms(plain, 3, warmup=1)
    library_ms = None
    if library is not None:
        check(torch.equal(library().to(torch.int32), got),
              f"{kernel_name}: the library call computes something else")
        library_ms = device_ms(library, 20)[0]
    return dict(kernel=kernel_name, max_abs_err=float(diff), ms=ms,
                ms_host_free=host_free, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, plain_host_free=plain_host_free,
                plain_call_ms=plain_call_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=library_ms)


def report_codes_case(name, r, device_desc):
    gaps = lambda ok: "" if ok else ", host gaps included"
    lib = ("no library call computes this function"
           if r["library_ms"] is None
           else f"library call {r['library_ms']:.4f} ms")
    print(f"[kernels] {name} ({r['kernel']}): equal to plain; kernel device "
          f"{r['ms']:.4f} ms (CUDA events{gaps(r['ms_host_free'])}; wrapper "
          f"call {r['wrapper_ms']:.4f} ms), plain device {r['plain_ms']:.3f} "
          f"ms{gaps(r['plain_host_free'])} (call {r['plain_call_ms']:.3f} "
          f"ms), bound {1e3 * r['bound_ms']:.3f} us ({r['bound_by']}); {lib} "
          f"({device_desc})", flush=True)


def lut_cases(gen):
    """(name, codes, table, bias) at the activation shapes, int32 codes (as
    acam_activation passes them) and int8."""
    from repro_torch.core import ops as acam_ops
    for name, op_name, rows, cols in LUT_SHAPES:
        op = acam_ops.get_op(op_name)
        x = torch.from_numpy(gen.normal(0, 1.5, (rows, cols)).astype(
            np.float32)).to(DEVICE)
        codes = op.in_fmt.encode(x)
        for dtype in (torch.int32, torch.int8):
            yield (f"{name} ({rows}, {cols}) {str(dtype)[6:]}",
                   codes.to(dtype), op.lut(DEVICE),
                   1 << (op.in_fmt.bits - 1))


def check_lut_case(x, lut, bias):
    from repro_torch.kernels import acam_lut as L, cost
    n = x.numel()
    bound = bound_of(cost.lut(n, x.element_size(), lut.numel()))
    return check_codes_case(
        "acam_lut", lambda: L.acam_lut_2d(x, lut, bias),
        lambda: L._launch(x, lut, bias),
        lambda: L.acam_lut_plain(x, lut, bias), bound,
        library=lambda: lut[x.long() + bias])


def xbar_configs():
    from repro_torch.core.crossbar import CrossbarConfig
    return (("exact", CrossbarConfig()),
            ("quantize adc 8", CrossbarConfig(adc_mode="quantize")),
            ("quantize adc 6", CrossbarConfig(adc_mode="quantize",
                                              adc_bits=6)))


def check_mvm_case(x, w, cfg, bk=None):
    from repro_torch.core.crossbar import adc_step
    from repro_torch.kernels import acam_mvm as M, cost
    m, k = x.shape
    n = w.shape[1]
    planes = (1 if adc_step(cfg, cfg.rows) is None
              else cfg.num_input_slices * cfg.num_weight_slices)
    bound = bound_of(cost.mvm(m, k, n, planes))
    library = None
    if planes == 1 and m > 16 and k % 8 == 0 and n % 8 == 0:
        library = lambda: torch._int_mm(x, w)
    bk = bk or cfg.rows
    return check_codes_case(
        "acam_mvm", lambda: M.acam_mvm(x, w, cfg, bk=bk),
        lambda: M._launch(x, w, cfg, bk),
        lambda: M.acam_mvm_plain(x, w, cfg, bk), bound, library=library)


def softmax_rows(gen, heads, queries, keys):
    """LOGIT codes of ``heads * queries`` rows of ``keys`` keys, the
    logits of a few LOGIT units; with several queries, query i of each head
    attends keys <= i (the rest at the LOGIT minimum, as the div-add stage
    writes masked keys)."""
    from repro_torch.core.ops import LOGIT_FMT
    x = torch.from_numpy(gen.normal(0, 3, (heads, queries, keys)).astype(
        np.float32)).to(DEVICE)
    codes = LOGIT_FMT.encode(x)
    if queries > 1:
        causal = (torch.arange(keys, device=DEVICE)[None, :]
                  <= torch.arange(queries, device=DEVICE)[:, None])
        codes = torch.where(causal[None], codes,
                            torch.full_like(codes, LOGIT_FMT.code_min))
    return codes.reshape(heads * queries, keys)


def check_softmax_case(codes, mode):
    from repro_torch.kernels import acam_softmax as S, cost
    n = codes.numel()
    bound = bound_of(cost.softmax(n, codes.element_size()))
    return check_codes_case(
        "acam_softmax", lambda: S.acam_softmax_codes(codes, mode),
        lambda: S._launch(codes, mode),
        lambda: S.acam_softmax_codes_plain(codes, mode), bound)


def phase_kernels_new(device_desc: str) -> list:
    gen = np.random.default_rng(SEED + 6)
    rows = []

    def record(case, r):
        report_codes_case(case, r, device_desc)
        rows.append(dict(case=case, **r))
    for case, x, lut, bias in lut_cases(gen):
        record(case, check_lut_case(x, lut, bias))
    for name, m, k, n in MVM_SHAPES:
        x = torch.from_numpy(gen.integers(-128, 128, (m, k), dtype=np.int8)
                             ).to(DEVICE)
        w = torch.from_numpy(gen.integers(-128, 128, (k, n), dtype=np.int8)
                             ).to(DEVICE)
        for label, cfg in xbar_configs():
            record(f"{name} ({m}, {k}) x ({k}, {n}) {label}",
                   check_mvm_case(x, w, cfg))
    for name, m, k, n, bk in MVM_EDGE:
        x = torch.from_numpy(gen.integers(-128, 128, (m, k), dtype=np.int8)
                             ).to(DEVICE)
        w = torch.from_numpy(gen.integers(-128, 128, (k, n), dtype=np.int8)
                             ).to(DEVICE)
        for label, cfg in xbar_configs():
            record(f"{name} ({m}, {k}) x ({k}, {n}) {label}",
                   check_mvm_case(x, w, cfg, bk))
    # unsliced 8-bit DAC and cells: plane sums past 2^22, the ADC's
    # conversion path (csrc/acam_mvm.cu adc)
    from repro_torch.core.crossbar import CrossbarConfig
    record(f"edge ({m}, {k}) x ({k}, {n}) quantize dac 8 cell 8",
           check_mvm_case(x, w, CrossbarConfig(adc_mode="quantize",
                                               dac_bits=8, cell_bits=8), bk))
    for name, heads, queries, keys in SOFTMAX_SHAPES:
        codes = softmax_rows(gen, heads, queries, keys)
        for mode in ("pot", "pot_fine", "uniform"):
            record(f"{name} ({codes.shape[0]}, {keys}) {mode}",
                   check_softmax_case(codes, mode))
    return rows


# ------------------------------------ phase 3: the paged operand prolog

# gpt2-large's paged serving pool (1 + 32 x 16 pages of 64 rows, 20 heads
# of 64), the gpt2l-long cell's
PROLOG_POOL = dict(n_slots=32, max_pages=16, page_size=64, kv_heads=20,
                   head_dim=64)


def prolog_case(name, gen, sq):
    """The pool with 32 slots of 200..1000 keys on shuffled pages, +-1e4 in
    every row no slot reads (freed pages, dead rows, the trash page), and
    float32 q of ``sq`` rows a slot as the serving layer passes it (a
    (B, Sq, H, hd) tensor transposed): a decode call (1) or a chunk (256)."""
    n_slots, mp, ps, KV, hd = (PROLOG_POOL[k] for k in (
        "n_slots", "max_pages", "page_size", "kv_heads", "head_dim"))
    n_pages = 1 + n_slots * mp
    lens = gen.integers(200, 1001, n_slots)
    tg = torch.Generator(device=DEVICE).manual_seed(int(gen.integers(2 ** 31)))
    stale = lambda: 1e4 * (2 * torch.randint(
        0, 2, (n_pages, ps, KV, hd), generator=tg, device=DEVICE) - 1
    ).float()
    k, v = stale(), stale()
    order = gen.permutation(np.arange(1, n_pages))
    bt = np.zeros((n_slots, mp), np.int64)
    for b, ln in enumerate(lens):
        for j in range(-(-int(ln) // ps)):
            bt[b, j] = order[b * mp + j]
            lv = min(ps, int(ln) - j * ps)
            for pool in (k, v):
                pool[bt[b, j], :lv] = 1.5 * torch.randn(
                    (lv, KV, hd), generator=tg, device=DEVICE)
    q = 1.5 * torch.randn((n_slots, sq, KV, hd), generator=tg, device=DEVICE)
    return dict(name=name, q=q.transpose(1, 2), k=k, v=v,
                bt=torch.as_tensor(bt, dtype=torch.int32, device=DEVICE),
                lens=torch.as_tensor(lens, dtype=torch.int32,
                                     device=DEVICE))


def prolog_bounds(c) -> dict:
    """The prolog's least time: from the shapes (`cost.paged_prolog`, every
    block-table entry live), and from the live rows (each live float32 K/V
    byte and q read once; q's codes and the code rows of the named pages
    and the trash page written once)."""
    from repro_torch.kernels import cost
    n_pages, ps, KV, hd = c["k"].shape
    n_slots, mp = c["bt"].shape
    n_q, row = c["q"].numel(), KV * hd
    static = cost.bound_ms(*cost.total(cost.paged_prolog(
        n_q, n_slots, mp, n_pages, ps, row, 1, 4)))
    named = int(torch.unique(c["bt"]).numel())  # the trash page among them
    live = int(c["lens"].sum())
    nbytes = (5 * n_q + 2 * 4 * live * row + 2 * named * ps * row
              + 4 * c["bt"].numel() + 4 * n_slots)
    return dict(bound_ms=cost.bound_ms(nbytes, 0)[0],
                static_bound_ms=static[0], live_rows=live,
                named_pages=named)


def check_prolog_case(c) -> dict:
    """The wrapper (`ops._paged_operands`, two launches) against the plain
    version on the same card: q's codes, the code rows of every page the
    block table names, the three scales and amaxes, bit for bit; the
    launch function against the wrapper; then the times, as
    `check_codes_case`."""
    from repro_torch.kernels import acam_prolog
    from repro_torch.kernels import ops as K
    args = (c["q"], c["k"], c["v"], c["bt"], c["lens"], 1)
    named = torch.unique(c["bt"].long())
    n_pages, KV = c["k"].shape[0], c["k"].shape[2]

    def parts(qq, kq, vq):
        rows = lambda x: x.codes.reshape(n_pages, KV, -1)[named]
        return ([qq.codes, rows(kq), rows(vq)],
                [x.view(torch.int32) for t in (qq, kq, vq)
                 for x in (t.scale, t.amax)])
    before = launch_counts()["acam_prolog"]
    got = parts(*K._paged_operands(*args))
    check(launch_counts()["acam_prolog"] == before + 2,
          "acam_prolog was not the kernel launched")
    want = parts(*K.paged_operands_plain(*args))
    launch = lambda: acam_prolog.launch_prolog(*args)
    qc, kc, vc, st = launch()
    torch.cuda.synchronize()
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        check(torch.equal(g, w), f"{c['name']}: the prolog differs from its "
                                 f"plain version")
    check(torch.equal(qc, got[0][0])
          and torch.equal(kc.reshape(n_pages, KV, -1)[named], got[0][1]),
          f"{c['name']}: the launch function differs from the wrapper")
    ms, host_free = device_ms(launch, 20)
    wrapper_ms = cuda_ms(lambda: K._paged_operands(*args), 20)
    plain = lambda: K.paged_operands_plain(*args)
    plain_ms, plain_host_free = device_ms(plain, 1, reps=3)
    plain_call_ms = cuda_ms(plain, 3, warmup=1)
    return dict(kernel="acam_prolog", max_abs_err=0.0, ms=ms,
                ms_host_free=host_free, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, plain_host_free=plain_host_free,
                plain_call_ms=plain_call_ms, bound_by="bytes",
                library_ms=None, **prolog_bounds(c))


def prolog_attribution(c) -> dict:
    """One paged decode entry call at the case's pool inside a
    ``record_function`` range, under torch.profiler with the CPU and CUDA
    activities (as `bench/entries/serve.py`'s profiler): the device ms of
    each kernel of the call, and the range's ``device_time_total``, which
    takes only the kernels the profiler ties to launches inside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import ops as K
    span = "smoke.attention"
    call = lambda: K.raceit_attention_decode_paged(
        c["q"], c["k"], c["v"], c["lens"], c["bt"], fold_scale=True)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(span):
            call()
        torch.cuda.synchronize()
    kernels: dict = {}
    span_ms = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name != span:
            kernels[e.name] = (kernels.get(e.name, 0.0)
                               + (e.time_range.end - e.time_range.start) / 1e3)
        elif e.device_type == DeviceType.CPU and e.name == span:
            span_ms += getattr(e, "device_time_total",
                               getattr(e, "cuda_time_total", 0.0)) / 1e3
    of = lambda *parts: sum(t for n, t in kernels.items()
                            if any(p in n for p in parts))
    return dict(span_device_ms=span_ms, kernels_ms=sum(kernels.values()),
                prolog_ms=of("prolog_max", "prolog_quant"),
                attention_ms=of("paged_sums", "paged_probv"),
                kernels=sorted(kernels.items(), key=lambda kv: -kv[1]))


def phase_prolog(device_desc: str) -> tuple[list, dict]:
    gen = np.random.default_rng(SEED + 30)
    rows = []
    cases = [prolog_case("gpt2-large paged prolog decode", gen, 1),
             prolog_case("gpt2-large paged prolog chunk 256", gen, 256)]
    for c in cases:
        r = check_prolog_case(c)
        print(f"[kernels] {c['name']} (acam_prolog, {r['live_rows']} live "
              f"rows on {r['named_pages']} named pages): equal to plain; "
              f"kernel device {r['ms']:.4f} ms (CUDA events"
              f"{'' if r['ms_host_free'] else ', host gaps included'}; "
              f"wrapper call {r['wrapper_ms']:.4f} ms), plain device "
              f"{r['plain_ms']:.3f} ms (call {r['plain_call_ms']:.3f} ms), "
              f"bound {1e3 * r['bound_ms']:.3f} us from the live rows, "
              f"{1e3 * r['static_bound_ms']:.3f} us from the shapes "
              f"({device_desc})", flush=True)
        rows.append(dict(case=c["name"], **r))
    att = prolog_attribution(cases[0])
    print(f"[kernels] one paged decode call in a record_function range: "
          f"its device_time_total {att['span_device_ms']:.4f} ms; the "
          f"call's kernels {att['kernels_ms']:.4f} ms, of them the prolog "
          f"{att['prolog_ms']:.4f} ms and paged_sums + paged_probv "
          f"{att['attention_ms']:.4f} ms ({device_desc})", flush=True)
    return rows, att


def phase_split_sweep(device_desc: str) -> list:
    """Every split of the pages (paged kernel, mode pot), of the keys into
    spans of runs (contiguous and one-tile kernels, mode pot) and of K (MVM
    kernel, exact and adc 8) over blocks at the main-path shapes: each
    split's result equal to the plan's, its device ms by CUDA events beside
    the split the plan picks."""
    from repro_torch.kernels import acam_attention as A
    from repro_torch.kernels import acam_mvm as M
    rows = []

    def report(what, unit, pick, times):
        print(f"[sweep] {what}: ({unit}, device ms) {times}; the plan picks "
              f"{pick} ({device_desc})", flush=True)
        rows.append(dict(case=what, unit=unit, picks=pick, ms=times))
    for c in paged_main_cases(np.random.default_rng(SEED + 1), "pot"):
        G, sq = c["q"].shape[:2]
        mp, ps = c["bt"].shape[1], c["page_size"]
        base = A.paged_plan(G, sq, mp, ps)
        mask8 = None if c["mask"] is None else c["mask"].to(torch.int8)
        kv = torch.clamp(c["kv_len"], max=mp * ps)
        launch = lambda plan: A._launch_paged(
            c["q"], c["k"], c["v"], c["s1"], mask8, kv, c["mode"], c["bt"],
            ps, c["gps"], None, plan)
        want_out, want_cmax = launch(base)
        times = []
        for per in sorted({1, 2, 3, 4, 8, mp, base.pages_per_split},
                          reverse=True):
            plan = dataclasses.replace(base, splits=-(-mp // per),
                                       pages_per_split=per)
            out, cmax = launch(plan)
            check(torch.equal(out, want_out) and int(cmax) == int(want_cmax),
                  f"paged {c['name']}: {per} pages per split differ")
            times.append((per, device_ms(lambda: launch(plan), 20,
                                         reps=3)[0]))
        report(f"paged {c['name']}", "pages per split", base.pages_per_split,
               times)
    for c in contiguous_main_cases(np.random.default_rng(SEED + 2), "pot"):
        G, sq, _ = c["q"].shape
        sk = c["k"].shape[1]
        single = A.one_tile(G, sq, sk)
        base = (A.single_plan(G, sq, sk) if single
                else A.contiguous_plan(G, sq, sk, A.key_block(sk)))
        want_out, want_cmax = contiguous_launch(c, base)()
        n = base.runs if base.blocks == 1 else base.blocks
        times = []
        for per in sorted({1, 2, 3, 4, 8, n, base.per}, reverse=True):
            plan = dataclasses.replace(base, splits=-(-n // per), per=per)
            launch = contiguous_launch(c, plan)
            out, cmax = launch()
            check(torch.equal(out, want_out) and int(cmax) == int(want_cmax),
                  f"{c['name']}: {per} runs per span differ")
            times.append((per, device_ms(launch, 20, reps=3)[0]))
        report(f"{'one-tile' if single else 'contiguous'} {c['name']}",
               "runs per span", base.per, times)
    gen = np.random.default_rng(SEED + 7)
    for name, m, k, n in MVM_SHAPES:
        x = torch.from_numpy(gen.integers(-128, 128, (m, k), dtype=np.int8)
                             ).to(DEVICE)
        w = torch.from_numpy(gen.integers(-128, 128, (k, n), dtype=np.int8)
                             ).to(DEVICE)
        for label, cfg in xbar_configs()[:2]:
            base = M.mvm_plan(m, n, k, cfg.rows, label != "exact")
            want = M._launch(x, w, cfg, cfg.rows, base)
            times = []
            for splits in sorted({1, 2, 4, 7, 10, 14, base.splits}):
                per = -(-base.n_stages // splits)
                plan = dataclasses.replace(base, stages_per_split=per,
                                           splits=-(-base.n_stages // per))
                if any(t[0] == plan.splits for t in times):
                    continue
                check(torch.equal(M._launch(x, w, cfg, cfg.rows, plan), want),
                      f"mvm {name} {label}: {plan.splits} K splits differ")
                times.append((plan.splits, device_ms(
                    lambda: M._launch(x, w, cfg, cfg.rows, plan), 20,
                    reps=3)[0]))
            report(f"mvm {name} ({m}, {k}) x ({k}, {n}) {label}", "K splits",
                   base.splits, times)
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


def serve(eng, requests, timed=False, n_slots=8):
    from repro_torch.serve import ContinuousBatcher
    cb = ContinuousBatcher(eng, n_slots=n_slots, page_size=64,
                           prefill_chunk=64)
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
    reset_launches()
    cb, secs, times, peak_pages = serve(eng, requests, timed=True)
    launches = A.launches["acam_attention_paged"]
    prolog = launch_counts()["acam_prolog"]
    for r in requests:
        done = cb.done[r.rid]
        check(done.error is None, f"request {r.rid} failed: {done.error}")
        check(len(done.result) == r.n_new == 32,
              f"request {r.rid} returned {len(done.result)} tokens")
    calls = cb.chunk_calls + cb.decode_steps
    check(launches > 0 and launches == 2 * cfg.n_layers * calls,
          f"{launches} attention launches for {calls} model calls")
    check(prolog == launches, f"{prolog} prolog launches for {calls} model "
                              f"calls")
    tokens = sum(len(cb.done[r.rid].result) for r in requests)
    res = dict(tokens=tokens, seconds=secs, tokens_per_s=tokens / secs,
               decode_steps=cb.decode_steps, chunk_calls=cb.chunk_calls,
               decode_ms=1e3 * float(np.mean(times["decode"])),
               chunk_ms=1e3 * float(np.mean(times["chunk"])),
               peak_pages=peak_pages, pages=cb.n_pages - 1,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches, prolog_launches=prolog)
    print(f"[main] gpt2-large 36L d1280 raceit_q8 paged: {tokens} tokens in "
          f"{secs:.2f} s = {res['tokens_per_s']:.1f} tok/s; "
          f"{cb.decode_steps} decode steps (mean {res['decode_ms']:.1f} ms), "
          f"{cb.chunk_calls} chunk calls (mean {res['chunk_ms']:.1f} ms); "
          f"peak pages {peak_pages}/{cb.n_pages - 1}; peak memory "
          f"{res['peak_mem_gib']:.2f} GiB; attention launches {launches} = "
          f"2 x 36 x {calls}, prolog launches {prolog} ({device_desc})",
          flush=True)
    return res, eng


def phase_profile(eng) -> dict:
    """The first 4 requests of phase 4's trace, 8 new tokens each, again
    under torch.profiler: device time by kernel over every model call, and
    the card's idle share, 1 - device busy time / wall time. The run is
    served once unprofiled first, to count its launches."""
    few = lambda: trace(eng.cfg, n_requests=4, n_new=8)
    launches = reset_launches()
    cb = serve(eng, few())[0]
    expect = dict(launches)
    res = profile_run(
        f"the first 4 requests of the phase-4 trace, 8 new tokens each "
        f"({cb.chunk_calls} chunk calls + {cb.decode_steps} decode steps)",
        lambda: serve(eng, few()),
        lambda: serve(eng, trace(eng.cfg, n_requests=1, lo=64, hi=64,
                                 n_new=2)),
        {k: expect[k] for k in KERNEL_NAMES}, top=12)
    return res


# ----------------------------------------------------------------- phase 5

def phase_agree() -> None:
    from repro_torch.kernels import acam_attention as A
    eng = build_engine(n_layers=4)
    requests = lambda: trace(eng.cfg, n_requests=3, lo=64, hi=200, n_new=8)
    cb_k, *_ = serve(eng, requests())
    kernel = A._launch_paged
    A._launch_paged = A.acam_attention_codes_plain
    try:
        cb_p, *_ = serve(eng, requests())
    finally:
        A._launch_paged = kernel
    for rid in cb_k.done:
        got = cb_k.done[rid].result.tolist()
        want = cb_p.done[rid].result.tolist()
        check(got == want, f"request {rid}: kernel {got} != plain {want}")
    print(f"[agree] 4-layer gpt2-large: kernel and plain attention give the "
          f"same tokens for {len(cb_k.done)} requests", flush=True)


# ----------------------------------------------------------- phases 6 to 8

def timed_engine(eng, times: dict):
    """Time the engine's prefill and decode calls (a synchronisation on
    each side) and check that every call's logits are finite."""
    for kind, attr in (("prefill", "_prefill"), ("decode", "_decode")):
        inner = getattr(eng, attr)

        def wrapped(*a, _inner=inner, _kind=kind, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = _inner(*a, **kw)
            torch.cuda.synchronize()
            times.setdefault(_kind, []).append(time.perf_counter() - t0)
            check(bool(torch.isfinite(logits).all()),
                  f"non-finite logits in a {_kind} call")
            return logits, cache
        setattr(eng, attr, wrapped)


def untimed_engine(eng):
    del eng._prefill, eng._decode


def shallow(eng, n_layers):
    """The same engine cut to its first ``n_layers`` layers."""
    return with_exec(eng, eng.exec_cfg, n_layers)


def with_exec(eng, exec_cfg, n_layers=None, device=None):
    """``eng``'s weights (its first ``n_layers`` layers) served by another
    plan, on ``device`` (default: the engine's)."""
    from repro_torch.serve import GenerationEngine
    cfg, params = eng.cfg, eng.params
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
        params = dict(params, blocks=params["blocks"][:n_layers])
    return GenerationEngine(cfg, params, exec_cfg, max_len=eng.max_len,
                            device=device or eng.device)


def launch_dicts():
    from repro_torch.kernels import acam_attention as A
    from repro_torch.kernels import (acam_lut, acam_mvm, acam_prolog,
                                     acam_softmax)
    return (A.launches, acam_lut.launches, acam_mvm.launches,
            acam_softmax.launches, acam_prolog.launches)


def reset_launches():
    """Set every kernel's launch count to 0; returns the attention kernels'
    counts (`launch_counts` reads all seven)."""
    for counts in launch_dicts():
        for key in counts:
            counts[key] = 0
    return launch_dicts()[0]


def launch_counts() -> dict:
    return {k: v for counts in launch_dicts() for k, v in counts.items()}


def bucket_trace(cfg, n_requests=16, lo=64, hi=448, n_new=32):
    from repro_torch.serve import Request
    gen = np.random.default_rng(SEED + 3)
    return [Request(rid, gen.integers(0, cfg.vocab_size,
                                      int(gen.integers(lo, hi + 1))
                                      ).astype(np.int32), n_new=n_new)
            for rid in range(n_requests)]


def serve_buckets(eng, requests):
    from repro_torch.serve import BatchScheduler
    sched = BatchScheduler(eng, bucket_size=4)
    for r in requests:
        sched.submit(r)
    t0 = time.perf_counter()
    done = sched.run_all()
    torch.cuda.synchronize()
    return sched, done, time.perf_counter() - t0


def phase_bucketed(device_desc: str):
    eng = build_engine()
    eng.max_len = 512
    cfg = eng.cfg
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab_size)
          == (36, 1280, 20, 50257), "gpt2-large is not at published width")
    # warm-up: one short bucket (allocator state, kernel libraries loaded)
    serve_buckets(eng, bucket_trace(cfg, n_requests=2, lo=64, hi=80, n_new=2))
    requests = bucket_trace(cfg)
    times: dict = {}
    timed_engine(eng, times)
    torch.cuda.reset_peak_memory_stats()
    launches = reset_launches()
    try:
        sched, done, secs = serve_buckets(eng, requests)
    finally:
        untimed_engine(eng)
    counts = dict(launches)
    for r in requests:
        check(len(done[r.rid].result) == r.n_new == 32,
              f"request {r.rid} returned {len(done[r.rid].result)} tokens")
    prefills = len(times["prefill"])
    calls = prefills + sched.decode_steps
    check(counts["acam_attention"] == 2 * cfg.n_layers * calls
          and counts["acam_attention_paged"] == 0
          and counts["acam_attention_single"] == 0,
          f"{counts} attention launches for {calls} model calls")
    tokens = sum(len(done[r.rid].result) for r in requests)
    res = dict(tokens=tokens, seconds=secs, tokens_per_s=tokens / secs,
               prefills=prefills, decode_steps=sched.decode_steps,
               prefill_ms=1e3 * float(np.mean(times["prefill"])),
               decode_ms=1e3 * float(np.mean(times["decode"])),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=counts)
    print(f"[bucketed] gpt2-large 36L d1280 raceit_q8, buckets of 4, "
          f"max_len 512: {tokens} tokens in {secs:.2f} s = "
          f"{res['tokens_per_s']:.1f} tok/s; {prefills} prefills (mean "
          f"{res['prefill_ms']:.1f} ms), {sched.decode_steps} decode steps "
          f"(mean {res['decode_ms']:.1f} ms); peak memory "
          f"{res['peak_mem_gib']:.2f} GiB; contiguous attention launches "
          f"{counts['acam_attention']} = 2 x 36 x {calls} ({device_desc})",
          flush=True)
    return res, eng


def build_command_r(n_layers=8, device="cuda"):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ExecConfig
    from repro_torch.models import Model, quantize_model_params
    from repro_torch.serve import GenerationEngine
    cfg = get_config("command-r-35b").replace(
        param_dtype="float32", compute_dtype="float32", n_layers=n_layers)
    model = Model(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = quantize_model_params(model.init(gen))
    return GenerationEngine(cfg, params, ExecConfig.serving(mode="raceit"),
                            max_len=512, device=device)


def solo_prompts(cfg, n=4, lo=64, hi=256):
    gen = np.random.default_rng(SEED + 4)
    return [gen.integers(0, cfg.vocab_size, int(gen.integers(lo, hi + 1))
                         ).astype(np.int32) for _ in range(n)]


def phase_solo(device_desc: str):
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_command_r()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    cfg = eng.cfg
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
           cfg.d_ff, cfg.vocab_size) == (8192, 64, 8, 128, 22528, 256000),
          "command-r-35b is not at published width")
    print("[solo] plan:\n" + eng.explain_plan(), flush=True)
    eng.generate(solo_prompts(cfg, n=1, lo=64, hi=64)[0][None], 2)  # warm-up
    prompts = solo_prompts(cfg)
    times: dict = {}
    timed_engine(eng, times)
    per_request, outs = [], []
    t0 = time.perf_counter()
    try:
        for p in prompts:
            launches = reset_launches()
            outs.append(eng.generate(p[None], 32)[0])
            per_request.append(dict(launches))
    finally:
        untimed_engine(eng)
    secs = time.perf_counter() - t0
    for p, out, counts in zip(prompts, outs, per_request):
        check(out.shape == (32,) and (0 <= out).all()
              and (out < cfg.vocab_size).all(), "bad solo tokens")
        # every decode step: the one-tile kernel once per layer; the
        # prefill: the two-pass kernel twice per layer
        check(counts == {"acam_attention_paged": 0,
                         "acam_attention": 2 * cfg.n_layers,
                         "acam_attention_single": 31 * cfg.n_layers},
              f"solo prompt of {len(p)} tokens launched {counts}")
    tokens = 32 * len(prompts)
    res = dict(tokens=tokens, seconds=secs, tokens_per_s=tokens / secs,
               init_s=init_s, init_peak_mem_gib=init_peak,
               prompt_lens=[len(p) for p in prompts],
               prefill_ms=1e3 * float(np.mean(times["prefill"])),
               decode_ms=1e3 * float(np.mean(times["decode"])),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches={k: sum(c[k] for c in per_request)
                         for k in per_request[0]})
    print(f"[solo] command-r-35b 8 of 40 layers, d8192, raceit_q8 "
          f"(init {init_s:.1f} s): prompts {res['prompt_lens']}, {tokens} "
          f"tokens in {secs:.2f} s = {res['tokens_per_s']:.1f} tok/s; "
          f"prefill mean {res['prefill_ms']:.1f} ms, decode step mean "
          f"{res['decode_ms']:.1f} ms; peak memory {res['peak_mem_gib']:.2f} "
          f"GiB serving, {init_peak:.2f} GiB at init; launches "
          f"{res['launches']} ({device_desc})", flush=True)
    return res, eng


def profile_run(what, fn, warm, expect: dict, top: int = 8,
                named: dict = None) -> dict:
    """``fn()`` under torch.profiler: device time by kernel, the card's
    idle share (1 - device busy / wall) and the attention kernels' share;
    ``named`` maps a label to a set of device kernel names whose time is
    summed into one row. A trace counts only if the profiler saw exactly
    the ``expect`` launches per kernel (two tries); else its numbers are
    not measured."""
    rows, wall, seen, complete = profiled_complete(fn, warm, expect)
    if not complete or not rows:  # an empty trace sees no launch either
        print(f"[profile] {what}: not measured; in two tries torch.profiler "
              f"recorded at last {seen} attention launches, the counters "
              f"{expect}", flush=True)
        return dict(measured=False, wall_ms=1e3 * wall, launches_seen=seen)
    busy_ms = sum(r[1] for r in rows)
    attn_ms = launches_seen(rows)[1]
    res = dict(measured=True, wall_ms=1e3 * wall, device_busy_ms=busy_ms,
               idle_share=1 - busy_ms / (1e3 * wall), attention_ms=attn_ms,
               attention_share=sum(attn_ms.values()) / busy_ms,
               launches=sum(n for _, _, n in rows),
               top=[dict(kernel=k[:90], ms=ms, count=n, share=ms / busy_ms)
                    for k, ms, n in rows[:top]])
    print(f"[profile] {what}: wall {res['wall_ms']:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, {res['launches']} kernel launches, idle share "
          f"{res['idle_share']:.3f}; attention "
          f"kernels {sum(attn_ms.values()):.1f} ms = "
          f"{res['attention_share']:.3f} of busy ({seen})", flush=True)
    for r in res["top"]:
        print(f"[profile]   {r['ms']:9.2f} ms {r['share']:6.3f} "
              f"{r['count']:7d}x  {r['kernel']}", flush=True)
    for label, names in (named or {}).items():
        hit = [(ms, n) for k, ms, n in rows if k in names]
        ms = sum(m for m, _ in hit)
        res[label] = dict(ms=ms, count=sum(n for _, n in hit),
                          share=ms / busy_ms, kernels=len(hit))
        print(f"[profile]   {label}: {ms:.2f} ms = {ms / busy_ms:.3f} of "
              f"busy, {res[label]['count']} launches of {len(hit)} kernels",
              flush=True)
    return res


def phase_profile_contiguous(gpt2, command_r) -> dict:
    """The first bucket of phase 6 and the first prompt of phase 7 again,
    under torch.profiler."""
    L = gpt2.cfg.n_layers
    bucket = bucket_trace(gpt2.cfg)[:4]
    warm_b = lambda: serve_buckets(
        gpt2, bucket_trace(gpt2.cfg, n_requests=2, lo=64, hi=80, n_new=2))
    res = {"bucket": profile_run(
        "one bucket of phase 6 (4 requests, 1 prefill + 31 decode steps)",
        lambda: serve_buckets(gpt2, bucket), warm_b,
        {"acam_attention_paged": 0, "acam_attention": 2 * L * 32,
         "acam_attention_single": 0})}
    L = command_r.cfg.n_layers
    p = solo_prompts(command_r.cfg)[0]
    warm_s = lambda: command_r.generate(p[None, :64], 2)
    res["solo"] = profile_run(
        f"one solo prompt of phase 7 ({len(p)} tokens, 32 new)",
        lambda: command_r.generate(p[None], 32), warm_s,
        {"acam_attention_paged": 0, "acam_attention": 2 * L,
         "acam_attention_single": 31 * L})
    return res


def swapped_to_plain(fn):
    """Run ``fn()`` with the contiguous and one-tile kernels swapped for
    their plain versions."""
    from repro_torch.kernels import acam_attention as A
    kernels = (A._launch_contiguous, A._launch_single)
    A._launch_contiguous = A.acam_attention_contiguous_plain
    A._launch_single = A.acam_attention_single_plain
    try:
        return fn()
    finally:
        A._launch_contiguous, A._launch_single = kernels


def phase_agree_contiguous(gpt2, command_r) -> None:
    eng = shallow(gpt2, 4)
    requests = lambda: bucket_trace(eng.cfg, n_requests=4, lo=64, hi=200,
                                    n_new=8)
    _, done_k, _ = serve_buckets(eng, requests())
    _, done_p, _ = swapped_to_plain(lambda: serve_buckets(eng, requests()))
    for rid in done_k:
        got, want = done_k[rid].result.tolist(), done_p[rid].result.tolist()
        check(got == want, f"bucketed request {rid}: kernel {got} != plain "
                           f"{want}")
    eng = shallow(command_r, 2)
    prompts = solo_prompts(eng.cfg, n=2, lo=64, hi=160)
    for p in prompts:
        got = eng.generate(p[None], 8)[0].tolist()
        want = swapped_to_plain(lambda: eng.generate(p[None], 8))[0].tolist()
        check(got == want, f"solo prompt of {len(p)}: kernel {got} != plain "
                           f"{want}")
    print(f"[agree] 4-layer gpt2-large buckets ({len(done_k)} requests) and "
          f"2-layer command-r-35b solo ({len(prompts)} prompts): kernels "
          f"and plain attention give the same tokens", flush=True)


# ----------------------------------------------------------- phase 9

def phase_kernel_api(device_desc: str) -> dict:
    """The public kernel API on CUDA tensors at the phase-3 shapes; every
    count is set to 0 just before and read just after."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops as K
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=DEVICE)
    small = {}
    reset_launches()
    t0 = time.perf_counter()
    for name, op_name, rows, cols in LUT_SHAPES:
        x = randn(rows, cols)
        y = K.acam_activation(x, op_name)
        ref = (F.gelu(x, approximate="tanh") if op_name == "gelu"
               else F.silu(x))
        inside = x.abs() < 3.9  # the table's input range is [-4, 3.97]
        err = (y - ref).abs()[inside].max().item()
        check(y.shape == x.shape and bool(torch.isfinite(y).all())
              and err < 0.15, f"acam_activation {op_name}: error {err}")
        small[f"activation {op_name}"] = (x[:4], lambda t, o=op_name:
                                          K.acam_activation(t, o))
    for name, m, k, n in MVM_SHAPES:
        x = randn(m, k)
        w = randn(k, n) * 0.02
        for label, cfg in xbar_configs():
            y = K.raceit_linear(x, w, cfg)
            check(y.shape == (m, n) and bool(torch.isfinite(y).all()),
                  f"raceit_linear {name} {label}: bad output")
            if label == "exact":
                ref = x @ w
                rel = ((y - ref).abs().max() / ref.abs().max()).item()
                check(rel < 0.05, f"raceit_linear {name}: relative error "
                                  f"{rel}")
        small[f"linear {name}"] = (
            x[:8], lambda t, w=w: torch.cat(
                [K.raceit_linear(t, w.to(t.device), c) for _, c in
                 xbar_configs()], dim=1))
    for name, heads, queries, keys in SOFTMAX_SHAPES:
        logits = randn(heads * queries, keys) * 3
        for mode in ("pot", "pot_fine", "uniform"):
            p = K.acam_softmax_kernel(logits, mode)
            check(p.shape == logits.shape and bool((p >= 0).all())
                  and bool((p < 1).all()), f"acam_softmax_kernel {name} "
                                           f"{mode}: bad output")
        small[f"softmax {name}"] = (logits[:16], lambda t: torch.cat(
            [K.acam_softmax_kernel(t, m) for m in ("pot", "pot_fine")]))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    for kernel in NEW_KERNELS:
        check(counts[kernel] > 0, f"{kernel} was not launched by the kernel "
                                  f"API")
    # small inputs: the card's kernels against the CPU's plain versions
    for what, (t, fn) in small.items():
        got, want = fn(t), fn(t.cpu())
        check(torch.equal(got.cpu(), want), f"{what}: the card and the "
                                            f"CPU's plain path differ")
    launches = {k: counts[k] for k in NEW_KERNELS}
    print(f"[api] acam_activation, raceit_linear (exact, adc 8, adc 6) and "
          f"acam_softmax_kernel at the phase-3 shapes in {secs:.2f} s; "
          f"launches {launches}; small inputs equal to the CPU's plain "
          f"path ({', '.join(small)}) ({device_desc})", flush=True)
    return dict(seconds=secs, launches=launches)


def phase_acam_oracle(device_desc: str) -> dict:
    """The staged oracle's Compute-ACAM emulation on the card: the 8-bit
    multiply from four 4-bit two-variable tables on all 65536 pairs, by
    table gathers (``hw=False``) and by match lines (``hw=True``), and the
    data-dependent matmul through the nibble tables; each must equal the
    integer product."""
    from repro_torch.core.attention import dd_matmul_codes
    from repro_torch.core.ops import mult8_codes
    x = torch.arange(-128, 128, dtype=torch.int32, device=DEVICE)
    X, Y = torch.meshgrid(x, x, indexing="ij")
    res = {}
    for hw in (False, True):
        t0 = time.perf_counter()
        got = mult8_codes(X, Y, hw=hw)
        torch.cuda.synchronize()
        res[f"mult8_hw_{hw}_ms"] = 1e3 * (time.perf_counter() - t0)
        check(got.is_cuda and got.dtype == torch.int32
              and torch.equal(got, X * Y),
              f"mult8_codes(hw={hw}) differs from x * y on the card")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    a = torch.randint(-128, 128, (4, 16, 64), generator=gen, device=DEVICE,
                      dtype=torch.int8)
    b = torch.randint(-128, 128, (64, 16), generator=gen, device=DEVICE,
                      dtype=torch.int8)
    got = dd_matmul_codes(a, b, fidelity="acam")
    want = (a.cpu().long() @ b.cpu().long()).to(torch.int32)
    check(got.is_cuda and torch.equal(got.cpu(), want),
          "dd_matmul_codes(fidelity='acam') differs from the integer product")
    check(torch.equal(dd_matmul_codes(a, b, fidelity="int").cpu(), want),
          "dd_matmul_codes(fidelity='int') differs from the integer product")
    print(f"[acam] mult8_codes on all 65536 pairs equal to x * y on the card "
          f"(tables {res['mult8_hw_False_ms']:.1f} ms, match lines "
          f"{res['mult8_hw_True_ms']:.1f} ms, first calls); "
          f"dd_matmul_codes(fidelity='acam') (4, 16, 64) x (64, 16) equal to "
          f"the integer product ({device_desc})", flush=True)
    return res


def phase_sqrt_d_api(device_desc: str) -> dict:
    """The float attention wrappers with the reference's default
    ``fold_scale=False`` (the kernels divide by sqrt(128)) at olmo-1b's
    head dim on the card: a causal 512-token prefill of 16 heads, a slot
    pool decode (8 slots x 16 heads of 1024 keys), a GQA decode of 48
    query heads on 4 KV heads of 512 keys (the one-tile kernel) and a paged
    decode. Counts set to 0 just before, read just after; small inputs
    equal to the CPU's plain path."""
    from repro_torch.kernels import ops as K
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=DEVICE)
    lens = torch.tensor([1024, 1, 700, 64, 0, 333, 900, 128], device=DEVICE,
                        dtype=torch.int32)
    bt = torch.arange(1, 129, device=DEVICE, dtype=torch.int32).reshape(8, 16)
    calls = {
        "fused causal prefill": (
            lambda q, k, v, n: K.raceit_attention_fused(q, k, v, causal=True),
            (randn(1, 16, 512, 128), randn(1, 16, 512, 128),
             randn(1, 16, 512, 128), None)),
        "decode_fused slot pool": (
            lambda q, k, v, n: K.raceit_attention_decode_fused(q, k, v, n),
            (randn(8, 16, 1, 128), randn(8, 16, 1024, 128),
             randn(8, 16, 1024, 128), lens)),
        "decode_gqa one tile": (
            lambda q, k, v, n: K.raceit_attention_decode_gqa(q, k, v, n),
            (randn(1, 48, 1, 128), randn(1, 4, 512, 128),
             randn(1, 4, 512, 128), torch.tensor([400], device=DEVICE))),
        "decode_paged": (
            lambda q, k, v, n: K.raceit_attention_decode_paged(
                q, k, v, n, bt.to(q.device)),
            (randn(8, 16, 1, 128), randn(129, 64, 16, 128),
             randn(129, 64, 16, 128), lens)),
    }
    reset_launches()
    t0 = time.perf_counter()
    for what, (fn, args) in calls.items():
        out = fn(*args)
        check(out.shape == args[0].shape and bool(torch.isfinite(out).all()),
              f"{what}: bad output")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k: v for k, v in launch_counts().items()
              if k in KERNEL_NAMES or k == "acam_prolog"}
    check(counts == {"acam_attention_paged": 2, "acam_attention": 4,
                     "acam_attention_single": 1, "acam_prolog": 2},
          f"the float wrappers launched {counts}")
    for what, (fn, args) in calls.items():  # the first rows, card and CPU
        if what == "decode_paged":
            small = args
        else:
            small = tuple(None if a is None else a[:1, :4] if a.ndim == 4
                          else a[:1] for a in args)
        got = fn(*small)
        want = fn(*(None if a is None else a.cpu() for a in small))
        check(torch.equal(got.cpu(), want), f"{what}: the card and the "
                                            f"CPU's plain path differ")
    print(f"[api] sqrt(d) in the kernels, D 128, fold_scale=False: "
          f"{', '.join(calls)} in {secs:.2f} s; launches {counts}; equal to "
          f"the CPU's plain path on their first rows ({device_desc})",
          flush=True)
    return dict(seconds=secs, launches=counts)


# ----------------------------------------------------------- phase 10

def staged_trace(cfg):
    from repro_torch.serve import Request
    gen = np.random.default_rng(SEED + 8)
    return [Request(rid, gen.integers(0, cfg.vocab_size,
                                      int(gen.integers(64, 257))
                                      ).astype(np.int32), n_new=16)
            for rid in range(4)]


def phase_staged(gpt2, device_desc: str) -> dict:
    """gpt2-large with staged attention (``--staged-attention``), one bucket
    of 4, against the fused path on the same prompts."""
    from repro_torch.configs.base import ExecConfig
    from repro_torch.serve import GenerationEngine
    eng = GenerationEngine(gpt2.cfg, gpt2.params, ExecConfig.serving(
        mode="raceit", fused_attention=False), max_len=gpt2.max_len,
        device=gpt2.device)
    plan = eng.plan
    check(plan.backend("attention_prefill") == "raceit_staged"
          and plan.backend("attention_decode") == "raceit_staged"
          and plan.backend("softmax") == "raceit_acam",
          "the staged plan does not stage attention:\n" + eng.explain_plan())
    print("[staged] plan:\n" + eng.explain_plan(), flush=True)
    serve_buckets(eng, bucket_trace(eng.cfg, n_requests=2, lo=64, hi=80,
                                    n_new=2))  # warm-up
    requests = staged_trace(eng.cfg)
    times: dict = {}
    timed_engine(eng, times)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        sched, done, secs = serve_buckets(eng, requests)
    finally:
        untimed_engine(eng)
    counts = launch_counts()
    check(all(v == 0 for v in counts.values()),
          f"the staged path launched kernels: {counts}")
    for r in requests:
        check(len(done[r.rid].result) == r.n_new == 16,
              f"request {r.rid} returned {len(done[r.rid].result)} tokens")
    tokens = sum(len(done[r.rid].result) for r in requests)
    profile = profile_run(
        "the staged bucket again (1 prefill + 15 decode steps)",
        lambda: serve_buckets(eng, staged_trace(eng.cfg)),
        lambda: serve_buckets(eng, bucket_trace(eng.cfg, n_requests=2,
                                                lo=64, hi=80, n_new=2)),
        {k: 0 for k in KERNEL_NAMES})
    _, fused, _ = serve_buckets(gpt2, staged_trace(gpt2.cfg))
    same = sum(int((done[r.rid].result == fused[r.rid].result).sum())
               for r in requests)
    res = dict(tokens=tokens, seconds=secs, tokens_per_s=tokens / secs,
               prefills=len(times["prefill"]),
               decode_steps=sched.decode_steps,
               prefill_ms=1e3 * float(np.mean(times["prefill"])),
               decode_ms=1e3 * float(np.mean(times["decode"])),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               prompt_lens=[len(r.prompt) for r in requests],
               same_as_fused=same / tokens, launches=counts,
               profile=profile)
    print(f"[staged] gpt2-large 36L d1280 raceit_q8 staged attention, one "
          f"bucket of 4 (prompts {res['prompt_lens']}): {tokens} tokens in "
          f"{secs:.2f} s = {res['tokens_per_s']:.1f} tok/s; prefill "
          f"{res['prefill_ms']:.1f} ms, decode step mean "
          f"{res['decode_ms']:.1f} ms ({sched.decode_steps} steps); peak "
          f"memory {res['peak_mem_gib']:.2f} GiB; no kernel launched; "
          f"{same} of {tokens} greedy tokens equal to the fused path's "
          f"({device_desc})", flush=True)
    return res


# ----------------------------------------------------------- phase 11

def build_model(name, n_layers=None, max_len=1024, quantize=True,
                device="cuda"):
    """(engine, float params) of a catalog model at its published width,
    random weights from the seed, raceit_q8 serving (digital without
    ``quantize``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ExecConfig
    from repro_torch.models import Model, quantize_model_params
    from repro_torch.serve import GenerationEngine
    cfg = get_config(name).replace(param_dtype="float32",
                                   compute_dtype="float32")
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = Model(cfg, device=device).init(gen)
    if not quantize:
        return GenerationEngine(cfg, params, ExecConfig(mode="digital"),
                                max_len=max_len, device=device), params
    return GenerationEngine(cfg, quantize_model_params(params),
                            ExecConfig.serving(mode="raceit"),
                            max_len=max_len, device=device), params


def serve_pool(eng, requests, times=None, prefill_len=512):
    """The contiguous slot pool of phases 11 and 13 on ``requests``: 8
    slots, admission prefill pinned at ``prefill_len`` tokens."""
    from repro_torch.serve import ContinuousBatcher
    cb = ContinuousBatcher(eng, n_slots=8, paged=False,
                           prefill_len=prefill_len)
    for r in requests:
        cb.submit(r)
    if times is not None:
        timed_engine(eng, times)
    t0 = time.perf_counter()
    try:
        cb.run_all()
        torch.cuda.synchronize()
    finally:
        if times is not None:
            untimed_engine(eng)
    return cb, time.perf_counter() - t0


def pool_launches_check(counts: dict, n_layers: int, calls: int) -> None:
    """The contiguous pool's launches: two a layer for every admission
    prefill and decode step, none of the other two kernels."""
    check(counts["acam_attention"] == 2 * n_layers * calls
          and counts["acam_attention_paged"] == 0
          and counts["acam_attention_single"] == 0,
          f"{counts} attention launches for {calls} model calls")


def solo_matches(eng, requests, done, margin=None) -> int:
    """How many of ``requests`` gave their solo `generate` tokens in
    ``done``. With a ``margin``, a request may part from its solo run only
    where the solo run's two best logits lie within it (float32 sums of a
    batch of 8 and of 1 reduce in other orders) and ``done`` took the
    second."""
    same = 0
    for r in requests:
        logits = []
        inner = eng._decode, eng._prefill

        def rec(fn):
            def wrapped(*a, **kw):
                out = fn(*a, **kw)
                logits.append(out[0][0, -1].float())
                return out
            return wrapped
        eng._decode, eng._prefill = rec(inner[0]), rec(inner[1])
        try:
            want = eng.generate(r.prompt[None], r.n_new)[0].tolist()
        finally:
            del eng._decode, eng._prefill
        got = done[r.rid].result.tolist()
        if got == want:
            same += 1
            continue
        if margin is None:
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        top2 = torch.topk(logits[i], 2)
        check(int(top2.indices[1]) == got[i]
              and float(top2.values[0] - top2.values[1]) < margin,
              f"request {r.rid} parts from its solo run at token {i} "
              f"({got[i]} for {want[i]}), not at a near tie")
    return same


def phase_contiguous_pool(device_desc: str) -> dict:
    """olmo-1b at its published width through the contiguous slot pool."""
    from repro_torch.kernels import acam_attention as A
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, fparams = build_model("olmo-1b")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = eng.cfg
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.norm)
          == (16, 2048, 16, 16, 128, 8192, 50304, "np_layernorm"),
          "olmo-1b is not at its published width")
    print("[pool] plan:\n" + eng.explain_plan(), flush=True)
    serve_pool(eng, trace(cfg, n_requests=1, lo=64, hi=64, n_new=2))  # warm
    requests = trace(cfg)
    times: dict = {}
    torch.cuda.reset_peak_memory_stats()
    launches = reset_launches()
    cb, secs = serve_pool(eng, requests, times)
    counts = dict(launches)
    for r in requests:
        done = cb.done[r.rid]
        check(done.error is None and len(done.result) == r.n_new == 32,
              f"request {r.rid}: {done.error or len(done.result)}")
    calls = cb.prefills + cb.decode_steps
    pool_launches_check(counts, cfg.n_layers, calls)
    tokens = sum(len(cb.done[r.rid].result) for r in requests)
    s = cb.summary()
    res = dict(tokens=tokens, seconds=secs, tokens_per_s=tokens / secs,
               init_s=init_s, prefills=cb.prefills,
               decode_steps=cb.decode_steps,
               decode_tokens=cb.decode_tokens, model_calls=s["model_calls"],
               prefill_ms=1e3 * float(np.mean(times["prefill"])),
               decode_ms=1e3 * float(np.mean(times["decode"])),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=counts)
    print(f"[pool] olmo-1b 16L d2048 raceit_q8, contiguous slot pool (8 "
          f"slots, prefill_len 512, max_len 1024; init {init_s:.1f} s): "
          f"{tokens} tokens in {secs:.2f} s = {res['tokens_per_s']:.1f} "
          f"tok/s; {cb.prefills} prefills (mean {res['prefill_ms']:.1f} ms),"
          f" {cb.decode_steps} decode steps (mean {res['decode_ms']:.1f} "
          f"ms), {cb.decode_tokens / cb.decode_steps:.2f} tokens a step; "
          f"peak memory {res['peak_mem_gib']:.2f} GiB; contiguous attention "
          f"launches {counts['acam_attention']} = 2 x {cfg.n_layers} x {calls} "
          f"({device_desc})", flush=True)
    res["profile"] = profile_run(
        f"the phase-11 trace again ({cb.prefills} prefills + "
        f"{cb.decode_steps} decode steps)",
        lambda: serve_pool(eng, trace(cfg)),
        lambda: serve_pool(eng, trace(cfg, n_requests=1, lo=64, hi=64,
                                      n_new=2)),
        {"acam_attention_paged": 0, "acam_attention": counts["acam_attention"],
         "acam_attention_single": 0}, top=10)
    # raceit_q8 couples a pool's rows through whole-tensor quantizer scales
    # (as the reference says of its batcher), so its tokens are compared
    # with solo runs, not held to them (the first 4 requests)
    res["raceit_same_as_solo"] = solo_matches(eng, requests[:4], cb.done)
    # the kernels against their plain versions on the pool, 4 layers
    short = shallow(eng, 4)
    few = trace(cfg, n_requests=4, lo=64, hi=300, n_new=8)
    cb_k, _ = serve_pool(short, few)
    cb_p, _ = swapped_to_plain(lambda: serve_pool(short, few))
    for r in few:
        got, want = cb_k.done[r.rid].result.tolist(), \
            cb_p.done[r.rid].result.tolist()
        check(got == want, f"pool request {r.rid}: kernel {got} != plain "
                           f"{want}")
    del eng, short
    torch.cuda.empty_cache()
    # digital greedy: the pool's tokens are a solo run's, as the reference
    # holds its batcher (its one exact mode), on the same float weights
    from repro_torch.configs.base import ExecConfig
    from repro_torch.serve import GenerationEngine
    deng = GenerationEngine(cfg, fparams, ExecConfig(mode="digital"),
                            max_len=1024, device=DEVICE)
    cb_d, _ = serve_pool(deng, trace(cfg))
    res["digital_same_as_solo"] = solo_matches(deng, trace(cfg)[:4],
                                               cb_d.done, margin=1e-3)
    print(f"[pool] kernels equal to plain attention on a 4-layer pool ("
          f"{len(few)} requests); digital pool: "
          f"{res['digital_same_as_solo']} of the first 4 requests equal "
          f"to their solo runs (the rest part at a near tie); raceit_q8 "
          f"pool: {res['raceit_same_as_solo']} of 4 equal to "
          f"solo runs on the same engine (not held: whole-tensor scales "
          f"couple the slots) ({device_desc})", flush=True)
    del deng, fparams
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------- phase 12

def phase_gqa_bias_paged(device_desc: str) -> dict:
    """starcoder2-15b (GQA 48:4, qkv biases, LayerNorm, GELU) at its
    published width, cut to 8 of its 40 layers, through the paged batcher
    on a short trace."""
    from repro_torch.kernels import acam_attention as A
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, _ = build_model("starcoder2-15b", n_layers=8)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = eng.cfg
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
           cfg.d_ff, cfg.vocab_size, cfg.qkv_bias)
          == (6144, 48, 4, 128, 24576, 49152, True),
          "starcoder2-15b is not at its published width")
    print("[gqa-paged] plan:\n" + eng.explain_plan(), flush=True)
    serve(eng, trace(cfg, n_requests=1, lo=64, hi=64, n_new=2))  # warm-up
    requests = trace(cfg, n_requests=8, lo=64, hi=256, n_new=16)
    launches = reset_launches()
    torch.cuda.reset_peak_memory_stats()
    cb, secs, times, peak_pages = serve(eng, requests, timed=True)
    counts = dict(launches)
    for r in requests:
        done = cb.done[r.rid]
        check(done.error is None and len(done.result) == r.n_new,
              f"request {r.rid}: {done.error or len(done.result)}")
    counts["acam_prolog"] = launch_counts()["acam_prolog"]
    calls = cb.chunk_calls + cb.decode_steps
    check(counts["acam_attention_paged"] == 2 * cfg.n_layers * calls
          and counts["acam_attention"] == 0
          and counts["acam_attention_single"] == 0
          and counts["acam_prolog"] == counts["acam_attention_paged"],
          f"{counts} attention launches for {calls} model calls")
    tokens = sum(len(cb.done[r.rid].result) for r in requests)
    res = dict(tokens=tokens, seconds=secs, tokens_per_s=tokens / secs,
               init_s=init_s, decode_steps=cb.decode_steps,
               chunk_calls=cb.chunk_calls,
               decode_ms=1e3 * float(np.mean(times["decode"])),
               chunk_ms=1e3 * float(np.mean(times["chunk"])),
               peak_pages=peak_pages,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=counts)
    # the paged kernel against its plain version, 2 layers
    short = shallow(eng, 2)
    few = trace(cfg, n_requests=3, lo=64, hi=200, n_new=6)
    cb_k, *_ = serve(short, few)
    kernel = A._launch_paged
    A._launch_paged = A.acam_attention_codes_plain
    try:
        cb_p, *_ = serve(short, few)
    finally:
        A._launch_paged = kernel
    for r in few:
        got, want = cb_k.done[r.rid].result.tolist(), \
            cb_p.done[r.rid].result.tolist()
        check(got == want, f"request {r.rid}: kernel {got} != plain {want}")
    print(f"[gqa-paged] starcoder2-15b 8 of 40 layers, d6144, GQA 48:4, "
          f"qkv bias, raceit_q8 paged (init {init_s:.1f} s): {tokens} "
          f"tokens in {secs:.2f} s = {res['tokens_per_s']:.1f} tok/s; "
          f"{cb.decode_steps} decode steps (mean {res['decode_ms']:.1f} ms),"
          f" {cb.chunk_calls} chunk calls (mean {res['chunk_ms']:.1f} ms); "
          f"peak pages {peak_pages}; peak memory {res['peak_mem_gib']:.2f} "
          f"GiB; paged attention launches {counts['acam_attention_paged']} "
          f"= 2 x 8 x {calls}; kernel equal to plain on a 2-layer run "
          f"({device_desc})", flush=True)
    del eng, short
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------- phase 13

GEMMA_WINDOW = 1024


def count_parameters(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_parameters(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_parameters(v) for v in tree)
    return tree.numel()


def phase_gemma3_pool(device_desc: str) -> dict:
    """gemma3-4b at its full width (34 layers: 29 sliding-window, 5 global;
    d 2560, 8 heads and 4 KV heads of 320, d_ff 10240, vocab 262144, window
    1024; nothing cut) through the contiguous slot pool: 8 slots, max_len
    2048, admission pinned at one window (1024 tokens)."""
    from repro_torch.configs.base import ExecConfig
    from repro_torch.serve import GenerationEngine
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, fparams = build_model("gemma3-4b", max_len=2048)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    cfg = eng.cfg
    mixers = [cfg.layer_spec(i)[0] for i in range(cfg.n_layers)]
    check((cfg.n_layers, mixers.count("attn_local"), cfg.d_model,
           cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff,
           cfg.vocab_size, cfg.window)
          == (34, 29, 2560, 8, 4, 320, 10240, 262144, GEMMA_WINDOW),
          "gemma3-4b is not at the reference's width")
    n_params = count_parameters(fparams)
    print("[gemma3] plan:\n" + eng.explain_plan(), flush=True)
    pool = functools.partial(serve_pool, prefill_len=GEMMA_WINDOW)
    pool(eng, trace(cfg, n_requests=1, lo=128, hi=128, n_new=2))  # warm
    # prompts of 128..1024 tokens, 64 new: past 1024 columns the rings wrap
    requests = trace(cfg, n_requests=16, lo=128, hi=1024, n_new=64)
    times: dict = {}
    torch.cuda.reset_peak_memory_stats()
    launches = reset_launches()
    cb, secs = pool(eng, requests, times)
    counts = dict(launches)
    for r in requests:
        done = cb.done[r.rid]
        check(done.error is None and len(done.result) == r.n_new == 64,
              f"request {r.rid}: {done.error or len(done.result)}")
    calls = cb.prefills + cb.decode_steps
    pool_launches_check(counts, cfg.n_layers, calls)
    tokens = sum(len(cb.done[r.rid].result) for r in requests)
    # every slot holds 1024 + 64 columns, so every ring wraps (over its pad
    # columns first); these requests' own tokens pass the window
    wrapped = sum(len(r.prompt) + r.n_new > GEMMA_WINDOW for r in requests)
    res = dict(tokens=tokens, seconds=secs, tokens_per_s=tokens / secs,
               init_s=init_s, init_peak_gib=init_gib, parameters=n_params,
               prefills=cb.prefills, decode_steps=cb.decode_steps,
               decode_tokens=cb.decode_tokens,
               model_calls=cb.summary()["model_calls"],
               prefill_ms=1e3 * float(np.mean(times["prefill"])),
               decode_ms=1e3 * float(np.mean(times["decode"])),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               prompt_lens=[len(r.prompt) for r in requests],
               past_window_requests=wrapped, launches=counts)
    print(f"[gemma3] gemma3-4b 34L (29 local, 5 global) d2560 8H/4KV of 320 "
          f"d_ff 10240 vocab 262144 raceit_q8, {n_params / 1e9:.2f} B "
          f"parameters (init {init_s:.1f} s, peak {init_gib:.2f} GiB), "
          f"contiguous slot pool (8 slots, prefill_len 1024, max_len 2048): "
          f"{tokens} tokens in {secs:.2f} s = {res['tokens_per_s']:.1f} "
          f"tok/s; {cb.prefills} prefills (mean {res['prefill_ms']:.1f} ms),"
          f" {cb.decode_steps} decode steps (mean {res['decode_ms']:.1f} "
          f"ms), {cb.decode_tokens / cb.decode_steps:.2f} tokens a step; "
          f"every ring wraps, and {wrapped} of {len(requests)} requests' "
          f"own tokens pass the 1024-key window; peak memory {res['peak_mem_gib']:.2f} GiB; contiguous attention "
          f"launches {counts['acam_attention']} = 2 x {cfg.n_layers} x "
          f"{calls} ({device_desc})", flush=True)
    few = trace(cfg, n_requests=8, lo=128, hi=1024, n_new=16)
    res["profile"] = profile_run(
        "the first 8 requests of the phase-13 trace, 16 new tokens each",
        lambda: pool(eng, few),
        lambda: pool(eng, trace(cfg, n_requests=1, lo=128, hi=128,
                                n_new=2)),
        {"acam_attention_paged": 0,
         "acam_attention": 2 * cfg.n_layers * (8 + 15),
         "acam_attention_single": 0}, top=10)
    # raceit_q8 couples the pool's rows through whole-tensor quantizer
    # scales, so its tokens are compared with solo runs, not held to them
    # (the first 2 requests: a solo run of 34 layers takes some 10 s)
    res["raceit_same_as_solo"] = solo_matches(eng, requests[:2], cb.done)
    # the kernels against their plain versions: a 6-layer pool (one
    # period: 5 local, 1 global) with ring-wrapping requests, then a solo
    # 1536-token prompt (the sq >= L prefill and the band over 1536 keys)
    short = shallow(eng, 6)
    wrap = trace(cfg, n_requests=4, lo=900, hi=1024, n_new=160)
    cb_k, _ = pool(short, wrap)
    cb_p, _ = swapped_to_plain(lambda: pool(short, wrap))
    for r in wrap:
        got, want = cb_k.done[r.rid].result.tolist(), \
            cb_p.done[r.rid].result.tolist()
        check(got == want, f"6-layer pool request {r.rid}: kernel {got} != "
                           f"plain {want}")
    long_p = trace(cfg, n_requests=1, lo=1536, hi=1536, n_new=8)[0].prompt
    launches = reset_launches()
    solo_k = short.generate(long_p[None], 8)[0].tolist()
    check(launches["acam_attention"] == 2 * 6 * 8,
          f"{dict(launches)} launches for the 1536-token solo run")
    solo_p = swapped_to_plain(lambda: short.generate(long_p[None], 8))[0]
    check(solo_k == solo_p.tolist(),
          f"1536-token solo run: kernel {solo_k} != plain {solo_p.tolist()}")
    del eng, short
    torch.cuda.empty_cache()
    # digital greedy on the same float weights, the first 6 layers (one
    # period; the script's time): the pool's tokens are a solo run's while
    # the pinned width is at most the window
    deng = GenerationEngine(cfg.replace(n_layers=6),
                            dict(fparams, blocks=fparams["blocks"][:6]),
                            ExecConfig(mode="digital"), max_len=2048,
                            device=DEVICE)
    fresh = lambda: trace(cfg, n_requests=8, lo=128, hi=1024, n_new=32)
    cb_d, _ = pool(deng, fresh())
    res["digital_same_as_solo"] = solo_matches(deng, fresh()[:2], cb_d.done,
                                               margin=1e-3)
    print(f"[gemma3] kernels equal to plain attention on a 6-layer pool ("
          f"{len(wrap)} requests of {[len(r.prompt) for r in wrap]} tokens "
          f"and 160 new, every ring wrapping) and on a 1536-token solo "
          f"prompt; digital pool (6 layers, 8 requests, 32 new): "
          f"{res['digital_same_as_solo']} of the first 2 requests equal to "
          f"their solo runs (the rest "
          f"part at a near tie); raceit_q8 pool: "
          f"{res['raceit_same_as_solo']} of 2 equal to solo runs (not held: "
          f"whole-tensor scales couple the slots) ({device_desc})",
          flush=True)
    del deng, fparams
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------- phase 14

MOE_LAYERS = 4  # of mixtral-8x22b's 56 and llama4-scout's 48
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores


def expert_products(moe_p, C: int):
    """The three expert products of one MoE layer at capacity ``C`` on its
    own weights: (fn, bound ms, bound by). The weights are read once, the
    activations read and written once; float32 operations at the peak
    outside the tensor cores (TF32 is off)."""
    from repro_torch.models import moe as M
    w1, w2, w3 = moe_p["w1"], moe_p["w2"], moe_p["w3"]
    E, D, F = w1.shape
    g = torch.Generator(device=w1.device).manual_seed(SEED)
    disp = torch.randn((E, C, D), generator=g, device=w1.device)
    h = torch.randn((E, C, F), generator=g, device=w1.device)
    fn = lambda: (M._bmm(disp, w1), M._bmm(disp, w3), M._bmm(h, w2))
    nbytes = 4 * (3 * E * D * F + 2 * E * C * D + 3 * E * C * F)
    ops = 3 * 2 * E * C * D * F
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return fn, 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                          else "operations")


def expert_kernel_names(moe_p, Cs) -> set:
    """The device kernels `torch.bmm` launches for the expert products at
    each capacity in ``Cs``: a profile of the products alone, three times
    over, taken again (twice at most) while it records fewer than those
    nine launches (CUPTI can drop a short window's records)."""
    names = set()
    for C in Cs:
        fn = expert_products(moe_p, C)[0]
        for _ in range(3):
            rows, _ = profiled(lambda: [fn() for _ in range(3)], fn)
            if sum(n for _, _, n in rows) >= 9:
                break
        if sum(n for _, _, n in rows) < 9:
            print(f"[moe-pool] the profiler recorded "
                  f"{sum(n for _, _, n in rows)} of 9 expert products at C "
                  f"{C}; the expert bmm row may miss their kernels",
                  flush=True)
        names |= {name for name, _, _ in rows}
    return names


def routing_on_card_and_cpu(eng, prompt_len: int) -> dict:
    """Layer 0's router logits of one admission prefill, routed on the card
    and on the CPU: expert ids, gates, kept choices and slots must be equal
    bit for bit."""
    from repro_torch.models import moe as M
    seen = []
    inner = M.route
    M.route = lambda logits, cfg, plan: (seen.append(logits.clone())
                                         or inner(logits, cfg, plan))
    try:
        serve_pool(eng, trace(eng.cfg, n_requests=1, lo=prompt_len,
                              hi=prompt_len, n_new=1),
                   prefill_len=prompt_len)
    finally:
        M.route = inner
    logits = seen[0]
    card = M.route(logits, eng.cfg, eng.plan)
    cpu = M.route(logits.cpu(), eng.cfg, eng.plan)
    for field in ("gate", "expert", "keep", "slot"):
        a, b = getattr(card, field).cpu(), getattr(cpu, field)
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"routing on the card and the CPU differ in {field}")
    probs = eng.plan.softmax(logits, axis=-1)
    top = torch.sort(probs, dim=-1, descending=True).values
    K = eng.cfg.top_k
    return dict(tokens=int(logits.shape[0]), C=card.C,
                ties=float((top[:, K - 1] == top[:, K]).float().mean()),
                dropped=int((~card.keep).sum()),
                distinct_probs=int(probs.unique().numel()))


def phase_moe_pool(device_desc: str) -> dict:
    """mixtral-8x22b at its published width (d 6144, 48 heads and 8 KV heads
    of 128, d_ff 16384, vocab 32768, 8 experts top-2, sliding window 4096),
    4 of its 56 layers, through the contiguous slot pool: 8 slots, max_len
    2048, admission pinned at 1024 tokens."""
    from repro_torch.configs.base import ExecConfig
    from repro_torch.models.moe import capacity
    from repro_torch.serve import GenerationEngine
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, fparams = build_model("mixtral-8x22b", n_layers=MOE_LAYERS,
                               max_len=2048)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    cfg = eng.cfg
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
           cfg.d_ff, cfg.vocab_size, cfg.n_experts, cfg.top_k, cfg.window,
           cfg.mixer_pattern, cfg.ffn_pattern)
          == (6144, 48, 8, 128, 16384, 32768, 8, 2, 4096, ("attn_local",),
              ("moe",)), "mixtral-8x22b is not at its published width")
    moe0 = eng.params["blocks"][0]["moe"]
    check(all(moe0[k].data_ptr() == fparams["blocks"][0]["moe"][k].data_ptr()
              and moe0[k].dtype == torch.float32 for k in moe0),
          "the expert weights are not the float weights, uncopied")
    n_params = count_parameters(fparams)
    print("[moe-pool] plan:\n" + eng.explain_plan(), flush=True)
    pool = functools.partial(serve_pool, prefill_len=1024)
    pool(eng, trace(cfg, n_requests=1, lo=128, hi=128, n_new=2))  # warm
    requests = trace(cfg, n_requests=16, lo=128, hi=1024, n_new=32)
    times: dict = {}
    torch.cuda.reset_peak_memory_stats()
    launches = reset_launches()
    cb, secs = pool(eng, requests, times)
    counts = dict(launches)
    for r in requests:
        done = cb.done[r.rid]
        check(done.error is None and len(done.result) == r.n_new == 32,
              f"request {r.rid}: {done.error or len(done.result)}")
    calls = cb.prefills + cb.decode_steps
    pool_launches_check(counts, cfg.n_layers, calls)
    tokens = sum(len(cb.done[r.rid].result) for r in requests)
    res = dict(tokens=tokens, seconds=secs, tokens_per_s=tokens / secs,
               init_s=init_s, init_peak_gib=init_gib, parameters=n_params,
               prefills=cb.prefills, decode_steps=cb.decode_steps,
               decode_tokens=cb.decode_tokens,
               prefill_ms=1e3 * float(np.mean(times["prefill"])),
               decode_ms=1e3 * float(np.mean(times["decode"])),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=counts)
    print(f"[moe-pool] mixtral-8x22b {MOE_LAYERS} of 56 layers, d6144 48H/8KV "
          f"of 128, 8 experts top-2 (d_ff 16384, float32), window 4096, "
          f"raceit_q8, {n_params / 1e9:.2f} B parameters (init {init_s:.1f} "
          f"s, peak {init_gib:.2f} GiB), contiguous slot pool (8 slots, "
          f"prefill_len 1024, max_len 2048): {tokens} tokens in {secs:.2f} "
          f"s = {res['tokens_per_s']:.1f} tok/s; {cb.prefills} prefills "
          f"(mean {res['prefill_ms']:.1f} ms), {cb.decode_steps} decode "
          f"steps (mean {res['decode_ms']:.1f} ms), "
          f"{cb.decode_tokens / cb.decode_steps:.2f} tokens a step; peak "
          f"memory {res['peak_mem_gib']:.2f} GiB; contiguous attention "
          f"launches {counts['acam_attention']} = 2 x {cfg.n_layers} x "
          f"{calls} ({device_desc})", flush=True)
    # the expert products of one layer alone, at the decode step's capacity
    # (8 rows) and the admission prefill's (1024 rows)
    res["expert_products"] = []
    for what, T in (("decode", 8), ("prefill", 1024)):
        C = capacity(cfg, T)
        fn, bound_ms, bound_by = expert_products(moe0, C)
        ms, host_free = device_ms(fn, 5, reps=2)
        res["expert_products"].append(dict(
            call=what, rows=T, C=C, ms=ms, host_free=host_free,
            bound_ms=bound_ms, bound_by=bound_by))
        print(f"[moe-pool] expert products of one layer at the {what} "
              f"capacity (T {T}, C {C}): {ms:.3f} ms device (CUDA events), "
              f"bound {bound_ms:.3f} ms ({bound_by}) ({device_desc})",
              flush=True)
    names = expert_kernel_names(moe0, [capacity(cfg, 8),
                                       capacity(cfg, 1024)])
    few = trace(cfg, n_requests=8, lo=128, hi=1024, n_new=16)
    res["profile"] = profile_run(
        "the first 8 requests of the phase-14 trace, 16 new tokens each",
        lambda: pool(eng, few),
        lambda: pool(eng, trace(cfg, n_requests=1, lo=128, hi=128,
                                n_new=2)),
        {"acam_attention_paged": 0,
         "acam_attention": 2 * cfg.n_layers * (8 + 15),
         "acam_attention_single": 0}, top=10, named={"expert bmm": names})
    print(f"[moe-pool] expert bmm launches expected in the profiled run: "
          f"3 x {cfg.n_layers} x {8 + 15}", flush=True)
    # routing: one layer's router logits of a 1024-token prefill
    res["routing"] = routing_on_card_and_cpu(eng, 1024)
    print(f"[moe-pool] routing of layer 0's router logits of a 1024-token "
          f"prefill ({res['routing']['tokens']} rows, C "
          f"{res['routing']['C']}): expert ids, gates, kept choices and "
          f"slots equal on the card and the CPU; "
          f"{res['routing']['ties']:.3f} of rows tie at the 2nd "
          f"probability, {res['routing']['distinct_probs']} distinct "
          f"probabilities, {res['routing']['dropped']} choices dropped "
          f"({device_desc})", flush=True)
    # the kernels against their plain versions on a 2-layer pool
    short = shallow(eng, 2)
    two = trace(cfg, n_requests=4, lo=128, hi=1024, n_new=8)
    cb_k, _ = pool(short, two)
    cb_p, _ = swapped_to_plain(lambda: pool(short, two))
    for r in two:
        got, want = cb_k.done[r.rid].result.tolist(), \
            cb_p.done[r.rid].result.tolist()
        check(got == want, f"2-layer pool request {r.rid}: kernel {got} != "
                           f"plain {want}")
    del eng, short
    torch.cuda.empty_cache()
    # digital greedy on the same float weights: an expert's capacity counts
    # the pool's pad rows and idle slots, so pool tokens are compared with
    # solo runs, not held to them (as in the reference)
    deng = GenerationEngine(cfg, fparams, ExecConfig(mode="digital"),
                            max_len=2048, device=DEVICE)
    fresh = lambda: trace(cfg, n_requests=8, lo=128, hi=1024, n_new=16)
    cb_d, _ = pool(deng, fresh())
    res["digital_same_as_solo"] = solo_matches(deng, fresh(), cb_d.done)
    print(f"[moe-pool] kernels equal to plain attention on a 2-layer pool "
          f"({len(two)} requests); digital pool: "
          f"{res['digital_same_as_solo']} of 8 requests equal to their solo "
          f"runs (not held: capacity counts pad rows and idle slots) "
          f"({device_desc})", flush=True)
    del deng, fparams, moe0
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------- phase 15

def phase_moe_paged(device_desc: str) -> dict:
    """llama4-scout-17b-a16e at its published width (d 5120, 40 heads
    padded to 48 over 8 KV heads of 128, d_ff 8192, vocab 202048, 16
    experts top-1), 4 of its 48 layers, through the paged batcher."""
    from repro_torch.kernels import acam_attention as A
    from repro_torch.models import layers as L
    from repro_torch.models.moe import capacity
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, fparams = build_model("llama4-scout-17b-a16e", n_layers=MOE_LAYERS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_params = count_parameters(fparams)
    del fparams
    cfg = eng.cfg
    check((cfg.d_model, cfg.n_heads, cfg.head_pad_to, cfg.n_kv_heads,
           cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.n_experts,
           cfg.top_k, cfg.mixer_pattern)
          == (5120, 40, 48, 8, 128, 8192, 202048, 16, 1, ("attn",)),
          "llama4-scout-17b-a16e is not at its published width")
    print("[moe-paged] plan:\n" + eng.explain_plan(), flush=True)
    serve(eng, trace(cfg, n_requests=1, lo=64, hi=64, n_new=2))  # warm-up
    requests = trace(cfg, n_requests=8, lo=64, hi=256, n_new=16)
    launches = reset_launches()
    torch.cuda.reset_peak_memory_stats()
    cb, secs, times, peak_pages = serve(eng, requests, timed=True)
    counts = dict(launches)
    for r in requests:
        done = cb.done[r.rid]
        check(done.error is None and len(done.result) == r.n_new,
              f"request {r.rid}: {done.error or len(done.result)}")
    counts["acam_prolog"] = launch_counts()["acam_prolog"]
    calls = cb.chunk_calls + cb.decode_steps
    check(cb.paged and counts["acam_attention_paged"]
          == 2 * cfg.n_layers * calls
          and counts["acam_attention"] == 0
          and counts["acam_attention_single"] == 0
          and counts["acam_prolog"] == counts["acam_attention_paged"],
          f"{counts} attention launches for {calls} model calls")
    tokens = sum(len(cb.done[r.rid].result) for r in requests)
    res = dict(tokens=tokens, seconds=secs, tokens_per_s=tokens / secs,
               init_s=init_s, init_peak_gib=init_gib, parameters=n_params,
               decode_steps=cb.decode_steps, chunk_calls=cb.chunk_calls,
               decode_ms=1e3 * float(np.mean(times["decode"])),
               chunk_ms=1e3 * float(np.mean(times["chunk"])),
               peak_pages=peak_pages,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=counts)
    C = capacity(cfg, 8)  # a decode step of 8 slots
    fn, bound_ms, bound_by = expert_products(eng.params["blocks"][0]["moe"],
                                             C)
    ms, host_free = device_ms(fn, 5, reps=2)
    res["expert_products"] = dict(call="decode", rows=8, C=C, ms=ms,
                                  host_free=host_free, bound_ms=bound_ms,
                                  bound_by=bound_by)
    # the paged kernel against its plain version on a 2-layer run, every
    # attention output finite, padded heads 40..47 included (they are
    # multiplied by zero after the kernel, which would keep a NaN)
    short = shallow(eng, 2)
    few = trace(cfg, n_requests=3, lo=64, hi=200, n_new=6)
    outputs = [0]
    inner = L._raceit_paged_decode

    def finite(*a, **kw):
        out = inner(*a, **kw)
        check(out.shape[2] == cfg.head_pad_to,
              f"paged attention output of {out.shape[2]} heads")
        check(bool(torch.isfinite(out).all()),
              "non-finite paged attention output")
        outputs[0] += 1
        return out
    L._raceit_paged_decode = finite
    try:
        cb_k, *_ = serve(short, few)
        kernel = A._launch_paged
        A._launch_paged = A.acam_attention_codes_plain
        try:
            cb_p, *_ = serve(short, few)
        finally:
            A._launch_paged = kernel
    finally:
        L._raceit_paged_decode = inner
    check(outputs[0] > 0, "no paged attention call was checked")
    for r in few:
        got, want = cb_k.done[r.rid].result.tolist(), \
            cb_p.done[r.rid].result.tolist()
        check(got == want, f"request {r.rid}: kernel {got} != plain {want}")
    print(f"[moe-paged] llama4-scout-17b-a16e {MOE_LAYERS} of 48 layers, "
          f"d5120, 40 heads padded to 48 over 8 KV heads, 16 experts top-1 "
          f"(d_ff 8192, float32), raceit_q8 paged, {n_params / 1e9:.2f} B "
          f"parameters (init {init_s:.1f} s, peak {init_gib:.2f} GiB): "
          f"{tokens} tokens in {secs:.2f} s = {res['tokens_per_s']:.1f} "
          f"tok/s; {cb.decode_steps} decode steps (mean "
          f"{res['decode_ms']:.1f} ms), {cb.chunk_calls} chunk calls (mean "
          f"{res['chunk_ms']:.1f} ms); peak pages {peak_pages}; peak memory "
          f"{res['peak_mem_gib']:.2f} GiB; paged attention launches "
          f"{counts['acam_attention_paged']} = 2 x {cfg.n_layers} x {calls}; "
          f"expert products of one layer at decode {ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_by}); kernel equal to plain on a "
          f"2-layer run, {outputs[0]} attention outputs finite, padded heads "
          f"included ({device_desc})", flush=True)
    del short
    torch.cuda.empty_cache()
    return res, eng


# ----------------------------------------------------------- phase 22

TP_SHAPES = (  # (name, catalog model, model-axis sizes)
    ("gpt2-large", "gpt2-large", (2, 4)),
    ("command-r-35b", "command-r-35b", (2, 4, 8)),
)


def tp_mesh(ms: int):
    """The ``model=ms`` spec, built with every shard on cuda:0 (the
    backends' later builds return this mesh)."""
    from repro_torch.dist import MeshSpec
    spec = MeshSpec.parse(f"model={ms}")
    spec.build(["cuda:0"] * ms)
    return spec


def tp_operands(cfg, gen) -> dict:
    """Float operands at the serving shapes: bucketed prefill (4 rows of
    256 tokens; 2 for command-r's 64 heads), a contiguous cache of 8 rows of
    1024 keys with per-row lengths, the paged pool of 8 slots x 16 pages of
    64 keys, a 64-row chunk with its intra-chunk mask."""
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    B, smax, slots, mp, ps, chunk = 8, 1024, 8, 16, 64, 64
    bp = 4 if H <= 20 else 2
    f = lambda *shape: torch.from_numpy(
        gen.standard_normal(shape).astype(np.float32)).to(DEVICE)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=DEVICE)
    n_pages = 1 + slots * mp
    perm = gen.permutation(np.arange(1, n_pages))
    lens = gen.integers(1, mp * ps + 1, slots)
    lens[3] = 0  # an empty slot
    bt = np.zeros((slots, mp), np.int32)
    for b, ln in enumerate(lens):
        bt[b, :-(-ln // ps)] = perm[b * mp: b * mp + -(-ln // ps)]
    clens = np.maximum(lens, chunk)  # the chunk's rows end at each fill
    cbt = np.zeros((slots, mp), np.int32)
    for b, ln in enumerate(clens):
        cbt[b, :-(-ln // ps)] = perm[b * mp: b * mp + -(-ln // ps)]
    cmask = (np.arange(mp * ps)[None, None, :]
             <= (clens - chunk)[:, None, None]
             + np.arange(chunk)[None, :, None])
    return dict(qp=f(bp, 256, H, D), kp=f(bp, 256, KV, D),
                vp=f(bp, 256, KV, D), pad_lens=i32([0, 37, 200, 5][:bp]),
                q1=f(B, 1, H, D), k=f(B, smax, KV, D), v=f(B, smax, KV, D),
                kv_len=i32(gen.integers(1, smax + 1, B)),
                pool_k=f(n_pages, ps, KV, D), pool_v=f(n_pages, ps, KV, D),
                lens=i32(lens), bt=i32(bt), qc=f(slots, chunk, H, D),
                clens=i32(clens), cbt=i32(cbt),
                cmask=torch.from_numpy(cmask).to(DEVICE), page_size=ps)


def tp_dataflows(cfg, x) -> list:
    """(dataflow, slot, TP backend, single-device backend, kwargs) of the
    phase: every dataflow the TP backends serve, GQA ones where the model
    shares KV heads."""
    scale = 1.0 / float(np.sqrt(cfg.resolved_head_dim))
    pre = dict(scale=scale, q_offset=0, kind="causal", window=None,
               chunk=None)
    pool = dict(block_table=x["bt"], page_size=x["page_size"])
    flows = [
        ("causal prefill", "attention_prefill", "raceit_fused_tp",
         "raceit_fused", (x["qp"], x["kp"], x["vp"]), pre),
        ("padded-bucket prefill", "attention_prefill", "raceit_fused_tp",
         "raceit_fused", (x["qp"], x["kp"], x["vp"]),
         dict(pre, pad_lens=x["pad_lens"])),
        ("contiguous flat decode", "attention_decode", "raceit_fused_tp",
         "raceit_fused_rows", (x["q1"], x["k"], x["v"]),
         dict(kv_len=x["kv_len"], scale=scale)),
        ("paged flat decode", "attention_decode", "raceit_fused_tp",
         "raceit_fused_paged", (x["q1"], x["pool_k"], x["pool_v"]),
         dict(kv_len=x["lens"], scale=scale, **pool)),
        ("paged flat 64-row chunk", "attention_decode", "raceit_fused_tp",
         "raceit_fused_paged", (x["qc"], x["pool_k"], x["pool_v"]),
         dict(kv_len=x["clens"], scale=scale, pad_valid=x["cmask"],
              block_table=x["cbt"], page_size=x["page_size"])),
    ]
    if cfg.n_kv_heads < cfg.n_heads:
        flows += [
            ("contiguous GQA decode", "attention_decode", "raceit_gqa_tp",
             "raceit_gqa_rows", (x["q1"], x["k"], x["v"]),
             dict(kv_len=x["kv_len"], scale=scale)),
            ("paged GQA decode", "attention_decode", "raceit_gqa_tp",
             "raceit_gqa_paged", (x["q1"], x["pool_k"], x["pool_v"]),
             dict(kv_len=x["lens"], scale=scale, **pool)),
        ]
    return flows


def kernel_calls(counts: dict) -> int:
    """Attention wrapper calls behind ``counts``: two launches a two-pass
    call, one a one-tile call."""
    return ((counts["acam_attention_paged"] + counts["acam_attention"]) // 2
            + counts["acam_attention_single"])


def tp_op_parity(device_desc: str) -> list:
    """22(a): each TP backend against its single-device backend on the same
    operands on the card, bit for bit, at model 2 and 4 (gpt2-large's 20
    heads of 64) and 2, 4 and 8 (command-r's 64 heads over 8 KV heads of
    128); the TP call must make two wrapper calls (probe and exact) a
    shard, the single-device call one."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ExecConfig
    from repro_torch.exec import get_backend, resolve_plan
    rows = []
    gen = np.random.default_rng(SEED + 22)
    for name, arch, sizes in TP_SHAPES:
        cfg = get_config(arch)
        x = tp_operands(cfg, gen)
        single = resolve_plan(cfg, ExecConfig.serving())
        for ms in sizes:
            plan = resolve_plan(cfg, ExecConfig.serving(mesh=tp_mesh(ms)))
            for flow, slot, tp_name, one_name, args, kw in tp_dataflows(cfg,
                                                                        x):
                tp_fn = lambda: get_backend(slot, tp_name).impl(plan, *args,
                                                                **kw)
                one_fn = lambda: get_backend(slot, one_name).impl(
                    single, *args, **kw)
                counts = reset_launches()
                want = one_fn()
                one_calls = kernel_calls(dict(counts))
                counts = reset_launches()
                got = tp_fn()
                torch.cuda.synchronize()
                tp_counts = dict(counts)
                check(one_calls == 1 and kernel_calls(tp_counts) == 2 * ms,
                      f"{name} model={ms} {flow}: {one_calls} single-device "
                      f"and {kernel_calls(tp_counts)} TP wrapper calls")
                check(got.shape == want.shape and torch.equal(got, want),
                      f"{name} model={ms} {flow}: TP output differs from "
                      f"{one_name}")
                tp_ms, one_ms = cuda_ms(tp_fn, 5), cuda_ms(one_fn, 5)
                rows.append(dict(model=name, ms=ms, dataflow=flow,
                                 backend=tp_name, single=one_name,
                                 launches=tp_counts, tp_ms=tp_ms,
                                 single_ms=one_ms))
                print(f"[tp] {name} model={ms} {flow}: {tp_name} bit-equal "
                      f"to {one_name}; {sum(tp_counts.values())} launches "
                      f"({kernel_calls(tp_counts)} wrapper calls); call "
                      f"{tp_ms:.3f} ms against {one_ms:.3f} ms "
                      f"(CUDA events, host included; {device_desc})",
                      flush=True)
    return rows


def serve_timed(e, requests, tag: str) -> dict:
    """Serve ``requests`` on ``e`` after a warm-up request, timed: its
    tokens, tokens/s, mean decode and chunk ms, memory and launches."""
    from repro_torch.kernels import acam_attention as A
    serve(e, trace(e.cfg, n_requests=1, lo=64, hi=64, n_new=2))  # warm
    base = torch.cuda.memory_allocated()  # weights, and what else is held
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    cb, secs, times, peak_pages = serve(e, requests, timed=True)
    launches = dict(A.launches)
    for r in requests:
        done = cb.done[r.rid]
        check(done.error is None and len(done.result) == r.n_new,
              f"{tag} request {r.rid}: {done.error or len(done.result)}")
    calls = cb.chunk_calls + cb.decode_steps
    tokens = sum(len(cb.done[r.rid].result) for r in requests)
    return dict(
        tokens=tokens, seconds=secs, tokens_per_s=tokens / secs,
        decode_steps=cb.decode_steps, chunk_calls=cb.chunk_calls,
        decode_ms=1e3 * float(np.mean(times["decode"])),
        chunk_ms=1e3 * float(np.mean(times["chunk"])),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        serving_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30,
        launches=launches, calls=calls, summary=cb.summary(),
        results=tokens_of(cb))


def tp_serving(eng, tp, requests, tag: str) -> dict:
    """Serve ``requests`` on ``eng`` (no mesh) and its TP twin ``tp``
    (the same weights), timed: tokens of both and the TP run's numbers."""
    return {label: serve_timed(e, requests, f"{tag} {label}")
            for label, e in (("single", eng), ("tp", tp))}


def phase_tp(device_desc: str, scout):
    """Phase 22: tensor and expert parallelism, every shard on cuda:0.
    Returns (results, the no-mesh gpt2-large engine and its run on the
    trace: phase 25's reference)."""
    from repro_torch.configs.base import ExecConfig
    from repro_torch.models import moe as M
    t0 = time.perf_counter()
    ops = tp_op_parity(device_desc)
    ops_s = time.perf_counter() - t0

    # (b) gpt2-large at 36 layers, model=2, against no mesh on one trace
    eng = build_engine()
    tp = with_exec(eng, ExecConfig.serving(mode="raceit", mesh=tp_mesh(2)))
    check(tp.plan.backend("attention_decode") == "raceit_fused_tp"
          and tp.plan.backend("attention_prefill") == "raceit_fused_tp",
          f"gpt2-large model=2 plan: {tp.plan.explain()}")
    requests = trace(eng.cfg, n_requests=4, lo=64, hi=256, n_new=16)
    g = tp_serving(eng, tp, requests, "gpt2-large")
    ref = (eng, requests, g["single"])  # phase 25's reference run
    del tp
    torch.cuda.empty_cache()
    check(g["tp"]["results"] == g["single"]["results"],
          "gpt2-large model=2 tokens differ from no mesh")
    n_layers = 36
    per_call = 2 * 2 * 2 * n_layers  # passes x (probe, exact) x shards
    lp = g["tp"]["launches"]["acam_attention_paged"]
    check(lp == per_call * g["tp"]["calls"]
          and g["tp"]["summary"]["mesh"] == "model=2",
          f"gpt2-large model=2: {lp} paged launches for "
          f"{g['tp']['calls']} model calls")
    print(f"[tp] gpt2-large 36L d1280 raceit_q8 paged, model=2 on one card: "
          f"{g['tp']['tokens']} tokens in {g['tp']['seconds']:.2f} s = "
          f"{g['tp']['tokens_per_s']:.1f} tok/s (no mesh "
          f"{g['single']['tokens_per_s']:.1f}); decode step "
          f"{g['tp']['decode_ms']:.1f} ms (no mesh "
          f"{g['single']['decode_ms']:.1f}), chunk {g['tp']['chunk_ms']:.1f} "
          f"ms (no mesh {g['single']['chunk_ms']:.1f}); peak "
          f"{g['tp']['peak_mem_gib']:.2f} GiB with phase 15's engine held, "
          f"{g['tp']['serving_gib']:.2f} GiB over the weights (no mesh "
          f"{g['single']['serving_gib']:.2f}); {per_call} attention launches "
          f"a model call ({lp} over {g['tp']['calls']}); tokens equal to no "
          f"mesh ({device_desc})", flush=True)

    # (c) llama4-scout, 4 of 48 layers, model=2: raceit_gqa_tp and EP
    tp = with_exec(scout, ExecConfig.serving(mode="raceit",
                                             mesh=tp_mesh(2)))
    cfg = scout.cfg
    check(tp.plan.backend("attention_decode") == "raceit_gqa_tp"
          and cfg.expert_parallel and tp.exec_cfg.mesh.model_size == 2,
          f"llama4-scout model=2 plan: {tp.plan.explain()}")
    seen = []
    inner = M.route
    M.route = lambda logits, c, plan: (seen.append(logits.clone())
                                       or inner(logits, c, plan))
    try:  # layer 0's routing in a first chunk call: one per EP shard
        serve(tp, trace(cfg, n_requests=2, lo=128, hi=128, n_new=1))
    finally:
        M.route = inner
    routing = []
    for logits in seen[:2]:
        card = M.route(logits, cfg, tp.plan)
        cpu = M.route(logits.cpu(), cfg, tp.plan)
        for field in ("gate", "expert", "keep", "slot"):
            a, b = getattr(card, field).cpu(), getattr(cpu, field)
            check(a.dtype == b.dtype and torch.equal(a, b),
                  f"EP routing on the card and the CPU differ in {field}")
        check(card.C == M.capacity(cfg, logits.shape[0]),
              "EP capacity is not the shard's")
        routing.append(dict(tokens=int(logits.shape[0]), C=card.C,
                            dropped=int((~card.keep).sum())))
    check(not torch.equal(seen[0], seen[1]),
          "the EP shards routed the same tokens")
    requests = trace(cfg, n_requests=4, lo=64, hi=256, n_new=8)
    sc = tp_serving(scout, tp, requests, "llama4-scout")
    del tp
    torch.cuda.empty_cache()
    agree = sum(a == b for rid in sc["single"]["results"]
                for a, b in zip(sc["single"]["results"][rid],
                                sc["tp"]["results"][rid]))
    lp = sc["tp"]["launches"]["acam_attention_paged"]
    check(lp == 2 * 2 * 2 * cfg.n_layers * sc["tp"]["calls"],
          f"llama4-scout model=2: {lp} paged launches for "
          f"{sc['tp']['calls']} model calls")
    print(f"[tp] llama4-scout {cfg.n_layers} of 48 layers, model=2 "
          f"(raceit_gqa_tp, EP over 2 shards) on one card: "
          f"{sc['tp']['tokens_per_s']:.1f} tok/s (no mesh "
          f"{sc['single']['tokens_per_s']:.1f}); decode step "
          f"{sc['tp']['decode_ms']:.1f} ms (no mesh "
          f"{sc['single']['decode_ms']:.1f}), chunk {sc['tp']['chunk_ms']:.1f}"
          f" ms (no mesh {sc['single']['chunk_ms']:.1f}); peak "
          f"{sc['tp']['peak_mem_gib']:.2f} GiB, "
          f"{sc['tp']['serving_gib']:.2f} GiB over the weights (no mesh "
          f"{sc['single']['serving_gib']:.2f}); {agree} of "
          f"{sc['tp']['tokens']} tokens equal to no mesh (counted: EP "
          f"capacity is per shard); layer 0's EP routing card == CPU on "
          f"{len(routing)} shards ({routing}) ({device_desc})", flush=True)
    strip = lambda d: {k: v for k, v in d.items()
                       if k not in ("results", "summary")}
    return dict(ops=ops, ops_s=ops_s,
                gpt2={k: strip(v) for k, v in g.items()},
                scout={k: strip(v) for k, v in sc.items()},
                scout_agree=agree, routing=routing,
                launches={"acam_attention_paged":
                          g["tp"]["launches"]["acam_attention_paged"]
                          + sc["tp"]["launches"]["acam_attention_paged"]}), ref


# ----------------------------------------------------------- phase 16

def mixer_card_and_cpu(cfg, params, prompt, plan) -> dict:
    """Layer 0's Mamba-2 mixer on one prompt's normed embeddings, on the card
    and on the CPU, TF32 off: the largest difference against the largest
    output."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm
    from repro_torch.models.model import params_to
    tok = torch.from_numpy(prompt[None]).to(DEVICE)
    pos = torch.arange(tok.shape[1], dtype=torch.int32, device=DEVICE)[None]
    p0 = params["blocks"][0]
    h = L.apply_norm(p0["norm1"], L.embed(params["embed"], tok, pos, cfg), cfg)
    card, _ = ssm.mamba(p0["mamba"], h, cfg=cfg, plan=plan)
    cpu, _ = ssm.mamba(params_to(p0["mamba"], "cpu"), h.cpu(), cfg=cfg,
                       plan=plan)
    err = float((card.cpu() - cpu).abs().max())
    return dict(tokens=int(tok.shape[1]), max_abs_err=err,
                max_abs_out=float(cpu.abs().max()))


def prefill_decode_against_full(model, params, prompt, t0: int) -> float:
    """The reference's rule (tests/test_models_smoke.py): prefill(T0), then
    decode steps, against the logits of one prefill of the whole prompt;
    returns the largest difference."""
    from repro_torch.models import layers as L
    tok = torch.from_numpy(prompt[None]).to(DEVICE)
    x, _ = model._trunk(params, tok, model._positions(tok), None)
    full = L.unembed(params["embed"], x, model.cfg, model.plan)
    cache = model.init_cache(1, tok.shape[1])
    lg, cache = model.prefill(params, tok[:, :t0], cache)
    errs = [float((lg[:, 0] - full[:, t0 - 1]).abs().max())]
    for t in range(t0, tok.shape[1]):
        lg, cache = model.decode_step(params, tok[:, t:t + 1], cache)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    return max(errs)


MIXER_RTOL = 1e-4  # card against CPU, float32 sums in other orders


def phase_ssm_pool(device_desc: str) -> dict:
    """mamba2-130m at its published width, nothing cut (24 Mamba-2 layers,
    d 768, 24 SSM heads of 64, state 128, chunk 128, vocab 50280, tied
    embeddings), through the contiguous slot pool: 8 slots, max_len 1024,
    admission pinned at 512 tokens, phase 4's trace."""
    from repro_torch.configs.base import ExecConfig
    from repro_torch.serve import GenerationEngine
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, fparams = build_model("mamba2-130m", max_len=1024)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = eng.cfg
    check((cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads,
           cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk, cfg.vocab_size,
           cfg.tie_embeddings, cfg.mixer_pattern, cfg.ffn_pattern)
          == (24, 768, 1536, 24, 64, 128, 128, 50280, True, ("mamba",),
              ("none",)), "mamba2-130m is not at its published width")
    n_params = count_parameters(fparams)
    print("[ssm-pool] plan:\n" + eng.explain_plan(), flush=True)
    serve_pool(eng, trace(cfg, n_requests=1, lo=64, hi=64, n_new=2))  # warm
    requests = trace(cfg)
    times: dict = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    cb, secs = serve_pool(eng, requests, times)
    counts = launch_counts()
    check(not any(counts.values()),
          f"kernels launched by an attention-free model: {counts}")
    for r in requests:
        done = cb.done[r.rid]
        check(done.error is None and len(done.result) == r.n_new == 32,
              f"request {r.rid}: {done.error or len(done.result)}")
    tokens = sum(len(cb.done[r.rid].result) for r in requests)
    res = dict(tokens=tokens, seconds=secs, tokens_per_s=tokens / secs,
               init_s=init_s, parameters=n_params, prefills=cb.prefills,
               decode_steps=cb.decode_steps, decode_tokens=cb.decode_tokens,
               prefill_ms=1e3 * float(np.mean(times["prefill"])),
               decode_ms=1e3 * float(np.mean(times["decode"])),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=counts)
    print(f"[ssm-pool] mamba2-130m 24L d768, 24 SSM heads of 64, state 128, "
          f"raceit_q8, {n_params / 1e6:.1f} M parameters (init {init_s:.1f} "
          f"s), contiguous slot pool (8 slots, prefill_len 512, max_len "
          f"1024): {tokens} tokens in {secs:.2f} s = "
          f"{res['tokens_per_s']:.1f} tok/s; {cb.prefills} prefills (mean "
          f"{res['prefill_ms']:.1f} ms), {cb.decode_steps} decode steps "
          f"(mean {res['decode_ms']:.1f} ms), "
          f"{cb.decode_tokens / cb.decode_steps:.2f} tokens a step; peak "
          f"memory {res['peak_mem_gib']:.2f} GiB; kernel launches {counts} "
          f"({device_desc})", flush=True)
    res["profile"] = profile_run(
        "the first 8 requests of the phase-16 trace (8 prefills + 31 decode "
        "steps)", lambda: serve_pool(eng, trace(cfg)[:8]),
        lambda: serve_pool(eng, trace(cfg, n_requests=1, lo=64, hi=64,
                                      n_new=2)),
        {"acam_attention_paged": 0, "acam_attention": 0,
         "acam_attention_single": 0}, top=10)
    res["raceit_same_as_solo"] = solo_matches(eng, requests[:2], cb.done)
    del eng
    torch.cuda.empty_cache()
    # the mixer on the card against the CPU, and the prefill/decode rule, on
    # the float weights in digital mode
    deng = GenerationEngine(cfg, fparams, ExecConfig(mode="digital"),
                            max_len=1024, device=DEVICE)
    prompt = trace(cfg, n_requests=1, lo=1024, hi=1024, n_new=1)[0].prompt
    res["mixer"] = mixer_card_and_cpu(cfg, fparams, prompt, deng.plan)
    m = res["mixer"]
    check(m["max_abs_err"] <= MIXER_RTOL * m["max_abs_out"],
          f"layer 0's mixer: card and CPU differ by {m['max_abs_err']} "
          f"(outputs up to {m['max_abs_out']})")
    res["prefill_decode_err"] = prefill_decode_against_full(
        deng.model, fparams, prompt[:208], 200)
    check(res["prefill_decode_err"] < 2e-3,
          f"prefill(200) + 8 decode steps part from the full prefill by "
          f"{res['prefill_decode_err']}")
    cb_d, _ = serve_pool(deng, trace(cfg))
    res["digital_same_as_solo"] = solo_matches(deng, trace(cfg)[:2],
                                               cb_d.done)
    print(f"[ssm-pool] layer 0's mixer on a 1024-token prefill, card "
          f"against CPU (digital, TF32 off): max |diff| "
          f"{m['max_abs_err']:.3g} of outputs up to {m['max_abs_out']:.3g} "
          f"(held under {MIXER_RTOL:g} of it); prefill(200) + 8 decode "
          f"steps against the full prefill's logits: "
          f"{res['prefill_decode_err']:.3g} (held under 2e-3); pool against "
          f"solo runs, counted, not held (the SSM scans the admission "
          f"prefill's left pads): digital {res['digital_same_as_solo']} of "
          f"2, raceit_q8 {res['raceit_same_as_solo']} of 2 ({device_desc})",
          flush=True)
    del deng, fparams
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------- phase 17

JAMBA_LAYERS = 8  # of jamba-v0.1-52b's 32: one period (7 Mamba, 1 attention)


def phase_hybrid_pool(device_desc: str) -> dict:
    """jamba-v0.1-52b at its published width (d 4096, 32 heads and 8 KV
    heads of 128, d_inner 8192 in 128 SSM heads, 16 experts of d_ff 14336
    top-2, vocab 65536), 8 of its 32 layers, through the contiguous slot
    pool: 8 slots, max_len 2048, admission pinned at 1024 tokens."""
    from repro_torch.configs.base import ExecConfig
    from repro_torch.models.moe import capacity
    from repro_torch.serve import GenerationEngine
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, fparams = build_model("jamba-v0.1-52b", n_layers=JAMBA_LAYERS,
                               max_len=2048)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    cfg = eng.cfg
    specs = [cfg.layer_spec(i) for i in range(cfg.n_layers)]
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
           cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.n_experts,
           cfg.top_k, cfg.d_ff, cfg.vocab_size, cfg.pos_emb)
          == (4096, 32, 8, 128, 8192, 128, 128, 16, 2, 14336, 65536, "none")
          and [m for m, _ in specs] == ["mamba"] * 4 + ["attn"]
          + ["mamba"] * 3 and [f for _, f in specs] == ["dense", "moe"] * 4,
          "jamba-v0.1-52b is not at its published width")
    moe1 = eng.params["blocks"][1]["moe"]
    check(all(moe1[k].data_ptr() == fparams["blocks"][1]["moe"][k].data_ptr()
              and moe1[k].dtype == torch.float32 for k in moe1),
          "the expert weights are not the float weights, uncopied")
    n_attn = sum(m == "attn" for m, _ in specs)
    n_params = count_parameters(fparams)
    print("[hybrid-pool] plan:\n" + eng.explain_plan(), flush=True)
    pool = functools.partial(serve_pool, prefill_len=1024)
    pool(eng, trace(cfg, n_requests=1, lo=128, hi=128, n_new=2))  # warm
    requests = trace(cfg, n_requests=16, lo=128, hi=1024, n_new=32)
    times: dict = {}
    torch.cuda.reset_peak_memory_stats()
    launches = reset_launches()
    cb, secs = pool(eng, requests, times)
    counts = dict(launches)
    for r in requests:
        done = cb.done[r.rid]
        check(done.error is None and len(done.result) == r.n_new == 32,
              f"request {r.rid}: {done.error or len(done.result)}")
    calls = cb.prefills + cb.decode_steps
    pool_launches_check(counts, n_attn, calls)
    tokens = sum(len(cb.done[r.rid].result) for r in requests)
    res = dict(tokens=tokens, seconds=secs, tokens_per_s=tokens / secs,
               init_s=init_s, init_peak_gib=init_gib, parameters=n_params,
               prefills=cb.prefills, decode_steps=cb.decode_steps,
               decode_tokens=cb.decode_tokens,
               prefill_ms=1e3 * float(np.mean(times["prefill"])),
               decode_ms=1e3 * float(np.mean(times["decode"])),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=counts)
    print(f"[hybrid-pool] jamba-v0.1-52b {JAMBA_LAYERS} of 32 layers (7 "
          f"Mamba-2, 1 attention; 4 dense and 4 MoE FFNs), d4096 32H/8KV of "
          f"128, d_inner 8192, 16 experts top-2 (d_ff 14336, float32), "
          f"raceit_q8, {n_params / 1e9:.2f} B parameters (init {init_s:.1f} "
          f"s, peak {init_gib:.2f} GiB), contiguous slot pool (8 slots, "
          f"prefill_len 1024, max_len 2048): {tokens} tokens in {secs:.2f} "
          f"s = {res['tokens_per_s']:.1f} tok/s; {cb.prefills} prefills "
          f"(mean {res['prefill_ms']:.1f} ms), {cb.decode_steps} decode "
          f"steps (mean {res['decode_ms']:.1f} ms), "
          f"{cb.decode_tokens / cb.decode_steps:.2f} tokens a step; peak "
          f"memory {res['peak_mem_gib']:.2f} GiB; contiguous attention "
          f"launches {counts['acam_attention']} = 2 x {n_attn} x {calls} "
          f"({device_desc})", flush=True)
    names = expert_kernel_names(moe1, [capacity(cfg, 8),
                                       capacity(cfg, 1024)])
    res["profile"] = profile_run(
        "the first 8 requests of the phase-17 trace, 16 new tokens each",
        lambda: pool(eng, trace(cfg, n_requests=8, lo=128, hi=1024,
                                n_new=16)),
        lambda: pool(eng, trace(cfg, n_requests=1, lo=128, hi=128,
                                n_new=2)),
        {"acam_attention_paged": 0, "acam_attention": 2 * n_attn * (8 + 15),
         "acam_attention_single": 0}, top=10, named={"expert bmm": names})
    # the kernels against their plain versions on the whole one-period pool
    few = trace(cfg, n_requests=4, lo=128, hi=1024, n_new=8)
    cb_k, _ = pool(eng, few)
    cb_p, _ = swapped_to_plain(lambda: pool(eng, few))
    for r in few:
        got, want = cb_k.done[r.rid].result.tolist(), \
            cb_p.done[r.rid].result.tolist()
        check(got == want, f"one-period pool request {r.rid}: kernel {got} "
                           f"!= plain {want}")
    # solo runs (their decode steps take the one-tile kernel at rep 4)
    res["raceit_same_as_solo"] = solo_matches(eng, requests[:2], cb.done)
    del eng
    torch.cuda.empty_cache()
    deng = GenerationEngine(cfg, fparams, ExecConfig(mode="digital"),
                            max_len=2048, device=DEVICE)
    fresh = lambda: trace(cfg, n_requests=8, lo=128, hi=1024, n_new=16)
    cb_d, _ = pool(deng, fresh())
    res["digital_same_as_solo"] = solo_matches(deng, fresh()[:2], cb_d.done)
    print(f"[hybrid-pool] kernels equal to plain attention on the one-period "
          f"pool ({len(few)} requests); pool against solo runs, counted, not "
          f"held (the SSM scans left pads, capacity counts pad rows and idle "
          f"slots): digital {res['digital_same_as_solo']} of 2, raceit_q8 "
          f"{res['raceit_same_as_solo']} of 2 ({device_desc})", flush=True)
    del deng, fparams, moe1
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------- phase 18

ENCODER_BATCH, ENCODER_SEQ = 8, 384  # the paper's 384-token sequences


def encoder_widths(cfg) -> tuple:
    return (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff,
            cfg.vocab_size, cfg.causal)


def timed_calls(fn, n: int) -> list:
    """Milliseconds of ``n`` calls of ``fn()``, a synchronisation each side."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def phase_encoder(device_desc: str) -> dict:
    """bert-base and bert-large at their published widths, nothing cut,
    through `Model.forward` on 8 sequences of 384 tokens; then bert-large
    cut to 2 layers with the contiguous kernels swapped for their plain
    versions, logits bit-equal."""
    from repro_torch.models import Model
    res = {}
    widths = {"bert-base": (12, 768, 12, 3072, 30522, False),
              "bert-large": (24, 1024, 16, 4096, 30522, False)}
    gen = np.random.default_rng(SEED + 22)
    tokens = torch.from_numpy(gen.integers(
        0, 30522, (ENCODER_BATCH, ENCODER_SEQ))).to(DEVICE)
    batch = {"tokens": tokens}
    for name, want in widths.items():
        torch.cuda.reset_peak_memory_stats()
        eng, fl = build_model(name, max_len=ENCODER_SEQ)
        del fl  # the float weights; the forward reads the resident codes
        cfg, model, params = eng.cfg, eng.model, eng.params
        check(encoder_widths(cfg) == want, f"{name} is not at its width")
        L = cfg.n_layers
        fwd = torch.no_grad()(lambda: model.forward(params, batch))
        logits = fwd()  # warm-up
        check(logits.shape == (ENCODER_BATCH, ENCODER_SEQ, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"{name}: logits {tuple(logits.shape)} or non-finite")
        launches = reset_launches()
        ms = timed_calls(fwd, 5)
        counts = dict(launches)
        check(counts["acam_attention"] == 2 * L * 5
              and counts["acam_attention_paged"] == 0
              and counts["acam_attention_single"] == 0,
              f"{name}: {counts} attention launches for 5 forwards")
        prof = profile_run(f"one {name} forward (8 x 384)", fwd, fwd,
                           {"acam_attention_paged": 0,
                            "acam_attention": 2 * L,
                            "acam_attention_single": 0})
        r = dict(forward_ms=float(np.mean(ms)), forward_ms_all=ms,
                 seqs_per_s=ENCODER_BATCH * 1e3 / float(np.mean(ms)),
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 launches=counts, profile=prof)
        res[name] = r
        print(f"[encoder] {name} {L}L d{cfg.d_model} raceit_q8 forward of "
              f"8 x 384: {r['forward_ms']:.2f} ms (of 5: "
              f"{', '.join(f'{t:.2f}' for t in ms)}) = "
              f"{r['seqs_per_s']:.1f} sequences/s; peak memory "
              f"{r['peak_mem_gib']:.2f} GiB; contiguous launches "
              f"{counts['acam_attention']} = 2 x {L} x 5 ({device_desc})",
              flush=True)
        if name == "bert-large":
            cfg2 = cfg.replace(n_layers=2)
            m2 = Model(cfg2, eng.exec_cfg, device=DEVICE)
            p2 = dict(params, blocks=params["blocks"][:2])
            f2 = torch.no_grad()(lambda: m2.forward(p2, batch))
            got, want_ = f2(), swapped_to_plain(f2)
            check(torch.equal(got, want_), "bert-large 2 layers: kernel "
                  "logits differ from the plain versions'")
            print("[encoder] bert-large cut to 2 layers: logits with the "
                  "kernels and with their plain versions bit-equal",
                  flush=True)
        del eng, model, params
        torch.cuda.empty_cache()
    res["launches"] = {k: sum(res[n]["launches"][k] for n in widths)
                       for k in res["bert-base"]["launches"]}
    return res


# ----------------------------------------------------------- phase 19

WHISPER_PREFILL = {"acam_attention": 2 * (4 + 4), "acam_attention_single": 4}
WHISPER_DECODE = {"acam_attention": 2 * 4, "acam_attention_single": 4}


def counted_engine(eng, log: list):
    """Record each prefill and decode call's attention launches."""
    from repro_torch.kernels import acam_attention as A
    for kind, attr in (("prefill", "_prefill"), ("decode", "_decode")):
        inner = getattr(eng, attr)

        def wrapped(*a, _inner=inner, _kind=kind, **kw):
            before = dict(A.launches)
            out = _inner(*a, **kw)
            log.append((_kind, {k: A.launches[k] - before[k]
                                for k in before}))
            return out
        setattr(eng, attr, wrapped)


def phase_whisper(device_desc: str) -> dict:
    """whisper-tiny at its published width (4 encoder and 4 decoder layers,
    d 384, 6 heads, 1500 encoder frames, vocab 51865), resident int8, frame
    embeddings from a seed, through `GenerationEngine.generate`: 4 prompts
    of 16..64 tokens one at a time, 32 new. Per call: a prefill launches
    the two-pass kernel twice for each of the 4 encoder layers (1500 x
    1500, bidirectional) and the 4 cross attentions (P x 1500), and the
    one-tile kernel once for each decoder self-attention (P <= 256 rows,
    one key block: the reference's one-tile rule); a decode step the
    one-tile kernel once a layer (512-column cache) and the two-pass
    kernel twice a layer (1 x 1500 cross). Then: prefill logits and
    tokens equal with the kernels swapped for their plain versions, and on
    the float weights in digital mode prefill(T0) + decode steps within
    2e-3 of `Model.forward` (the reference's rule)."""
    from repro_torch.models import Model
    from repro_torch.serve import GenerationEngine
    torch.cuda.reset_peak_memory_stats()
    eng, fparams = build_model("whisper-tiny", max_len=512)
    cfg = eng.cfg
    check((cfg.n_encoder_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
           cfg.encoder_len, cfg.vocab_size, cfg.is_encoder_decoder)
          == (4, 4, 384, 6, 1500, 51865, True),
          "whisper-tiny is not at its published width")
    print("[whisper] plan:\n" + eng.explain_plan(), flush=True)
    gen = np.random.default_rng(SEED + 23)
    feats = torch.from_numpy(gen.standard_normal(
        (1, cfg.encoder_len, cfg.d_model)).astype(np.float32)).to(DEVICE)
    prompts = [gen.integers(0, cfg.vocab_size, int(gen.integers(16, 65))
                            ).astype(np.int32) for _ in range(4)]
    eng.generate(prompts[0][None, :16], 2, enc_feats=feats)  # warm-up
    times, log = {}, []
    timed_engine(eng, times)
    counted_engine(eng, log)
    launches = reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        outs = [eng.generate(p[None], 32, enc_feats=feats)[0]
                for p in prompts]
        torch.cuda.synchronize()
    finally:
        untimed_engine(eng)
    secs = time.perf_counter() - t0
    counts = dict(launches)
    check(all(len(o) == 32 for o in outs), "a request returned short")
    for kind, got in log:
        want = WHISPER_PREFILL if kind == "prefill" else WHISPER_DECODE
        check(all(got[k] == want.get(k, 0) for k in got),
              f"a {kind} call launched {got}, expected {want}")
    n_pre = sum(k == "prefill" for k, _ in log)
    n_dec = sum(k == "decode" for k, _ in log)
    check((n_pre, n_dec) == (4, 4 * 31), f"{n_pre} prefills, {n_dec} steps")
    tokens = 4 * 32
    res = dict(tokens=tokens, seconds=secs, tokens_per_s=tokens / secs,
               prefills=n_pre, decode_steps=n_dec,
               prefill_ms=1e3 * float(np.mean(times["prefill"])),
               decode_ms=1e3 * float(np.mean(times["decode"])),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=counts)
    res["profile"] = profile_run(
        f"one whisper-tiny generate ({len(prompts[0])} tokens, 8 new: 1 "
        f"prefill + 7 decode steps)",
        lambda: eng.generate(prompts[0][None], 8, enc_feats=feats),
        lambda: eng.generate(prompts[0][None, :16], 2, enc_feats=feats),
        {"acam_attention_paged": 0,
         "acam_attention": WHISPER_PREFILL["acam_attention"]
         + 7 * WHISPER_DECODE["acam_attention"],
         "acam_attention_single": WHISPER_PREFILL["acam_attention_single"]
         + 7 * WHISPER_DECODE["acam_attention_single"]})
    print(f"[whisper] whisper-tiny 4+4L d384 raceit_q8 generate, 4 prompts "
          f"of {[len(p) for p in prompts]} tokens, 32 new: {tokens} tokens "
          f"in {secs:.2f} s = {res['tokens_per_s']:.1f} tok/s; prefill mean "
          f"{res['prefill_ms']:.1f} ms, decode step mean "
          f"{res['decode_ms']:.2f} ms; peak memory "
          f"{res['peak_mem_gib']:.2f} GiB; launches {counts} = per prefill "
          f"{WHISPER_PREFILL}, per decode step {WHISPER_DECODE} "
          f"({device_desc})", flush=True)
    # the kernels against their plain versions, the whole model
    p = torch.from_numpy(prompts[1][None]).to(DEVICE)
    run = lambda: eng.model.prefill(eng.params, p,
                                    eng.model.init_cache(1, 512),
                                    enc_feats=feats)[0]
    with torch.no_grad():
        got, want = run(), swapped_to_plain(run)
    check(torch.equal(got, want), "whisper prefill: kernel logits differ "
                                  "from the plain versions'")
    toks = swapped_to_plain(lambda: eng.generate(prompts[1][None], 8,
                                                 enc_feats=feats))[0]
    check(toks.tolist() == outs[1][:8].tolist(),
          f"whisper tokens: plain {toks.tolist()} != kernel "
          f"{outs[1][:8].tolist()}")
    # prefill then decode against forward, digital, float weights
    from repro_torch.configs.base import ExecConfig
    dm = Model(cfg, ExecConfig(mode="digital"), device=DEVICE)
    tok = torch.from_numpy(prompts[2][None, :40].astype(np.int64)).to(DEVICE)
    with torch.no_grad():
        full = dm.forward(fparams, {"tokens": tok, "enc_feats": feats})
        lg, cache = dm.prefill(fparams, tok[:, :24],
                               dm.init_cache(1, 64), enc_feats=feats)
        errs = [float((lg[:, 0] - full[:, 23]).abs().max())]
        for t in range(24, 40):
            lg, cache = dm.decode_step(fparams, tok[:, t:t + 1], cache)
            errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    res["prefill_decode_err"] = max(errs)
    check(max(errs) < 2e-3, f"prefill + decode against forward: {errs}")
    print(f"[whisper] prefill and decode with the kernels and with their "
          f"plain versions: logits bit-equal, tokens equal; digital "
          f"prefill(24) + 16 decode steps within {max(errs):.2e} of "
          f"forward (rule 2e-3)", flush=True)
    del eng, fparams, dm
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------- phase 20

MROPE_RTOL = 1e-4  # card against CPU, float32 sums in other orders


def mrope_positions(grid=(2, 8, 8), n_text=32):
    """Qwen2-VL's three position channels for a (t, h, w) patch grid
    followed by text: patch (i, j, k) sits at (i, j, k), text token n at
    max + 1 + n in every channel. Returns (3, 1, S) int64."""
    t, h, w = np.meshgrid(*(np.arange(n) for n in grid), indexing="ij")
    vis = np.stack([t.ravel(), h.ravel(), w.ravel()])
    text = vis.max() + 1 + np.arange(n_text)
    pos = np.concatenate([vis, np.broadcast_to(text, (3, n_text))], 1)
    return torch.from_numpy(pos[:, None, :].astype(np.int64))


def phase_mrope_paged(device_desc: str) -> dict:
    """qwen2-vl-2b at its published width, nothing cut (28 layers, d 1536,
    12 heads over 2 KV heads of 128, d_ff 8960, vocab 151936, tied
    embeddings, M-RoPE sections 16/24/24), resident int8, through the paged
    batcher: 8 requests of 64..512 tokens, 32 new, 64-token pages and
    chunks. Then a prefill with distinct t/h/w positions (a 2 x 8 x 8 patch
    grid and 32 text tokens) on 2 layers: in digital mode on the float
    weights the card against the CPU; in raceit_q8 on the card the kernels
    against their plain versions, logits bit-equal (the card against the
    CPU reported)."""
    from repro_torch.configs.base import ExecConfig
    from repro_torch.models import Model
    from repro_torch.models.model import params_to, quantize_model_params
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, fparams = build_model("qwen2-vl-2b", max_len=1024)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = eng.cfg
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
           cfg.tie_embeddings, cfg.pos_emb, tuple(cfg.mrope_sections))
          == (28, 1536, 12, 2, 128, 8960, 151936, True, "mrope",
              (16, 24, 24)), "qwen2-vl-2b is not at its published width")
    fparams = dict(fparams, blocks=fparams["blocks"][:2])
    torch.cuda.empty_cache()
    print("[mrope] plan:\n" + eng.explain_plan(), flush=True)
    serve(eng, trace(cfg, n_requests=1, lo=64, hi=64, n_new=2))  # warm-up
    requests = trace(cfg, n_requests=8, lo=64, hi=512, n_new=32)
    launches = reset_launches()
    torch.cuda.reset_peak_memory_stats()
    cb, secs, times, peak_pages = serve(eng, requests, timed=True)
    counts = dict(launches)
    for r in requests:
        done = cb.done[r.rid]
        check(done.error is None and len(done.result) == r.n_new,
              f"request {r.rid}: {done.error or len(done.result)}")
    counts["acam_prolog"] = launch_counts()["acam_prolog"]
    calls = cb.chunk_calls + cb.decode_steps
    check(counts["acam_attention_paged"] == 2 * cfg.n_layers * calls
          and counts["acam_attention"] == 0
          and counts["acam_attention_single"] == 0
          and counts["acam_prolog"] == counts["acam_attention_paged"],
          f"{counts} attention launches for {calls} model calls")
    tokens = sum(len(cb.done[r.rid].result) for r in requests)
    res = dict(tokens=tokens, seconds=secs, tokens_per_s=tokens / secs,
               init_s=init_s, decode_steps=cb.decode_steps,
               chunk_calls=cb.chunk_calls,
               decode_ms=1e3 * float(np.mean(times["decode"])),
               chunk_ms=1e3 * float(np.mean(times["chunk"])),
               peak_pages=peak_pages,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=counts)
    print(f"[mrope] qwen2-vl-2b 28L d1536 GQA 12:2 M-RoPE raceit_q8 paged "
          f"(init {init_s:.1f} s): {tokens} tokens in {secs:.2f} s = "
          f"{res['tokens_per_s']:.1f} tok/s; {cb.decode_steps} decode steps "
          f"(mean {res['decode_ms']:.1f} ms), {cb.chunk_calls} chunk calls "
          f"(mean {res['chunk_ms']:.1f} ms); peak pages {peak_pages}; peak "
          f"memory {res['peak_mem_gib']:.2f} GiB; paged attention launches "
          f"{counts['acam_attention_paged']} = 2 x 28 x {calls} "
          f"({device_desc})", flush=True)
    few = lambda: trace(cfg, n_requests=4, n_new=8)
    launches = reset_launches()
    cb_few = serve(eng, few())[0]
    res["profile"] = profile_run(
        f"the first 4 requests of the phase-20 trace, 8 new tokens each "
        f"({cb_few.chunk_calls} chunk calls + {cb_few.decode_steps} decode "
        f"steps)", lambda: serve(eng, few()),
        lambda: serve(eng, trace(cfg, n_requests=1, lo=64, hi=64, n_new=2)),
        dict(launches))
    del eng
    torch.cuda.empty_cache()
    # distinct t/h/w channels, 2 layers: the card against the CPU
    cfg2 = cfg.replace(n_layers=2)
    pos = mrope_positions()
    S = pos.shape[-1]
    tok = torch.from_numpy(np.random.default_rng(SEED + 24).integers(
        0, cfg.vocab_size, (1, S)))
    out = {}
    for mode, p in (("digital", fparams),
                    ("raceit_q8", quantize_model_params(fparams))):
        ec = (ExecConfig(mode="digital") if mode == "digital"
              else ExecConfig.serving(mode="raceit"))
        lg = {}
        for dev in ("cuda", "cpu"):
            m = Model(cfg2, ec, device=dev)
            pd = params_to(p, dev)
            with torch.no_grad():
                lg[dev] = m.prefill(pd, tok.to(dev), m.init_cache(1, S),
                                    positions=pos.to(dev))[0].cpu()
                if mode == "digital" and dev == "cuda":
                    text_only = m.prefill(
                        pd, tok.to(dev), m.init_cache(1, S),
                        positions=pos[0].to(dev))[0].cpu()
                if mode == "raceit_q8" and dev == "cuda":
                    from repro_torch.kernels import acam_attention as A
                    before = dict(A.launches)
                    run = lambda: m.prefill(pd, tok.to(dev),
                                            m.init_cache(1, S),
                                            positions=pos.to(dev))[0].cpu()
                    got = run()
                    hit = {k: A.launches[k] - before[k] for k in before}
                    plain = swapped_to_plain(run)
                    # two-pass: 2 launches a layer; one tile: 1
                    check(hit["acam_attention"]
                          + 2 * hit["acam_attention_single"]
                          == 2 * cfg2.n_layers
                          and hit["acam_attention_paged"] == 0,
                          f"M-RoPE raceit_q8 prefill launched {hit}")
                    check(torch.equal(got, plain),
                          "M-RoPE raceit_q8 prefill: kernel logits differ "
                          "from the plain versions'")
        diff = float((lg["cuda"] - lg["cpu"]).abs().max())
        out[mode] = dict(max_abs_diff=diff,
                         max_abs_logit=float(lg["cpu"].abs().max()),
                         top1_equal=bool(torch.equal(lg["cuda"].argmax(-1),
                                                     lg["cpu"].argmax(-1))))
        if mode == "digital":
            moved = float((lg["cuda"] - text_only).abs().max())
            out[mode]["text_only_diff"] = moved
            check(diff <= MROPE_RTOL * out[mode]["max_abs_logit"],
                  f"M-RoPE prefill card against CPU: {diff}")
            check(moved > 10 * MROPE_RTOL * out[mode]["max_abs_logit"],
                  f"distinct t/h/w channels move the logits by {moved} only")
    res["mrope_prefill"] = out
    print(f"[mrope] 2-layer prefill of a 2 x 8 x 8 patch grid + 32 text "
          f"tokens with distinct t/h/w positions, card against CPU: digital "
          f"max |diff| {out['digital']['max_abs_diff']:.3e} of logits up to "
          f"{out['digital']['max_abs_logit']:.3f} (held to {MROPE_RTOL} of "
          f"it; text-only positions move them by "
          f"{out['digital']['text_only_diff']:.3e}); raceit_q8 "
          f"{out['raceit_q8']['max_abs_diff']:.3e}, top-1 equal "
          f"{out['raceit_q8']['top1_equal']} (reported); raceit_q8 on the "
          f"card with the kernels and with their plain versions bit-equal",
          flush=True)
    del fparams
    torch.cuda.empty_cache()
    return res


SMEM_PER_BLOCK = 232448  # bytes of shared memory one H100 block may use


# ----------------------------------------------------------- phase 21

NOISY_PLAN = {"matmul": "raceit_noisy_int", "activation": "raceit_noisy_lut",
              "softmax": "raceit_noisy_acam",
              "attention_prefill": "raceit_noisy_staged",
              "attention_decode": "raceit_noisy_staged"}


def tokens_of(cb) -> dict:
    """A batcher's tokens by request id (None for a failed request)."""
    return {rid: (None if r.result is None else r.result.tolist())
            for rid, r in cb.done.items()}


def noise_card_and_cpu(eng) -> dict:
    """One call of each noisy backend at worst_case on identical inputs on
    the card and on the CPU. Integer outputs must be equal bit for bit: the
    perturbed weight codes and their int32 product, the LUT's jittered
    codes, the Fig.-8 softmax's PROB codes (its own inputs and the decode's
    scores as the card computed them), and the staged attention's two
    int32 products. The draws the card injected are held to fresh host
    draws made after the cache is emptied. Float outputs are reported."""
    from repro_torch.core.ops import get_op
    from repro_torch.core.quant import quantize_tensor
    from repro_torch.exec import noisy as NB
    from repro_torch.exec.backends import int_matmul
    from repro_torch.exec.plan import ExecPlan
    from repro_torch.hw import noise as N
    cpu = with_exec(eng, eng.exec_cfg, device="cpu")
    plans = {"card": eng.plan, "cpu": cpu.plan}
    gen = torch.Generator().manual_seed(SEED + 21)
    rnd = lambda *s: torch.randn(*s, generator=gen)
    cfg = eng.cfg
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.d_model // cfg.n_heads
    inputs = {"x": rnd(8, 64, d), "hidden": 2.0 * rnd(8, 64, cfg.d_ff),
              "scores": 3.0 * rnd(8, H, 1, 1, 1024),
              "q": rnd(1, 64, H, hd), "k": rnd(1, 64, H, hd),
              "v": rnd(1, 64, H, hd), "qd": rnd(8, 1, H, hd),
              "kd": rnd(8, 1024, H, hd), "vd": rnd(8, 1024, H, hd)}
    w = eng.params["blocks"][0]["ffn"]["w1"]
    nz = eng.exec_cfg.noise
    seen = {"card": [], "cpu": []}
    out = {}
    for side, plan in plans.items():
        dev = DEVICE if side == "card" else "cpu"
        t = {k: v.to(dev) for k, v in inputs.items()}
        wq = w.to(dev)
        key = N.site_key(nz, "matmul_resident", tuple(wq.codes.shape))
        codes = N.perturb_weight_codes(wq.codes, nz, key)
        xq = quantize_tensor(t["x"].float(), bits=8)
        r = {"codes": codes, "y32": int_matmul(
            xq.codes.reshape(-1, d), codes), "matmul": plan.matmul(t["x"], wq)}
        op = get_op(cfg.activation)
        r["lut"] = op.apply_codes_noisy(
            op.in_fmt.encode(t["hidden"]),
            N.site_key(nz, f"activation_{op.name}",
                       tuple(t["hidden"].shape)),
            nz.acam_sigma, nz.readout_sigma)
        r["softmax"] = plan.softmax(t["scores"], -1)
        inner_dd, inner_sm = ExecPlan.dd_matmul, NB.noisy_acam_softmax
        ExecPlan.dd_matmul = lambda self, a, b: (
            seen[side].append(("dd", inner_dd(self, a, b))) or
            seen[side][-1][1])

        def softmax_seen(x, **kw):
            y = inner_sm(x, **kw)
            seen[side].append(("sm", x, kw, y))
            return y
        NB.noisy_acam_softmax = softmax_seen
        try:
            r["prefill"] = plan.attention_prefill(
                t["q"], t["k"], t["v"], scale=hd ** -0.5, q_offset=0,
                kind="causal", window=0, chunk=64)
            r["decode"] = plan.attention_decode(
                t["qd"], t["kd"], t["vd"], scale=hd ** -0.5,
                kv_len=torch.tensor([1024, 700, 64, 1, 512, 1000, 3, 900],
                                    dtype=torch.int32, device=dev))
        finally:
            ExecPlan.dd_matmul, NB.noisy_acam_softmax = inner_dd, inner_sm
        out[side] = r
        if side == "card":  # what the card injected, then fresh host draws
            injected = {k: v.cpu() for k, v in N._DRAWS.items()
                        if len(k) == 5}
            N.clear_draw_cache()
    fresh = {k: v for k, v in N._DRAWS.items() if len(k) == 4}
    check(injected and all(torch.equal(v, fresh[k[:-1]])
                           for k, v in injected.items()),
          "the draws injected on the card differ from fresh CPU draws")
    card, host = out["card"], out["cpu"]
    for name in ("codes", "y32", "lut", "softmax"):
        a, b = card[name].cpu(), host[name]
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"noisy {name} on the card differs from the CPU")
    dd_card = [s[1].cpu() for s in seen["card"] if s[0] == "dd"]
    dd_cpu = [s[1] for s in seen["cpu"] if s[0] == "dd"]
    check(len(dd_card) == len(dd_cpu) == 2
          and all(torch.equal(a, b) for a, b in zip(dd_card, dd_cpu)),
          "the staged attention's int32 products differ card / CPU")
    replayed = 0
    for s in seen["card"]:  # the card's softmax inputs, replayed on the CPU
        if s[0] == "sm":
            y = NB.noisy_acam_softmax(s[1].cpu(), **s[2])
            check(torch.equal(s[3].cpu(), y),
                  "a noisy softmax on the card differs from the CPU's")
            replayed += 1
    check(replayed == 2, f"{replayed} noisy softmax calls recorded")
    err = {k: float((card[k].cpu() - host[k]).abs().max())
           for k in ("matmul", "prefill", "decode")}
    return dict(injected_draws=len(injected), max_abs_err=err,
                softmax_replayed=replayed)


NOISE_LAYERS = 12  # of gpt2-large's 36, for the noisy and staged runs


def phase_noise(device_desc: str) -> dict:
    """gpt2-large served through the noisy plan (nominal, seed 1) on the
    paged batcher; zero sigma against the clean staged plan; worst_case on
    the card against the CPU; faults at 2 slots."""
    import dataclasses as dc
    from repro_torch.configs.base import ExecConfig
    from repro_torch.hw import noise as N
    res = {}
    base = build_engine()
    cfg = base.cfg
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab_size)
          == (36, 1280, 20, 50257), "gpt2-large is not at published width")
    # (a) the noisy plan at full width, 12 of the 36 layers (the script's
    # time): draws at first use, then cached
    eng = with_exec(base, ExecConfig.serving(
        mode="raceit", noise=N.NoiseConfig.preset("nominal", seed=1)),
        n_layers=NOISE_LAYERS)
    check(all(eng.plan.backend(s) == b for s, b in NOISY_PLAN.items()),
          "the noisy plan does not route every raceit slot to a noisy "
          "backend:\n" + eng.explain_plan())
    print("[noise] plan:\n" + eng.explain_plan(), flush=True)
    requests = lambda: trace(cfg, n_requests=8, lo=64, hi=256, n_new=16)
    N.clear_draw_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    cb0, first_s, _, _ = serve(eng, requests(), timed=True)
    draws = N.draw_cache_info()
    counts = launch_counts()
    check(all(v == 0 for v in counts.values()),
          f"the noisy path launched kernels: {counts}")
    reset_launches()
    cb, secs, times, peak_pages = serve(eng, requests(), timed=True)
    counts = launch_counts()
    check(all(v == 0 for v in counts.values()),
          f"the noisy path launched kernels: {counts}")
    for r in requests():
        done = cb.done[r.rid]
        check(done.error is None, f"request {r.rid} failed: {done.error}")
        check(len(done.result) == r.n_new, f"request {r.rid} returned "
              f"{len(done.result)} tokens")
        check(done.result.tolist() == cb0.done[r.rid].result.tolist(),
              f"request {r.rid}: the noisy run is not reproducible")
    tokens = sum(r.n_new for r in requests())
    res["noisy"] = dict(
        tokens=tokens, seconds=secs, tokens_per_s=tokens / secs,
        first_seconds=first_s, decode_steps=cb.decode_steps,
        chunk_calls=cb.chunk_calls,
        decode_ms=1e3 * float(np.mean(times["decode"])),
        chunk_ms=1e3 * float(np.mean(times["chunk"])),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        draws=draws, launches=counts)
    staged = with_exec(base, ExecConfig.serving(mode="raceit",
                                                fused_attention=False),
                       n_layers=NOISE_LAYERS)
    serve(staged, trace(cfg, n_requests=1, lo=64, hi=64, n_new=2))
    cbs, staged_s, staged_times, _ = serve(staged, requests(), timed=True)
    same = sum(int(np.sum(cbs.done[r].result == cb.done[r].result))
               for r in cb.done)
    res["staged"] = dict(tokens_per_s=tokens / staged_s,
                         decode_ms=1e3 * float(np.mean(staged_times["decode"])),
                         chunk_ms=1e3 * float(np.mean(staged_times["chunk"])),
                         same_tokens=same)
    s = res["noisy"]
    print(f"[noise] gpt2-large {eng.cfg.n_layers} of {cfg.n_layers} layers "
          f"d{cfg.d_model} raceit_q8 "
          f"nominal noise (seed 1), paged: {tokens} tokens in {secs:.2f} s "
          f"= {s['tokens_per_s']:.1f} tok/s; {cb.decode_steps} decode steps "
          f"(mean {s['decode_ms']:.1f} "
          f"ms), {cb.chunk_calls} chunk calls (mean {s['chunk_ms']:.1f} ms); "
          f"peak memory {s['peak_mem_gib']:.2f} GiB; first run {first_s:.2f} "
          f"s with {draws['draws']} draws in {draws['seconds']:.2f} s on the "
          f"host, cache {draws['host_bytes'] / 2 ** 20:.1f} MiB host + "
          f"{draws['device_bytes'] / 2 ** 20:.1f} MiB card; no kernel "
          f"launched; clean staged plan on the same trace "
          f"{res['staged']['tokens_per_s']:.1f} tok/s, decode "
          f"{res['staged']['decode_ms']:.1f} ms, chunk "
          f"{res['staged']['chunk_ms']:.1f} ms, {same} of {tokens} tokens "
          f"equal ({device_desc})", flush=True)
    few = lambda: trace(cfg, n_requests=2, lo=64, hi=256, n_new=4)
    for name, e in (("noisy", eng), ("staged", staged)):
        res[name]["profile"] = profile_run(
            f"{name}: the first 2 requests of the phase-21 trace, 4 new",
            lambda: serve(e, few()),
            lambda: serve(e, trace(cfg, n_requests=1, lo=64, hi=64,
                                   n_new=2)),
            {k: 0 for k in KERNEL_NAMES}, top=10)
    del eng, staged, cb0, cb, cbs
    N.clear_draw_cache()
    torch.cuda.empty_cache()
    # (b) zero sigma: bit-equal to the clean staged plan
    zero = with_exec(base, ExecConfig.serving(mode="raceit",
                                              noise=N.NoiseConfig()), 2)
    clean = with_exec(base, ExecConfig.serving(mode="raceit",
                                               fused_attention=False), 2)
    prompts = torch.from_numpy(np.random.default_rng(SEED + 21).integers(
        0, cfg.vocab_size, (2, 96))).to(DEVICE)
    lz = zero._prefill(zero.params, prompts, zero.model.init_cache(2, 1024))[0]
    lc = clean._prefill(clean.params, prompts,
                        clean.model.init_cache(2, 1024))[0]
    check(torch.equal(lz, lc), "zero-sigma prefill logits differ from the "
          "clean staged plan's")
    small = lambda: trace(cfg, n_requests=4, lo=64, hi=160, n_new=8)
    tz = tokens_of(serve(zero, small())[0])
    tc = tokens_of(serve(clean, small())[0])
    check(tz == tc, "zero-sigma tokens differ from the clean staged plan's")
    check(np.array_equal(zero.generate(prompts.cpu().numpy(), 6),
                         clean.generate(prompts.cpu().numpy(), 6)),
          "zero-sigma generate differs from the clean staged plan's")
    res["zero"] = dict(requests=len(tz), logits_equal=True)
    # (c) worst_case: the card against the CPU
    worst = with_exec(base, ExecConfig.serving(
        mode="raceit", noise=N.NoiseConfig.preset("worst_case", seed=1)), 2)
    res["card_cpu"] = noise_card_and_cpu(worst)
    two = lambda: trace(cfg, n_requests=2, lo=64, hi=128, n_new=4)
    t_card = tokens_of(serve(worst, two(), n_slots=2)[0])
    t_cpu = tokens_of(serve(with_exec(worst, worst.exec_cfg, device="cpu"),
                            two(), n_slots=2)[0])
    res["card_cpu"]["same_tokens"] = sum(
        int(np.sum(np.asarray(t_card[r]) == np.asarray(t_cpu[r])))
        for r in t_card)
    res["card_cpu"]["tokens"] = sum(len(t) for t in t_card.values())
    N.clear_draw_cache()
    # (d) worst_case faults at 2 slots (digital, decode attention noisy)
    fl_eng, float_params = build_model("gpt2-large", n_layers=2,
                                       quantize=False)
    runs = {}
    for rate in (0.5, 0.0):
        nz = dc.replace(N.NoiseConfig.preset("worst_case"), fault_rate=rate)
        ec = ExecConfig(mode="digital", noise=nz).with_ops(
            attention_decode="raceit_noisy_staged")
        cb = serve(with_exec(fl_eng, ec), two(), n_slots=2)[0]
        runs[rate] = cb, tokens_of(cb)
    nz = dc.replace(N.NoiseConfig.preset("worst_case"), fault_rate=0.5)
    fmap = N.fault_rows(nz, N.site_key(nz, "decode_fault", (2,)), 2)
    dead = {int(i) for i in np.flatnonzero(fmap.numpy())}
    cbf, tf = runs[0.5]
    check(cbf.dead_slots == dead and len(dead) == 1,
          f"dead slots {cbf.dead_slots}, the fault map names {dead}")
    failed = [rid for rid, t in tf.items() if t is None]
    check(len(failed) == 1, f"{len(failed)} requests failed")
    for rid, t in tf.items():
        if t is not None:
            check(t == runs[0.0][1][rid], f"request {rid}: the survivor's "
                  f"tokens differ from the no-fault run's")
    res["faults"] = dict(dead_slot=sorted(dead)[0], failed=failed,
                         stage=cbf.done[failed[0]].error.stage)
    print(f"[noise] 2 layers: zero sigma bit-equal to the clean staged plan "
          f"(prefill logits, {len(tz)} paged requests, generate); "
          f"worst_case card against CPU: {res['card_cpu']['injected_draws']} "
          f"injected draws equal to fresh host draws, integer outputs equal "
          f"(weight codes, int32 product, LUT codes, PROB codes, attention "
          f"int32 products, {res['card_cpu']['softmax_replayed']} softmax "
          f"calls replayed), float max abs err "
          f"{res['card_cpu']['max_abs_err']}, tokens "
          f"{res['card_cpu']['same_tokens']} of {res['card_cpu']['tokens']} "
          f"equal (counted); fault_rate 0.5 on 2 slots: slot "
          f"{res['faults']['dead_slot']} retired at stage "
          f"{res['faults']['stage']}, as the fault map names, the survivor's "
          f"tokens equal to the no-fault run's ({device_desc})", flush=True)
    N.clear_draw_cache()
    return res


# ----------------------------------------------------------- phase 23

# the CPU tests' tolerances (tests/_torch_train_cases.py)
TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL, TRAIN_LOSS_RTOL = 1e-4, 1e-7, 1e-6
TRAIN_CKPT = ROOT / "build" / "train_smoke"


def tiny_train_config(name: str, **kw):
    """`tests/conftest.py` `tiny_config` for the dense catalog models (no
    experts, SSM or encoder), then ``kw``."""
    from repro_torch.configs import get_config
    cfg = get_config(name)
    tiny = dict(d_model=64, d_ff=128, vocab_size=256, param_dtype="float32",
                compute_dtype="float32", max_seq_len=128, window=8,
                n_layers=min(cfg.n_layers, 2 * cfg.block_period + (
                    1 if cfg.n_layers % cfg.block_period else 0)),
                n_heads=4, head_dim=16,
                n_kv_heads=(min(cfg.n_kv_heads, 2)
                            if cfg.n_kv_heads < cfg.n_heads else 4))
    return cfg.replace(**{**tiny, **kw})


def grad_gap(got, want) -> tuple[float, tuple]:
    """The worst leaf's max|got - want| over its tolerance
    (TRAIN_GRAD_RTOL max|want| + TRAIN_GRAD_ATOL), and its path; each
    leaf compared on ``got``'s device (a float32 difference: its rounding
    is 2^-24 of the gap, far under the tolerance)."""
    from repro_torch import tree
    worst, where = 0.0, None
    for (path, a), (_, b) in zip(tree.leaves_with_paths(got),
                                 tree.leaves_with_paths(want)):
        b = b.to(a.device)
        tol = TRAIN_GRAD_RTOL * float(b.abs().max()) + TRAIN_GRAD_ATOL
        r = float((a - b).abs().max()) / tol
        if r > worst:
            worst, where = r, path
    return worst, where


def train_card_vs_cpu(device_desc: str) -> dict:
    """(a) gpt2-large's width at 2 layers: loss and gradients, card
    against CPU, on the same weights and batch."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.model import params_to
    from repro_torch.train import trainer
    cfg = get_config("gpt2-large").replace(n_layers=2, param_dtype="float32",
                                           compute_dtype="float32")
    cpu = Model(cfg, device="cpu")
    p_cpu = cpu.init(torch.Generator().manual_seed(SEED + 23))
    tokens = np.random.default_rng(SEED + 23).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)
    t0 = time.perf_counter()
    l_cpu, g_cpu = trainer.value_and_grad(cpu, p_cpu, {"tokens": tokens})
    cpu_s = time.perf_counter() - t0
    card = Model(cfg, device=DEVICE)
    l_card, g_card = trainer.value_and_grad(card, params_to(p_cpu, DEVICE),
                                            {"tokens": tokens})
    loss_rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    worst, where = grad_gap(g_card, g_cpu)
    n = sum(x.numel() for x in tree.leaves(p_cpu))
    print(f"[train] (a) gpt2-large width, 2 layers ({n} params), 2 x 64 "
          f"tokens: loss card {float(l_card):.7f} CPU {float(l_cpu):.7f} "
          f"(rel {loss_rel:.2e}, tolerance {TRAIN_LOSS_RTOL}); worst "
          f"gradient leaf {'/'.join(map(str, where or ()))} at "
          f"{worst:.3f} of its tolerance (CPU pass {cpu_s:.1f} s; "
          f"{device_desc})", flush=True)
    check(loss_rel <= TRAIN_LOSS_RTOL, f"train (a): loss card {float(l_card)}"
          f" against CPU {float(l_cpu)}")
    check(worst <= 1.0, f"train (a): gradient leaf {where} at {worst:.3f} "
          f"of its tolerance")
    return dict(params=n, loss_card=float(l_card), loss_cpu=float(l_cpu),
                loss_rel=loss_rel, worst_grad=worst,
                worst_leaf="/".join(map(str, where or ())))


def split_step_ms(model, params, opt_state, batch, opt_cfg) -> dict:
    """One train step by parts, each ending in a synchronise: forward (the
    loss), backward (`torch.autograd.grad`), optimizer (AdamW and the
    parameter update)."""
    from repro_torch import tree
    from repro_torch.train import optim
    flat = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = model.loss_fn(tree.unflatten(params, flat), batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads = torch.autograd.grad(loss, flat)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    upd, _, _ = optim.adamw_update(tree.unflatten(params, list(grads)),
                                   opt_state, params, opt_cfg)
    optim.apply_updates(params, upd)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return dict(forward_ms=1e3 * (t1 - t0), backward_ms=1e3 * (t2 - t1),
                optimizer_ms=1e3 * (t3 - t2))


def train_full_width(device_desc: str) -> dict:
    """(b) gpt2-large at its published width through the launcher's
    function: 6 steps and their checkpoint (phase 25 (b) restores a
    checkpoint of this size bit for bit; (c) resumes the loop)."""
    import shutil
    from repro_torch import tree
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as launch
    from repro_torch.models import Model
    from repro_torch.train import loop, optim, trainer
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    TRAIN_CKPT.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(TRAIN_CKPT.parent).free
    saves = []

    class TimedManager(CheckpointManager):  # times each blocking save
        def save(self, step, tree_, extra=None, block=True):
            t0 = time.perf_counter()
            super().save(step, tree_, extra, block)
            saves.append((step, time.perf_counter() - t0, block))

    real_manager = loop.CheckpointManager
    loop.CheckpointManager = TimedManager
    logs = []
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, opt_state, out = launch.train(
            "gpt2-large", steps=6, ckpt_dir=str(TRAIN_CKPT), device=DEVICE,
            log=logs.append)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        h = out["history"]
        losses = [r["loss"] for r in h]
        check(out["final_step"] == 6 and len(h) == 6 and not logs,
              f"train (b): {out['final_step']} steps, logs {logs}")
        check(all(np.isfinite(losses)) and losses[5] < losses[0],
              f"train (b): losses {losses}")
        step_ms = [1e3 * r["step_time_s"] for r in h]
        med = float(np.median(step_ms[1:]))
        ckpt_dir = TRAIN_CKPT / "step-6"
        nbytes = sum(f.stat().st_size for f in ckpt_dir.iterdir())
        n_params = sum(x.numel() for x in tree.leaves(params))
        steps_kept = CheckpointManager(TRAIN_CKPT).steps()
        check(steps_kept == [6], f"train (b): checkpoints {steps_kept}")
        # one step by parts and one under torch.profiler, at the run's
        # state, on the launcher's configuration
        cfg = get_config("gpt2-large").replace(param_dtype="float32",
                                               compute_dtype="float32")
        net = Model(cfg, device=DEVICE)
        data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=256,
                           global_batch=8, seed=0, _step=6)
        batch = {k: torch.as_tensor(v, device=DEVICE)
                 for k, v in data.next_batch().items()}
        opt_cfg = optim.AdamWConfig(lr=3e-4,
                                    schedule=optim.warmup_cosine(20, 6))
        split = split_step_ms(net, params, opt_state, batch, opt_cfg)
        # forward + backward under each remat policy (the second of two
        # calls) and its peak memory over the run's state
        remat = {}
        for policy in ("none", "full", "dots"):
            m_r = Model(cfg.replace(remat=policy), device=DEVICE)
            trainer.value_and_grad(m_r, params, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer.value_and_grad(m_r, params, batch)
            torch.cuda.synchronize()
            remat[policy] = dict(
                ms=1e3 * (time.perf_counter() - t0),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        step = trainer.make_train_step(net, opt_cfg)
        one = lambda: step(params, opt_state, batch)
        prof = profile_run("one gpt2-large train step (8 x 256)", one, one,
                           {k: 0 for k in KERNEL_NAMES}, top=10)
        del params, opt_state, step, one
        torch.cuda.empty_cache()
    finally:
        loop.CheckpointManager = real_manager
        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    write_s = [s for st, s, block in saves if st == 6 and block][0]
    res = dict(params=n_params, losses=losses, step_ms=step_ms,
               step_ms_median=med, tokens_per_s=8 * 256 * 1e3 / med,
               peak_mem_gib=peak, run_s=run_s, ckpt_bytes=nbytes,
               ckpt_write_s=write_s, saves=saves, split=split, remat=remat,
               profile=prof, disk_free_gib=free / 2 ** 30)
    print(f"[train] (b) gpt2-large at its width ({n_params} params, 36 "
          f"layers, d 1280), 8 x 256 tokens a step: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; step "
          f"{med:.1f} ms median after the first (all: "
          f"{', '.join(f'{t:.1f}' for t in step_ms)}) = "
          f"{res['tokens_per_s']:.0f} tokens/s; peak memory {peak:.2f} GiB",
          flush=True)
    print(f"[train] (b) one step by parts: forward "
          f"{split['forward_ms']:.1f} ms, backward "
          f"{split['backward_ms']:.1f} ms, optimizer "
          f"{split['optimizer_ms']:.1f} ms; forward + backward by remat "
          f"policy: " + ", ".join(f"{k} {v['ms']:.1f} ms (peak "
                                  f"{v['peak_gib']:.2f} GiB)"
                                  for k, v in remat.items()), flush=True)
    print(f"[train] (b) checkpoint of step 6: {nbytes} bytes, written in "
          f"{write_s:.2f} s (host copy + npz; phase 25 (b) restores one of "
          f"this size bit for bit); the 6-step run {run_s:.1f} s; "
          f"{res['disk_free_gib']:.0f} GiB free before ({device_desc})",
          flush=True)
    return res


def train_resume(device_desc: str) -> dict:
    """(c) tests/test_substrate.py's loop resume on the card."""
    import shutil
    from repro_torch import tree
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model
    from repro_torch.train import TrainLoopConfig, optim, run_training
    from repro_torch.train import trainer
    cfg = tiny_train_config("olmo-1b")
    model = Model(cfg, device=DEVICE)
    p0 = model.init(torch.Generator(device=DEVICE).manual_seed(SEED))
    o0 = optim.adamw_init(p0)
    step = trainer.make_train_step(model, optim.AdamWConfig(lr=1e-3))
    root = TRAIN_CKPT.parent / "train_resume_smoke"
    shutil.rmtree(root, ignore_errors=True)

    def train_to(steps, d):
        data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16,
                           global_batch=2, seed=7)
        return run_training(step, p0, o0, data, TrainLoopConfig(
            steps=steps, ckpt_dir=str(d), ckpt_every=5, log_every=100),
            log=lambda *a: None)
    try:
        p_full, _, _ = train_to(10, root / "full")
        train_to(5, root / "resume")
        p_res, _, out = train_to(10, root / "resume")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(out["final_step"] == 10, f"train (c): step {out['final_step']}")
    gap = max(float(((a - b).abs() / (1e-6 + 1e-5 * b.abs())).max())
              for a, b in zip(tree.leaves(p_res), tree.leaves(p_full)))
    equal = all(torch.equal(a, b) for a, b in zip(tree.leaves(p_res),
                                                  tree.leaves(p_full)))
    print(f"[train] (c) tiny olmo-1b, 10 steps against 5 + a resume to 10: "
          f"params {'bit-equal' if equal else 'not bit-equal'}, worst "
          f"{gap:.3f} of rtol 1e-5, atol 1e-6 ({device_desc})", flush=True)
    check(gap <= 1.0, f"train (c): resumed params at {gap:.3f} of the "
          f"tolerance")
    return dict(bit_equal=equal, worst=gap)


def train_learn_serve(device_desc: str) -> dict:
    """(d) tests/test_system.py on the card: learn, then serve through the
    contiguous kernel."""
    from repro_torch.configs.base import ExecConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model, quantize_model_params
    from repro_torch.train import optim, trainer
    cfg = tiny_train_config("gpt2-large", n_layers=2, d_model=128,
                            n_heads=4, n_kv_heads=4, vocab_size=128)
    data = SyntheticLM(vocab_size=128, seq_len=32, global_batch=8, seed=5)
    model = Model(cfg, device=DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED))
    step = trainer.make_train_step(model, optim.AdamWConfig(
        lr=1e-3, schedule=optim.warmup_cosine(10, 120)))
    opt_state = optim.adamw_init(params)
    losses = []
    t0 = time.perf_counter()
    for _ in range(120):
        params, opt_state, m = step(params, opt_state, data.next_batch())
        losses.append(float(m["loss"]))
    train_s = time.perf_counter() - t0
    check(losses[-1] < 0.7 * losses[0], f"train (d): loss {losses[0]} -> "
          f"{losses[-1]}")
    b = SyntheticLM(vocab_size=128, seq_len=32, global_batch=8,
                    seed=77).next_batch()
    digital = Model(cfg, ExecConfig(), device=DEVICE)
    raceit = Model(cfg, ExecConfig.serving(mode="raceit"), device=DEVICE)
    q = quantize_model_params(params)
    with torch.no_grad():
        ld = digital.forward(params, b)
        launches = reset_launches()
        lr = raceit.forward(q, b)
        counts = dict(launches)
        lp = swapped_to_plain(lambda: raceit.forward(q, b))
    L = cfg.n_layers
    check(counts["acam_attention"] == 2 * L
          and counts["acam_attention_paged"] == 0
          and counts["acam_attention_single"] == 0,
          f"train (d): {counts} attention launches for one forward")
    check(torch.equal(lr, lp), "train (d): the raceit forward with the "
          "kernel differs from the plain version's")
    agree = float((ld.argmax(-1) == lr.argmax(-1)).float().mean())
    check(agree > 0.7, f"train (d): argmax agreement {agree}")
    print(f"[train] (d) tiny gpt2-large, 120 steps in {train_s:.1f} s: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; raceit_q8 forward "
          f"(contiguous launches {counts['acam_attention']} = 2 x {L}) "
          f"equal to the plain version's bit for bit, argmax agreement "
          f"with digital {agree:.3f} ({device_desc})", flush=True)
    return dict(loss_first=losses[0], loss_last=losses[-1], train_s=train_s,
                agree=agree, launches=counts)


def phase_train(device_desc: str) -> dict:
    res = {"card_vs_cpu": train_card_vs_cpu(device_desc)}
    torch.cuda.empty_cache()
    res["full_width"] = train_full_width(device_desc)
    torch.cuda.empty_cache()
    res["resume"] = train_resume(device_desc)
    res["learn_serve"] = train_learn_serve(device_desc)
    res["launches"] = res["learn_serve"]["launches"]
    return res


def smem_report(device_desc: str, d: int = 320) -> list:
    """Each attention kernel's dynamic shared memory at head dim ``d``, from
    the launchers' own layout code: the contiguous kernels at gemma3-4b's
    four main-path shapes, the one-tile kernel at the largest shape its
    rule takes (8 groups, 256 rows, 512 keys, masked) and the paged kernels
    at a masked 64-row chunk. Each must fit one block."""
    import ctypes
    from repro_torch.kernels import acam_attention as A
    from repro_torch.kernels.build import bind
    I = ctypes.c_int
    cfn = bind("acam_attention", "acam_attention_contiguous_smem", [I] * 10)
    pfn = bind("acam_attention", "acam_attention_paged_smem", [I] * 10)
    sfn = bind("acam_attention_single", "acam_attention_single_smem", [I] * 8)
    rows = []
    for what, G, sq, sk in (("pool prefill", 8, 1024, 1024),
                            ("solo prefill", 8, 1536, 1536),
                            ("pool decode ring", 32, 2, 1024),
                            ("pool decode", 32, 2, 2048)):
        bk = A.key_block(sk)
        plan = A.contiguous_plan(G, sq, sk, bk)
        for pass_id, kernel in ((0, "contiguous_sums"),
                                (1, "contiguous_probv")):
            rows.append(dict(kernel=kernel, shape=f"{what} G {G} {sq} x {sk}",
                             bytes=cfn(pass_id, G, sq, sk, d, bk, 1,
                                       plan.splits, plan.per, plan.psp)))
    G, sq, sk = 8, 256, 512
    plan = A.single_plan(G, sq, sk)
    rows.append(dict(kernel="single_tile", shape=f"G {G} {sq} x {sk}",
                     bytes=sfn(G, sq, sk, d, A.key_block(sk), 1, plan.splits,
                               plan.per)))
    pp = A.paged_plan(64, 64, 16, 64)
    for pass_id, kernel in ((0, "paged_sums"), (1, "paged_probv")):
        rows.append(dict(kernel=kernel, shape="chunk G 64 64 rows, 16 pages "
                                              "of 64",
                         bytes=pfn(pass_id, 64, 64, d, 64, 16, 1, pp.splits,
                                   pp.pages_per_split, pp.key_tile)))
    for r in rows:
        print(f"[build] D {d} {r['kernel']} ({r['shape']}, masked): "
              f"{r['bytes']} bytes dynamic shared memory of "
              f"{SMEM_PER_BLOCK} a block may use ({device_desc})", flush=True)
        check(0 < r["bytes"] <= SMEM_PER_BLOCK,
              f"{r['kernel']} takes {r['bytes']} bytes at D {d}")
    return rows


def ptxas_report(log: str) -> list:
    """Per kernel of an `nvcc -Xptxas -v` log: registers, static shared
    memory and spill bytes."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)", line)
        if m:
            name = m.group(1)
            if cur is None or cur["mangled"] != name:
                short = re.search(r"(mvm_kernel|mvm_wgmma|paged_sums|"
                                  r"paged_probv|contiguous_sums|"
                                  r"contiguous_probv|single_tile|"
                                  r"softmax_rows|lut_kernel)", name)
                kernel = short.group(1) if short else name
                targs = re.findall(r"L[ib](\d+)E", name[name.find(kernel):])
                if targs:  # a template's arguments, e.g. mvm_kernel<4,...>
                    kernel += "<" + ",".join(targs) + ">"
                cur = dict(mangled=name, kernel=kernel, registers=None, smem=0,
                           spill_stores=0, spill_loads=0)
                rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    for r in rows:
        r.pop("mangled")
    return rows


def headline(root: Path) -> None:
    """``--headline``: the tree at ``root``'s main-path attention cases."""
    import importlib.util
    root = root.resolve()
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("tree_smoke",
                                                  root / "chip_smoke.py")
    T = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(T)
    from repro_torch.kernels import build
    check(Path(build.__file__).resolve().is_relative_to(root),
          f"{build.__file__} is not the tree's")
    build.build_all(build.SOURCES)
    desc = device_line()
    times: dict = {}
    for _ in range(3):
        gen = np.random.default_rng(T.SEED + 1)
        for c in T.paged_main_cases(gen, "pot") + \
                T.contiguous_main_cases(gen, "pot"):
            run = (T.check_attention_case if "bt" in c
                   else T.check_contiguous_case)
            times.setdefault(c["name"], []).append(run(c)["ms"])
            if "sqrt_d" in c and c["q"].shape[-1] == 128:
                c["sqrt_d"] = 128
                times.setdefault(c["name"] + " sqrt-d", []).append(
                    run(c)["ms"])
    print(f"[headline] {root}: " + json.dumps(
        {k: min(v) for k, v in times.items()}) + f" ({desc})", flush=True)


# ---------------------------------------------- phase 24: dry-run vs card

def phase_dryrun(device_desc: str) -> dict:
    """The dry-run's reckoning of gpt2-large's decode step against the card
    (a, b) and the kernelcheck shared-memory mirror against the sources'
    exports (c); see the module's docstring."""
    import ctypes
    import gc

    from repro_torch.analysis import kernelcheck as KC
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ExecConfig, ShapeSpec
    from repro_torch.kernels.build import bind
    from repro_torch.launch import inputs
    from repro_torch.launch.op_analysis import analyze_ops
    from repro_torch.models import Model, quantize_model_params

    t0 = time.perf_counter()
    cfg = get_config("gpt2-large")
    shape = ShapeSpec("decode_1k", 1024, 8, "decode")
    B, L = shape.global_batch, shape.seq_len
    ec = ExecConfig.serving(mode="raceit")

    # the dry-run's reckoning, on meta (the first trace fills the lazily
    # made tables; the second is the step's own)
    meta = Model(cfg, ec, device="meta")
    mparams = quantize_model_params(meta.init(torch.Generator()))
    mcache = meta.init_cache(B, L)
    want_bytes = inputs.tree_bytes(mparams) + inputs.tree_bytes(mcache)
    want_512 = (inputs.tree_bytes(mparams, granule=512)
                + inputs.tree_bytes(mcache, granule=512))
    mtok = torch.zeros((B, 1), dtype=torch.int32, device="meta")
    analyze_ops(meta.decode_step, mparams, mtok, mcache)
    mcost, _ = analyze_ops(meta.decode_step, mparams, mtok, mcache)
    t_meta = time.perf_counter() - t0

    # (a) the card's allocation for the same trees, and the step's peak
    def requested():  # bytes asked of the caching allocator, unrounded
        return torch.cuda.memory_stats()["requested_bytes.all.current"]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base, base_req = torch.cuda.memory_allocated(), requested()
    model = Model(cfg, ec, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = quantize_model_params(model.init(gen))
    cache = model.init_cache(B, L)
    torch.cuda.synchronize()
    got_bytes = requested() - base_req
    got_blocks = torch.cuda.memory_allocated() - base
    check(got_bytes == want_bytes,
          f"dry-run params + cache {want_bytes} B, the card's allocator "
          f"was asked for {got_bytes} B")
    check(got_blocks >= want_512, f"{got_blocks} B of blocks for "
                                  f"{want_512} B of 512-byte granules")
    tok = torch.randint(0, cfg.vocab_size, (B, 1), dtype=torch.int32,
                        device="cuda")
    out = model.decode_step(params, tok, cache)   # tables, kernel binding
    del out
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base   # args and lasting tables
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    logits, _ = model.decode_step(params, tok, cache)
    torch.cuda.synchronize()
    card_peak = torch.cuda.max_memory_allocated() - base
    card_peak_req = (torch.cuda.memory_stats()["requested_bytes.all.peak"]
                     - base_req)
    launches = dict(launch_counts())
    check(launches["acam_attention"] == 2 * cfg.n_layers,
          f"{launches} launches for one decode step")
    check(bool(torch.isfinite(logits).all()), "non-finite decode logits")
    del logits

    # (b) the counter over the card's step against meta's
    reset_launches()
    ccost, (logits, _) = analyze_ops(model.decode_step, params, tok, cache)
    torch.cuda.synchronize()
    check(launch_counts()["acam_attention"] == 2 * cfg.n_layers,
          "the counted step did not launch the contiguous kernel")
    check(ccost.flops == mcost.flops and
          ccost.memory_bytes == mcost.memory_bytes,
          f"card flops {ccost.flops} bytes {ccost.memory_bytes}, meta "
          f"{mcost.flops} {mcost.memory_bytes}")
    check(ccost.ops == mcost.ops,
          f"op counts differ: {dict(ccost.ops - mcost.ops)} on the card, "
          f"{dict(mcost.ops - ccost.ops)} on meta")
    check(ccost.launches == mcost.launches, "kernel launches differ")
    del logits, params, cache
    torch.cuda.empty_cache()
    t_ab = time.perf_counter() - t0 - t_meta

    # (c) the shared-memory mirror against the sources' exports
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    _, cov, tally = KC.check_serving_plans()
    I = ctypes.c_int
    exports = {"acam_attention_paged_smem": bind(
                   "acam_attention", "acam_attention_paged_smem", [I] * 10),
               "acam_attention_contiguous_smem": bind(
                   "acam_attention", "acam_attention_contiguous_smem",
                   [I] * 10),
               "acam_attention_single_smem": bind(
                   "acam_attention_single", "acam_attention_single_smem",
                   [I] * 8)}
    probes = KC.smem_probes(tally)
    by_export = {}
    for name, args, nbytes in probes:
        got = exports[name](*args)
        check(got == nbytes, f"{name}{args}: the source says {got} B, the "
                             f"mirror {nbytes} B")
        check(got <= optin, f"{name}{args}: {got} B over the card's "
                            f"{optin} B")
        by_export[name] = by_export.get(name, 0) + 1
    secs = time.perf_counter() - t0
    res = dict(params_cache_bytes=got_bytes, dryrun_bytes=want_bytes,
               params_cache_blocks=got_blocks, dryrun_bytes_512=want_512,
               traced_peak_bytes=mcost.peak_live_bytes,
               traced_arg_bytes=mcost.arg_bytes, card_held_bytes=held,
               card_peak_bytes=card_peak, card_peak_requested=card_peak_req,
               peak_ratio=card_peak / mcost.peak_live_bytes,
               peak_ratio_requested=card_peak_req / mcost.peak_live_bytes,
               flops=ccost.flops, memory_bytes=ccost.memory_bytes,
               n_ops=sum(ccost.ops.values()), launches=launches,
               smem_probes=len(probes), smem_by_export=by_export,
               smem_max=max(n for _, _, n in probes), smem_optin=optin,
               kernelcheck=cov, meta_s=t_meta, card_s=t_ab, seconds=secs)
    print(f"[dryrun] gpt2-large decode_1k raceit_q8: params + cache "
          f"{got_bytes} B asked of the allocator = {want_bytes} B reckoned "
          f"({got_blocks} B of blocks, {want_512} B in 512-byte granules); "
          f"traced peak {mcost.peak_live_bytes} B, card peak over the step "
          f"{card_peak} B of blocks (ratio {res['peak_ratio']:.4f}), "
          f"{card_peak_req} B asked (ratio "
          f"{res['peak_ratio_requested']:.4f}); counter on the card = on meta: "
          f"{ccost.flops:.6g} flops, {ccost.memory_bytes:.6g} B, "
          f"{res['n_ops']} ops, {len(ccost.launches)} kernel launches; "
          f"{len(probes)} smem layouts equal to the sources' exports "
          f"({by_export}), max {res['smem_max']} B <= {optin} B opt-in; "
          f"{secs:.1f} s (meta {t_meta:.1f} s, card {t_ab:.1f} s) "
          f"({device_desc})", flush=True)
    return res


# ----------------------------------------------------------- phase 25

FSDP_MESH = "data=2,model=2"
MESH_TRAIN_STEPS = 3
# params of a mesh run against the no-mesh run's after the same steps:
# within a tenth of the largest move AdamW can make in those steps (the
# sum of the step's lr), tests/test_torch_mesh_train.py's rule
MESH_PARAM_SHARE = 0.1


def fsdp_mesh():
    """The ``data=2,model=2`` spec, built with every position on cuda:0."""
    from repro_torch.dist import MeshSpec
    spec = MeshSpec.parse(FSDP_MESH)
    return spec, spec.build(["cuda:0"] * spec.n_devices)


def tree_bytes(t) -> int:
    from repro_torch import tree
    return sum(x.codes.nbytes + x.scale.nbytes if hasattr(x, "codes")
               else x.numel() * x.element_size() for x in tree.leaves(t))


def fsdp_serving(device_desc: str, ref) -> dict:
    """25(a): phase 22's gpt2-large (36 layers, resident int8) with
    ``fsdp=True`` under data=2,model=2, placed at load; its tokens against
    phase 22's no-mesh run on the same trace and weights."""
    from repro_torch.configs.base import ExecConfig
    from repro_torch.dist import position_bytes
    from repro_torch.serve import GenerationEngine
    eng, requests, single = ref
    spec, mesh = fsdp_mesh()
    cfg = eng.cfg.replace(fsdp=True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fs = GenerationEngine(cfg, eng.params,
                          ExecConfig.serving(mode="raceit", mesh=spec),
                          max_len=eng.max_len, device=eng.device)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    placed_bytes = torch.cuda.memory_allocated() - before
    check(fs.plan.backend("attention_decode") == "raceit_fused_tp"
          and fs.plan.backend("attention_prefill") == "raceit_fused_tp",
          f"gpt2-large {FSDP_MESH} plan: {fs.plan.explain()}")
    check(placed_bytes == 0, f"placing on one card allocated {placed_bytes} "
          f"bytes (every stripe should be a view)")
    whole = tree_bytes(eng.params)
    stripes = position_bytes(fs.params, mesh)
    r = serve_timed(fs, requests, f"gpt2-large fsdp {FSDP_MESH}")
    del fs
    check(r["results"] == single["results"],
          f"gpt2-large fsdp {FSDP_MESH} tokens differ from no mesh")
    per_call = 2 * 2 * 2 * cfg.n_layers  # passes x (probe, exact) x shards
    lp = r["launches"]["acam_attention_paged"]
    check(lp == per_call * r["calls"] and r["summary"]["mesh"] == FSDP_MESH,
          f"gpt2-large fsdp {FSDP_MESH}: {lp} paged launches for "
          f"{r['calls']} model calls")
    print(f"[fsdp] (a) gpt2-large {cfg.n_layers}L d{cfg.d_model} raceit_q8 "
          f"fsdp paged, {FSDP_MESH} on one card: placed in "
          f"{1e3 * place_s:.1f} ms, {placed_bytes} bytes allocated; stripe "
          f"bytes per position {stripes} of the whole tree's {whole}; "
          f"{r['tokens']} tokens, {r['tokens_per_s']:.1f} tok/s (no mesh "
          f"{single['tokens_per_s']:.1f}); decode step "
          f"{r['decode_ms']:.1f} ms (no mesh {single['decode_ms']:.1f}), "
          f"chunk {r['chunk_ms']:.1f} ms (no mesh {single['chunk_ms']:.1f});"
          f" {per_call} paged launches a model call ({lp} over "
          f"{r['calls']}); tokens equal to no mesh ({device_desc})",
          flush=True)
    out = {k: v for k, v in r.items() if k not in ("results", "summary")}
    return dict(fsdp=out, single={k: v for k, v in single.items()
                                  if k not in ("results", "summary")},
                place_s=place_s, placed_bytes=placed_bytes,
                stripe_bytes=stripes, whole_bytes=whole,
                launches={"acam_attention_paged": lp})


def tp_grad_check(what: str, cfg, mesh, batch: dict, device_desc: str,
                  seed: int = 0) -> dict:
    """The model-axis train step's loss and gradients against the no-mesh
    step's on the same weights (``seed``) and batch, within the CPU
    tests' contract (loss rtol TRAIN_LOSS_RTOL; each leaf within
    TRAIN_GRAD_RTOL max|g| + TRAIN_GRAD_ATOL), each pass timed
    (synchronised host clock); and each model position's weight products
    of the mesh pass (`repro_torch.dist.tp.record`: every layer's are the
    same, so this is one layer's)."""
    from repro_torch.dist import place_model_params, tp, unplace
    from repro_torch.models import Model
    from repro_torch.train import trainer
    net = Model(cfg, device=DEVICE)
    params = net.init(torch.Generator(device=DEVICE).manual_seed(seed))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l0, g0 = trainer.value_and_grad(net, params, batch)
    torch.cuda.synchronize()
    flat_ms = 1e3 * (time.perf_counter() - t0)
    placed = place_model_params(params, cfg, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tp.record() as log:
        l1, g1 = trainer.value_and_grad(net, placed, batch, mesh=mesh)
    torch.cuda.synchronize()
    mesh_ms = 1e3 * (time.perf_counter() - t0)
    loss_rel = abs(float(l1) - float(l0)) / abs(float(l0))
    worst, where = grad_gap(unplace(g1, DEVICE), g0)
    del g0, g1, placed, params
    torch.cuda.empty_cache()
    shapes = sorted({(m, n, shape) for m, n, shape in log})
    per = "; ".join(
        f"position {m}: " + ", ".join(f"{n} {tuple(sh)}" for mm, n, sh in
                                      shapes if mm == m)
        for m in sorted({m for m, _, _ in shapes}))
    print(f"[fsdp] (b) {what}: loss {float(l1):.7f} against no mesh "
          f"{float(l0):.7f} (rel {loss_rel:.2e}, tolerance "
          f"{TRAIN_LOSS_RTOL}); worst gradient leaf "
          f"{'/'.join(map(str, where or ()))} at {worst:.3f} of its "
          f"tolerance; value_and_grad {mesh_ms:.1f} ms with the mesh, "
          f"{flat_ms:.1f} ms without ({device_desc})", flush=True)
    print(f"[fsdp] (b) {what}: each position's weight products: {per}",
          flush=True)
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"{what}: loss {float(l1)} against no mesh {float(l0)}")
    check(worst <= 1.0, f"{what}: gradient leaf {where} at {worst:.3f} of "
          f"its tolerance")
    check(len({m for m, _, _ in shapes}) == mesh.shape.get("model", 1),
          f"{what}: products recorded at positions "
          f"{sorted({m for m, _, _ in shapes})}")
    return dict(loss=float(l1), loss_no_mesh=float(l0), loss_rel=loss_rel,
                worst_grad=worst, worst_leaf="/".join(map(str, where or ())),
                ms=mesh_ms, ms_no_mesh=flat_ms,
                products=[[m, n, list(sh)] for m, n, sh in shapes])


def mesh_training_families(device_desc: str) -> dict:
    """25(b), the other families on the model axis, every position on
    cuda:0: mamba2-130m at its width on data=1,model=2 (the SSD by heads),
    its gradients against no mesh and 2 steps each way; mixtral-8x22b at
    its width, 1 of 56 layers, on model=2 (attention by heads, the MoE's
    TP-in-expert body), its gradients against no mesh."""
    from repro_torch.configs import get_config
    from repro_torch.dist import MeshSpec, place_model_params
    from repro_torch.models import Model
    from repro_torch.train import optim, trainer
    out = {}
    rng = np.random.default_rng(SEED + 25)
    spec = MeshSpec.parse("data=1,model=2")
    mesh = spec.build(["cuda:0"] * spec.n_devices)
    cfg = get_config("mamba2-130m").replace(param_dtype="float32",
                                            compute_dtype="float32")
    batches = [{"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (8, 256)).astype(np.int32), device=DEVICE)}
        for _ in range(2)]
    out["mamba2"] = tp_grad_check(
        "mamba2-130m at its width, 24 layers, data=1,model=2, 8 x 256",
        cfg, mesh, batches[0], device_desc)
    opt_cfg = optim.AdamWConfig(lr=3e-4)
    runs = {}
    for name, m in (("none", None), ("mesh", mesh)):
        net = Model(cfg, device=DEVICE)
        params = net.init(torch.Generator(device=DEVICE).manual_seed(0))
        if m is not None:
            params = place_model_params(params, cfg, m)
        step = trainer.make_train_step(net, opt_cfg, mesh=m)
        opt_state = optim.adamw_init(params)
        losses, ms = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, met = step(params, opt_state, b)
            losses.append(float(met["loss"]))
            ms.append(1e3 * (time.perf_counter() - t0))
        runs[name] = (losses, ms)
        del params, opt_state, step
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["mesh"][0],
                                                  runs["none"][0]))
    print(f"[fsdp] (b) mamba2-130m 2 steps: losses data=1,model=2 "
          f"{', '.join(f'{x:.6f}' for x in runs['mesh'][0])}, no mesh "
          f"{', '.join(f'{x:.6f}' for x in runs['none'][0])} (worst rel "
          f"{rel:.2e}); step ms "
          f"{', '.join(f'{x:.1f}' for x in runs['mesh'][1])} against "
          f"{', '.join(f'{x:.1f}' for x in runs['none'][1])} "
          f"({device_desc})", flush=True)
    check(rel <= TRAIN_LOSS_RTOL, f"mamba2 mesh steps: losses "
          f"{runs['mesh'][0]} against {runs['none'][0]}")
    out["mamba2"].update(step_losses=runs["mesh"][0],
                         step_losses_no_mesh=runs["none"][0],
                         step_ms=runs["mesh"][1],
                         step_ms_no_mesh=runs["none"][1])
    spec = MeshSpec.parse("model=2")
    mesh = spec.build(["cuda:0"] * spec.n_devices)
    cfg = get_config("mixtral-8x22b").replace(
        n_layers=1, param_dtype="float32", compute_dtype="float32",
        remat="none")
    tokens = rng.integers(0, cfg.vocab_size, (2, 256)).astype(np.int32)
    out["mixtral"] = tp_grad_check(
        "mixtral-8x22b at its width, 1 of 56 layers, model=2 "
        "(TP-in-expert), 2 x 256", cfg, mesh,
        {"tokens": torch.as_tensor(tokens, device=DEVICE)}, device_desc)
    return out


def mesh_training(device_desc: str) -> dict:
    """25(b): gpt2-large at its width, ``fsdp`` on, 3 steps through
    `launch.train.train` on data=2,model=2 (each replica's products split
    over its two model positions) against 3 no-mesh steps on the same
    weights (seed 0) and batches, and the first batch's loss and
    gradients against no mesh's; the mesh run's checkpoint restored
    without a mesh, bit for bit, and resumed for one more step through
    `launch.train` on the mesh (the launcher's auto-resume: the elastic
    restore onto its placed state) against that step taken on the run's
    own state; then `mesh_training_families`."""
    import shutil
    from repro_torch import tree
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import position_bytes, unplace
    from repro_torch.launch import train as launch
    from repro_torch.models import Model
    from repro_torch.train import optim, trainer
    spec, mesh = fsdp_mesh()
    steps = MESH_TRAIN_STEPS
    cfg = get_config("gpt2-large").replace(param_dtype="float32",
                                           compute_dtype="float32",
                                           fsdp=True)
    opt_cfg = optim.AdamWConfig(lr=3e-4,
                                schedule=optim.warmup_cosine(20, steps))
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=256,
                       global_batch=8, seed=0)
    batches = [{k: torch.as_tensor(v, device=DEVICE)
                for k, v in data.next_batch().items()}
               for _ in range(steps + 1)]  # the last: the resumed step's
    none = lambda: None
    quiet = {k: 0 for k in KERNEL_NAMES}
    grads = tp_grad_check(f"gpt2-large at its width, fsdp, {FSDP_MESH}, "
                          f"8 x 256", cfg, mesh, batches[0], device_desc)
    # no mesh: the launcher's weights, schedule and batches, step by step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()  # what earlier phases still hold
    net = Model(cfg, device=DEVICE)
    params = net.init(torch.Generator(device=DEVICE).manual_seed(0))
    opt_state = optim.adamw_init(params)
    step = trainer.make_train_step(net, opt_cfg)
    torch.cuda.synchronize()
    state = torch.cuda.memory_allocated() - start  # weights and moments
    losses, step_ms = [], []
    for b in batches[:steps]:
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, b)
        losses.append(float(m["loss"]))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    peak = (torch.cuda.max_memory_allocated() - start) / 2 ** 30
    over = peak - state / 2 ** 30
    prof = profile_run("one no-mesh gpt2-large train step (8 x 256)",
                       lambda: step(params, opt_state, batches[steps - 1]),
                       none, quiet, top=3)
    del opt_state, step
    torch.cuda.empty_cache()
    # the mesh: through the launcher, onto every position of cuda:0
    ckpt = TRAIN_CKPT.parent / "mesh_train_smoke"
    shutil.rmtree(ckpt, ignore_errors=True)
    logs = []
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # the no-mesh weights, kept
        t0 = time.perf_counter()
        mp, mo, out = launch.train("gpt2-large", steps=steps, mesh=mesh,
                                   ckpt_dir=str(ckpt), device=DEVICE,
                                   overrides={"fsdp": True},
                                   log=logs.append)
        run_s = time.perf_counter() - t0
        mpeak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        mover = mpeak - state / 2 ** 30  # over its weights and moments
        mlosses = [r["loss"] for r in out["history"]]
        mstep_ms = [1e3 * r["step_time_s"] for r in out["history"]]
        check(out["final_step"] == steps and not logs,
              f"mesh train: step {out['final_step']}, logs {logs}")
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(mlosses, losses))
        lr_sum = sum(float(opt_cfg.lr * opt_cfg.schedule(torch.tensor(t)))
                     for t in range(1, steps + 1))
        whole_mp = unplace(mp, DEVICE)  # the bases: no copy on one card
        gap = max(float((a - b).abs().max()) for a, b in zip(
            tree.leaves(whole_mp), tree.leaves(params)))
        stripes = position_bytes(mp, mesh)
        whole = tree_bytes(whole_mp)
        mstep = trainer.make_train_step(Model(cfg, device=DEVICE), opt_cfg,
                                        mesh=mesh)
        mprof = profile_run(f"one {FSDP_MESH} gpt2-large train step",
                            lambda: mstep(mp, mo, batches[steps - 1]), none,
                            quiet, top=3)
        # step steps + 1 on the run's own state: what the resume must give
        cp, _, cm = mstep(mp, mo, batches[steps])
        cont_loss = float(cm["loss"])
        del mstep, cm
        # the mesh run's checkpoint, restored without a mesh
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, extra = CheckpointManager(ckpt).restore(
            (whole_mp, unplace(mo, DEVICE)))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in zip(
            tree.leaves(restored), tree.leaves((whole_mp, unplace(mo,
                                                                  DEVICE)))))
        del restored
        # the launcher resumes the mesh checkpoint onto its placed state
        # and takes one more step
        rlogs = []
        t0 = time.perf_counter()
        rp, _, rout = launch.train("gpt2-large", steps=steps + 1, mesh=mesh,
                                   ckpt_dir=str(ckpt), device=DEVICE,
                                   overrides={"fsdp": True},
                                   log=rlogs.append)
        resume_s = time.perf_counter() - t0
        rloss = [r["loss"] for r in rout["history"]]
        resume_gap = max(float((a - b).abs().max()) for a, b in zip(
            tree.leaves(unplace(rp, DEVICE)), tree.leaves(unplace(cp,
                                                                  DEVICE))))
        resume_tol = MESH_PARAM_SHARE * float(
            opt_cfg.lr * opt_cfg.schedule(torch.tensor(steps + 1)))
        del rp, cp
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"mesh train: losses {mlosses} against no mesh {losses}")
    check(gap <= MESH_PARAM_SHARE * lr_sum,
          f"mesh train: params {gap} from no mesh's (tolerance "
          f"{MESH_PARAM_SHARE * lr_sum})")
    check(same and extra == {"step": steps,
                             "data_state": {"step": steps, "seed": 0}},
          f"mesh train: the checkpoint restored without a mesh differs "
          f"(extra {extra})")
    check(rout["final_step"] == steps + 1 and len(rloss) == 1
          and rlogs == [f"[loop] resumed from step {steps}"],
          f"mesh train resume: step {rout['final_step']}, losses {rloss}, "
          f"logs {rlogs}")
    check(abs(rloss[0] - cont_loss) <= TRAIN_LOSS_RTOL * abs(cont_loss)
          and resume_gap <= resume_tol,
          f"mesh train resume: loss {rloss[0]} against {cont_loss}, params "
          f"{resume_gap} apart (tolerance {resume_tol})")
    idle = lambda p: (f"{p['idle_share']:.3f}" if p.get("measured")
                      else "not measured")
    print(f"[fsdp] (b) gpt2-large at its width, fsdp, 8 x 256 tokens a "
          f"step, {steps} steps: {FSDP_MESH} through launch.train losses "
          f"{', '.join(f'{x:.6f}' for x in mlosses)}, no mesh "
          f"{', '.join(f'{x:.6f}' for x in losses)} (worst rel "
          f"{loss_rel:.2e}, tolerance {TRAIN_LOSS_RTOL}); params after "
          f"step {steps} at most {gap:.3e} apart (tolerance "
          f"{MESH_PARAM_SHARE * lr_sum:.3e}); step ms mesh "
          f"{', '.join(f'{t:.1f}' for t in mstep_ms)}, no mesh "
          f"{', '.join(f'{t:.1f}' for t in step_ms)}; peak GiB over "
          f"what the run found held mesh {mpeak:.2f}, no mesh {peak:.2f} "
          f"(over the weights and moments: {mover:.2f} and {over:.2f});"
          f" idle share of one step mesh "
          f"{idle(mprof)}, no mesh {idle(prof)}; stripe bytes per position "
          f"{stripes} of the whole tree's {whole}; the mesh checkpoint "
          f"restored without a mesh bit for bit in {restore_s:.2f} s (run "
          f"with its save {run_s:.1f} s); launch.train resumed it on "
          f"{FSDP_MESH} from step {steps} to {steps + 1}: loss "
          f"{rloss[0]:.6f} against {cont_loss:.6f} on the run's own state, "
          f"params {resume_gap:.3e} apart (tolerance {resume_tol:.3e}), "
          f"{resume_s:.1f} s with its restore and save ({device_desc})",
          flush=True)
    families = mesh_training_families(device_desc)
    return dict(grads=grads, families=families,
                losses=mlosses, losses_no_mesh=losses, loss_rel=loss_rel,
                param_gap=gap, param_tol=MESH_PARAM_SHARE * lr_sum,
                step_ms=mstep_ms, step_ms_no_mesh=step_ms, peak_gib=mpeak,
                peak_gib_no_mesh=peak, over_state_gib=mover,
                over_state_gib_no_mesh=over, profile=mprof, profile_no_mesh=prof,
                stripe_bytes=stripes, whole_bytes=whole,
                restore_s=restore_s, run_s=run_s, resume_loss=rloss[0],
                continued_loss=cont_loss, resume_param_gap=resume_gap,
                resume_s=resume_s)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False)")
    if sys.argv[1:2] == ["--headline"]:
        headline(Path(sys.argv[2]) if len(sys.argv) > 2 else ROOT)
        return
    from repro_torch.kernels import build
    desc = device_line()
    print(desc, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    t0 = time.perf_counter()
    libs = build.SOURCES
    build.build_all(libs)
    print(f"[build] {', '.join(libs)}: {time.perf_counter() - t0:.1f} s "
          f"(nvcc sm_90a, in parallel)", flush=True)
    ptxas = {lib: ptxas_report(build.build_log(lib)) for lib in libs}
    for lib, rows in ptxas.items():
        for r in rows:
            print(f"[build] {lib} {r['kernel']}: {r['registers']} registers, "
                  f"{r['smem']} bytes static shared memory (plus dynamic), "
                  f"{r['spill_stores']} / {r['spill_loads']} bytes spill "
                  f"stores / loads", flush=True)

    smem_rows = smem_report(desc)

    t_start = last = time.perf_counter()
    laps = {}

    def lap(name):  # seconds since the last lap, by phase
        nonlocal last
        now = time.perf_counter()
        laps[name] = now - last
        last = now

    kernel_rows = phase_kernels(desc)
    new_rows = phase_kernels_new(desc)
    prolog_rows, prolog_att = phase_prolog(desc)
    sweep_rows = phase_split_sweep(desc)
    lap("3 kernels")
    main_res, eng = phase_main(desc)
    prof_res = phase_profile(eng)
    del eng
    phase_agree()
    torch.cuda.empty_cache()
    lap("4-5 paged")
    bucket_res, gpt2 = phase_bucketed(desc)
    solo_res, command_r = phase_solo(desc)
    prof2_res = phase_profile_contiguous(gpt2, command_r)
    phase_agree_contiguous(gpt2, command_r)
    del command_r
    torch.cuda.empty_cache()
    lap("6-8 bucketed, solo")
    api_res = phase_kernel_api(desc)
    acam_res = phase_acam_oracle(desc)
    sqrt_d_res = phase_sqrt_d_api(desc)
    staged_res = phase_staged(gpt2, desc)
    del gpt2
    torch.cuda.empty_cache()
    lap("9-10 api, staged")
    pool_res = phase_contiguous_pool(desc)
    lap("11 pool")
    gqa_res = phase_gqa_bias_paged(desc)
    lap("12 gqa-paged")
    gemma_res = phase_gemma3_pool(desc)
    lap("13 gemma3")
    moe_pool_res = phase_moe_pool(desc)
    lap("14 moe pool")
    moe_paged_res, scout = phase_moe_paged(desc)
    lap("15 moe paged")
    tp_res, tp_ref = phase_tp(desc, scout)
    del scout
    torch.cuda.empty_cache()
    lap("22 tp")
    fsdp_res = {"serving": fsdp_serving(desc, tp_ref)}
    del tp_ref
    torch.cuda.empty_cache()
    lap("25a fsdp serving")
    ssm_res = phase_ssm_pool(desc)
    lap("16 ssm pool")
    hybrid_res = phase_hybrid_pool(desc)
    lap("17 hybrid pool")
    encoder_res = phase_encoder(desc)
    lap("18 encoder")
    whisper_res = phase_whisper(desc)
    lap("19 whisper")
    mrope_res = phase_mrope_paged(desc)
    lap("20 mrope paged")
    noise_res = phase_noise(desc)
    lap("21 noise")
    train_res = phase_train(desc)
    lap("23 train")
    dryrun_res = phase_dryrun(desc)
    lap("24 dryrun")
    fsdp_res["training"] = mesh_training(desc)
    torch.cuda.empty_cache()
    lap("25b mesh train")
    print(f"[time] phases 3 to 25: {time.perf_counter() - t_start:.1f} s; "
          + ", ".join(f"{k} {v:.1f} s" for k, v in laps.items()), flush=True)

    # each kernel's headline: its main-path decode shape in mode pot
    heads = {"acam_attention_paged": "gpt2-large decode pot",
             "acam_attention": "gpt2-large bucket decode pot",
             "acam_attention_single": "command-r solo gqa decode pot"}
    replaces = {"acam_attention_paged": "src/repro/kernels/acam_attention.py:182",
                "acam_attention": "src/repro/kernels/acam_attention.py:182",
                "acam_attention_single": "src/repro/kernels/acam_attention.py:345"}
    # launches on the main paths, each counted from 0 over its own run
    launches = {"acam_attention_paged": (
                    main_res["launches"]
                    + gqa_res["launches"]["acam_attention_paged"]
                    + moe_paged_res["launches"]["acam_attention_paged"]
                    + mrope_res["launches"]["acam_attention_paged"]
                    + tp_res["launches"]["acam_attention_paged"]
                    + fsdp_res["serving"]["launches"][
                        "acam_attention_paged"]),
                "acam_attention": (bucket_res["launches"]["acam_attention"]
                                   + solo_res["launches"]["acam_attention"]
                                   + pool_res["launches"]["acam_attention"]
                                   + gemma_res["launches"]["acam_attention"]
                                   + moe_pool_res["launches"][
                                       "acam_attention"]
                                   + hybrid_res["launches"][
                                       "acam_attention"]
                                   + encoder_res["launches"][
                                       "acam_attention"]
                                   + whisper_res["launches"][
                                       "acam_attention"]
                                   + train_res["launches"][
                                       "acam_attention"]),
                "acam_attention_single": (
                    solo_res["launches"]["acam_attention_single"]
                    + whisper_res["launches"]["acam_attention_single"])}
    kernels = []
    for name, case in heads.items():
        head = next(r for r in kernel_rows if r["case"] == case)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{KERNEL_SOURCES[name]}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in kernel_rows
                               if r["kernel"] == name),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None})
    # this slice's kernels: the kernel API's shapes (mode pot, exact ADC,
    # the int32 codes acam_activation passes), launches of phase 9
    new_heads = {"acam_lut": "gpt2-large gelu (512, 5120) int32",
                 "acam_mvm": "gpt2-large fc1 (512, 1280) x (1280, 5120) exact",
                 "acam_softmax": "gpt2-large staged prefill (10240, 512) pot"}
    for name, case in new_heads.items():
        head = next(r for r in new_rows if r["case"] == case)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": NEW_KERNELS[name],
            "launches": api_res["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in new_rows
                               if r["kernel"] == name),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"]})
    # the paged entries' prolog (no TPU kernel: the reference quantizes in
    # jnp), one per paged attention call on the main paths
    head = prolog_rows[0]
    kernels.append({
        "name": "acam_prolog", "route": "cuda",
        "source": "src/repro_torch/csrc/acam_prolog.cu", "replaces": None,
        "launches": (main_res["prolog_launches"]
                     + gqa_res["launches"]["acam_prolog"]
                     + moe_paged_res["launches"]["acam_prolog"]
                     + mrope_res["launches"]["acam_prolog"]),
        "max_abs_err": 0.0, "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None})
    print("[record] " + json.dumps({"cases": kernel_rows + new_rows
                                    + prolog_rows,
                                    "prolog_attribution": prolog_att,
                                    "sweep": sweep_rows, "ptxas": ptxas,
                                    "main": main_res, "profile": prof_res,
                                    "bucketed": bucket_res,
                                    "solo": solo_res,
                                    "profile_contiguous": prof2_res,
                                    "kernel_api": api_res,
                                    "acam_oracle": acam_res,
                                    "sqrt_d_api": sqrt_d_res,
                                    "staged": staged_res,
                                    "contiguous_pool": pool_res,
                                    "gqa_bias_paged": gqa_res,
                                    "gemma3_pool": gemma_res,
                                    "moe_pool": moe_pool_res,
                                    "moe_paged": moe_paged_res,
                                    "ssm_pool": ssm_res,
                                    "hybrid_pool": hybrid_res,
                                    "encoder": encoder_res,
                                    "whisper": whisper_res,
                                    "mrope_paged": mrope_res,
                                    "noise": noise_res,
                                    "tp": tp_res,
                                    "train": train_res,
                                    "dryrun": dryrun_res,
                                    "fsdp": fsdp_res,
                                    "laps": laps,
                                    "smem_d320": smem_rows}),
          flush=True)
    print(desc, flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
