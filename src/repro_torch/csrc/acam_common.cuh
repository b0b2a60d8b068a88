// Device helpers shared by the Fig.-12 attention kernels (acam_attention.cu,
// acam_attention_single.cu). Every float32 step is an explicit __f*_rn
// operation and the sources are built with -fmad=false, so nvcc fuses
// nothing the reference does not fuse.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace acam {

constexpr int kLogitMin = -128;
constexpr int kLogitMax = 127;
constexpr int kRun = 32;  // XLA's CPU reduction adds keys in runs of 32
// the widest head dim the attention kernels take (a multiple of 4; the
// wrappers pad narrower odd dims with zero codes): 320, gemma3-4b's
// d_model / n_heads. q fragments of the first 128 dims stay in registers,
// the rest are read from shared memory; PROB . V sweeps the keys once for
// every 16 x (warps a row tile) output tiles (three sweeps at D 320 where a
// warp has a row tile alone). At D 320 the largest block layout, the
// one-tile kernel's with a mask and a span of a whole key block, takes
// 194,048 bytes of dynamic shared memory (acam_contiguous.cuh c_layout),
// under the 232,448 a block may use.
constexpr int kMaxD = 320;

// float32 log as XLA's CPU backend evaluates it (Cephes logf, FMA-contracted)
__device__ __forceinline__ float ref_logf(float x) {
  x = fmaxf(x, 1.17549435e-38f);
  const int bits = __float_as_int(x);
  float e = __int2float_rn((bits >> 23) - 126);
  const float m = __int_as_float((bits & ~0x7f800000) | 0x3f000000);
  const bool small = m < 0.707106781186547524f;
  float xx = __fsub_rn(m, 1.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  xx = __fadd_rn(xx, small ? m : 0.0f);
  const float x2 = __fmul_rn(xx, xx);
  const float x3 = __fmul_rn(x2, xx);
  float y = __fmaf_rn(xx, 7.0376836292E-2f, -1.1514610310E-1f);
  float y1 = __fmaf_rn(xx, -1.2420140846E-1f, 1.4249322787E-1f);
  float y2 = __fmaf_rn(xx, 2.0000714765E-1f, -2.4999993993E-1f);
  y = __fmaf_rn(y, xx, 1.1676998740E-1f);
  y1 = __fmaf_rn(y1, xx, -1.6668057665E-1f);
  y2 = __fmaf_rn(y2, xx, 3.3333331174E-1f);
  y = __fmaf_rn(y, x3, y1);
  y = __fmaf_rn(y, x3, y2);
  y = __fmaf_rn(y, x3, __fmul_rn(e, -2.12194440e-4f));
  xx = __fsub_rn(xx, __fmul_rn(x2, 0.5f));
  xx = __fadd_rn(xx, y);
  return __fadd_rn(xx, __fmul_rn(e, 0.693359375f));
}

// the PoT encoder's constants: e_min, 1/octave_step, 2^(e_min-1) and the
// zero threshold 2^(e_min - step/2), each rounded to float32 on the host
struct PotConsts {
  float e_min, step_scale, safe_min, thr;
};

// PoT-encode a row sum exactly as repro.kernels.acam_attention._pot_encode_sum
__device__ __forceinline__ int pot_encode(float S, const PotConsts& c) {
  const float kInvLn2 = 0x1.715476p+0f;  // f32(1 / f32(ln 2))
  const float safe = fmaxf(S, c.safe_min);
  // log(x) * (1/ln 2) - e_min, contracted into one FMA as XLA does
  float y = __fmaf_rn(ref_logf(safe), kInvLn2, -c.e_min);
  if (c.step_scale != 1.0f) y = __fmul_rn(y, c.step_scale);
  const float e = fminf(fmaxf(rintf(y), 0.0f), 254.0f);
  return S < c.thr ? 0 : __float2int_rn(e) + 1;
}

// the LOGIT code of one (query, key) pair from its int32 dot product:
// matmul-1 + div-add. rsd is f32(1 / sqrt(d)) where sqrt(d) is not a power
// of two (0 when it is folded into s1): the reference divides by the
// constant sqrt(d) in a jitted graph, which XLA turns into this multiply,
// after the one by s1. The division by 2^-3 is the multiply by 8 (both
// exact, so the same float).
__device__ __forceinline__ int logit_of(int dot, float s1, float rsd) {
  float logits = __fmul_rn(__int2float_rn(dot), s1);
  if (rsd != 0.0f) logits = __fmul_rn(logits, rsd);
  const float x = rintf(__fmul_rn(logits, 8.0f));
  return __float2int_rn(fminf(fmaxf(x, (float)kLogitMin), (float)kLogitMax));
}

// requantized PROB code of table entry i for the call-wide max PROB code:
// quantize_tensor of the PROB values, max(cmax/256, 1e-12) * f32(1/127)
__device__ __forceinline__ int requant_code(int prob, int cmax) {
  const float amax = __fmul_rn(__int2float_rn(cmax), 0.00390625f);
  const float scale = __fmul_rn(fmaxf(amax, 1e-12f), 0x1.020408p-7f);
  const float pv = __fmul_rn(__int2float_rn(prob), 0.00390625f);
  const float c = rintf(__fdiv_rn(pv, scale));
  return __float2int_rn(fminf(fmaxf(c, -128.0f), 127.0f));
}

// How the reference sums a key block of n keys (sum_chunks in
// repro_torch/core/quant.py): runs added key by key, the run
// totals then added in order. Runs of 32; when 32 does not divide n (and
// n > 32) the first run and the remainder split into two halves.
__host__ __device__ __forceinline__ int n_chunks(int n) {
  const int m = n / kRun, r = n % kRun;
  return m == 0 ? 1 : (r == 0 ? m : m + 1);
}

__host__ __device__ __forceinline__ void chunk_bounds(int n, int c, int& a,
                                                    int& b) {
  const int m = n / kRun, r = n % kRun;
  if (m == 0) { a = 0; b = n; return; }
  if (r == 0) { a = kRun * c; b = a + kRun; return; }
  const int head = (kRun + r + 1) / 2;
  if (c == 0) { a = 0; b = head; return; }
  a = head + kRun * (c - 1);
  b = c == m ? n : a + kRun;
}

}  // namespace acam
