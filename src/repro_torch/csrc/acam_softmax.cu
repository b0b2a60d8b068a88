// Row-wise Compute-ACAM softmax (paper Fig. 8) on LOGIT codes, for sm_90a:
// (R, L) int8 or int32 LOGIT codes -> (R, L) int32 PROB codes.
//
// Replaces the TPU kernel src/repro/kernels/acam_softmax.py::_softmax_kernel
// (a (block_rows, Lp) VMEM tile per grid step, Lp = L padded to 128). What it
// computes, per row:
//
//   e  = pot_vals[exp_lut[x + 128]]   exp LUT to PoT codes, PoT decode
//   S  = sum of e over the padded row (padded columns add exact zeros)
//   L  = log_lut[pot_encode(S)]       LOG of the PoT-encoded sum
//   out = prob_lut[clip(x - (L << frac_shift), -128, 127) + 128]
//
// Four 256-entry tables sit in shared memory: the exp LUT's PoT codes, the
// PoT values, the log LUT and the exp_prob LUT. The PoT values are built on
// the host the way the reference's jitted graph decodes codes known only at
// run time: exp(f32(ln 2) * e) with XLA's CPU exp, which is one ulp off the
// correctly rounded value at some pot_fine codes (so the attention kernels'
// constant-folded tables do not serve here).
//
// Bit-exactness with the reference (acam_softmax_codes_plain repeats every
// step): the row sum follows XLA's CPU reduction order over the padded
// width, runs of 32 added one by one and the run totals summed again by the
// same rule until one is left (acam_common.cuh chunk_bounds); the PoT
// encoder is the attention kernels' (XLA's log with its FMAs); the file is
// built with -fmad=false.
//
// What bounds it on an H100: bytes (each code read once, 1 or 4 bytes, and
// its PROB code written once, 4 bytes); the sum's serial runs are a few
// hundred dependent adds per row. One block of 128 threads per row stages
// the row's PoT values in shared memory (skewed one word per 32, so the
// threads summing neighbouring runs hit different banks), sums the runs
// level by level, and writes the row. Several rows per block and a warp per
// short row are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "acam_common.cuh"

namespace {

using namespace acam;

constexpr int kThreads = 128;

struct SmParams {
  const void* x;
  int x_is_int8;
  const int* exp_lut;
  const float* pot_vals;
  const int* log_lut;
  const int* prob_lut;
  int* out;
  int L, Lp;
  PotConsts pot;
  int frac_shift;
};

__device__ __forceinline__ int code_at(const SmParams& p, long long i) {
  return p.x_is_int8 ? (int)static_cast<const int8_t*>(p.x)[i]
                     : static_cast<const int*>(p.x)[i];
}

__host__ __device__ __forceinline__ int skew(int k) { return k + (k >> 5); }

__global__ void __launch_bounds__(kThreads) softmax_rows(SmParams p) {
  __shared__ int s_exp[256], s_log[256], s_prob[256];
  __shared__ float s_pot[256];
  __shared__ int s_L;
  extern __shared__ float dyn[];
  const int tid = threadIdx.x;
  for (int i = tid; i < 256; i += kThreads) {
    s_exp[i] = p.exp_lut[i];
    s_pot[i] = p.pot_vals[i];
    s_log[i] = p.log_lut[i];
    s_prob[i] = p.prob_lut[i];
  }
  __syncthreads();
  const long long base = (long long)blockIdx.x * p.L;
  const int n_runs = n_chunks(p.Lp);
  float* ev = dyn;                       // skew(Lp) values
  float* buf_a = dyn + skew(p.Lp) + 1;   // run totals, two levels
  float* buf_b = buf_a + n_runs + 1;

  for (int k = tid; k < p.Lp; k += kThreads) {
    float e = 0.0f;  // padded columns are masked out of the sum
    if (k < p.L) {
      const int c = min(max(code_at(p, base + k) + 128, 0), 255);
      e = s_pot[s_exp[c]];
    }
    ev[skew(k)] = e;
  }
  __syncthreads();
  for (int c = tid; c < n_runs; c += kThreads) {
    int a, b;
    chunk_bounds(p.Lp, c, a, b);
    float s = ev[skew(a)];
    for (int t = a + 1; t < b; ++t) s = __fadd_rn(s, ev[skew(t)]);
    buf_a[c] = s;
  }
  __syncthreads();
  float* src = buf_a;
  float* dst = buf_b;
  for (int n = n_runs; n > 1;) {
    const int nr = n_chunks(n);
    for (int c = tid; c < nr; c += kThreads) {
      int a, b;
      chunk_bounds(n, c, a, b);
      float s = src[a];
      for (int t = a + 1; t < b; ++t) s = __fadd_rn(s, src[t]);
      dst[c] = s;
    }
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
    n = nr;
  }
  if (tid == 0) s_L = s_log[pot_encode(src[0], p.pot)];
  __syncthreads();
  const int shifted = s_L * (1 << p.frac_shift);
  for (int k = tid; k < p.L; k += kThreads) {
    const int d = min(max(code_at(p, base + k) - shifted, kLogitMin),
                      kLogitMax);
    p.out[base + k] = s_prob[d + 128];
  }
}

size_t smem_bytes(int Lp) {
  const int runs = Lp / kRun + (Lp % kRun != 0);  // n_chunks(Lp), or more
  return (size_t)(skew(Lp) + 1 + 2 * (runs + 1)) * sizeof(float);
}

}  // namespace

// x: (R, L) codes, int8 when x_is_int8, else int32; out: (R, L) int32;
// Lp: L padded to a multiple of 128 (the reference's lane padding, which
// shapes the row sum's runs). Launches on `stream` and returns the CUDA
// error code.
extern "C" int acam_softmax_launch(const void* x, int x_is_int8,
                                   const void* exp_lut, const void* pot_vals,
                                   const void* log_lut, const void* prob_lut,
                                   void* out, int R, int L, int Lp,
                                   float e_min, float step_scale,
                                   float safe_min, float thr, int frac_shift,
                                   void* stream) {
  if (R <= 0 || L <= 0 || Lp < L || Lp % 128 != 0)
    return (int)cudaErrorInvalidValue;
  SmParams p;
  p.x = x;
  p.x_is_int8 = x_is_int8;
  p.exp_lut = static_cast<const int*>(exp_lut);
  p.pot_vals = static_cast<const float*>(pot_vals);
  p.log_lut = static_cast<const int*>(log_lut);
  p.prob_lut = static_cast<const int*>(prob_lut);
  p.out = static_cast<int*>(out);
  p.L = L; p.Lp = Lp;
  p.pot = PotConsts{e_min, step_scale, safe_min, thr};
  p.frac_shift = frac_shift;
  const size_t smem = smem_bytes(Lp);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)softmax_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  softmax_rows<<<R, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
