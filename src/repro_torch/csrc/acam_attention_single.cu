// One-tile Fig.-12 RACE-IT attention over contiguous int8 k/v, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/acam_attention.py::
// _attn_kernel_single: the call where the whole problem fits one tile (the
// reference's ng == nq == nk == 1: G <= 8 groups, Sq <= 256 rows, Sk <= 512
// keys after padding to Skp = max(128, Sk)), computed in ONE launch with no
// second sweep over K and no LOGIT codes in device memory.
//
// Design (the blocks are the two-pass kernels', acam_contiguous.cuh): each
// group's Skp keys are split over several CTAs on run boundaries
// (kernels/acam_attention.py single_plan), so a GQA decode of 8 groups runs
// on some 128 SMs, not 8. One cooperative launch of G x row tiles x splits
// CTAs, all co-resident:
//   1. each CTA computes its span's LOGIT codes (q . K on the int8 tensor
//      cores, K staged with cp.async), keeps them in shared memory, and
//      writes its rows' run totals and LOGIT max;
//   2. the CTA of a row tile that arrives last adds the run totals in run
//      order, takes LOG(S), folds the rows' max PROB codes into the cmax
//      cell (seeded with cmax_floor) and zeroes the rows;
//   3. a grid-wide barrier (a counter in device memory; the cooperative
//      launch guarantees every CTA is resident, so none waits forever):
//      the call-wide cmax needs every group;
//   4. each CTA requantizes its kept codes with the call-wide cmax and adds
//      PROB . V of its span (V staged with cp.async, transposed by byte
//      permutes, the int8 tensor cores) into the rows with atomicAdd.
//
// Bit-exactness: the row sum is still ONE reduction over all Skp keys: the
// runs of `sum_chunks(Skp)` added key by key, their totals added in run
// order. Since Skp == key_block(Sk), that is the two-pass kernel's single
// block sum, plus 0.0 (exact), so both kernels share the finisher.
//
// What bounds it on an H100: latency. At the command-r solo decode shape
// (8 groups, 8 rows, 512 keys, D 128) it must read 1 MiB of K and V, a
// fraction of a microsecond at 3.35 TB/s; the launch, the cp.async round
// trips and the barrier are what take the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "acam_common.cuh"
#include "acam_contiguous.cuh"
#include "acam_mma.cuh"

namespace {

using namespace acam;

// every CTA of the grid arrives before any goes on; the arrivals' writes
// (run totals, lsh, cmax, zeroed rows) are visible after it. Co-resident
// CTAs arrive within microseconds; a wait of seconds means they are not,
// and the kernel traps (a launch error) rather than hang the card.
__device__ __forceinline__ void grid_barrier(int* count, int blocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1);
    for (long long spin = 0;
         *reinterpret_cast<volatile int*>(count) < blocks; ++spin) {
      if (spin > (1ll << 26)) __trap();
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// 8 warps a CTA: one CTA an SM at most, so each CTA's own latency counts
constexpr int kSWarps = 8;

template <bool kWide>
__global__ void __launch_bounds__(32 * kSWarps) single_tile(CParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const CSlice s = contiguous_slice(p);
  const CLayout L = c_layout(p, 2);
  contiguous_pass_a<true, kSWarps, kWide>(p, s, smem, L);
  if (contiguous_arrive(p, s)) contiguous_finish<kSWarps>(p, s, smem, L);
  grid_barrier(p.cells + 1 + p.units, gridDim.x * gridDim.y);
  contiguous_pass_b<true, kSWarps>(p, s, smem, L);
}

}  // namespace

// The dynamic shared memory (bytes) of a one-tile launch at these shapes
// (acam_contiguous.cuh c_layout kind 2), or -1 for a shape the kernel does
// not take; `masked` says whether a mask is given.
extern "C" int acam_attention_single_smem(int G, int Sq, int Sk, int D,
                                          int skp, int masked, int splits,
                                          int per) {
  CParams p;
  int cell = 0;
  void* c = &cell;
  if (G > 8 || Sq > 256 || skp < Sk || skp > 512 ||
      !contiguous_params(p, c, c, c, c, masked ? c : nullptr, 1, c, 0.0f,
                         nullptr, 0, c, c, c, c, c, c, nullptr, c, c, G, Sq,
                         Sk, D, skp, 0, 0, splits, per, 0, 0.0f, 1.0f, 0.0f,
                         0.0f, 0))
    return -1;
  return c_layout(p, 2).total;
}

// Launch the one-tile kernel on `stream`; returns the CUDA error code. The
// split comes from kernels/acam_attention.py single_plan; cells holds
// 2 + G * ceil(Sq / 64) zeroed ints, the first seeded with cmax_floor.
extern "C" int acam_attention_single_launch(
    const void* q, const void* k, const void* v, const void* kv_len,
    const void* mask, int mask_div, const void* logit_scale, float rsd,
    const void* q_offset, int q_off, const void* exp_val,
    const void* log_lut, const void* prob_lut, void* out, void* run_tot,
    void* span_max,
    void* lsh, void* cells, int G, int Sq, int Sk, int D, int skp,
    int causal, int per_row, int splits, int per, float e_min,
    float step_scale, float safe_min, float thr, int frac_shift,
    void* stream) {
  CParams p;
  if (G > 8 || Sq > 256 || skp < Sk || skp > 512 ||
      !contiguous_params(p, q, k, v, kv_len, mask, mask_div, logit_scale,
                         rsd, q_offset, q_off, exp_val, log_lut, prob_lut,
                         out, run_tot, span_max, nullptr, lsh, cells, G, Sq, Sk, D,
                         skp, causal, per_row, splits, per, 0, e_min,
                         step_scale, safe_min, thr, frac_shift))
    return (int)cudaErrorInvalidValue;
  const size_t smem = c_layout(p, 2).total;
  const void* fn = D > 128 ? (const void*)single_tile<true>
                           : (const void*)single_tile<false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  // refused (cudaErrorCooperativeLaunchTooLarge) unless every CTA fits
  err = cudaLaunchCooperativeKernel(fn, dim3(p.units, splits),
                                    dim3(32 * kSWarps),
                                    args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
