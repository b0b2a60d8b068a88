// One-tile Fig.-12 RACE-IT attention over contiguous int8 k/v, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/acam_attention.py::
// _attn_kernel_single: the call where the whole problem fits one tile (the
// reference's ng == nq == nk == 1: G <= 8 groups, Sq <= 256 rows, Sk <= 512
// keys after padding to Skp = max(128, Sk)), computed in ONE launch with no
// row-sum scratch in device memory and no second sweep over K.
//
// Design: one thread-block cluster of up to 8 CTAs, one CTA per group (the
// cluster is rounded up to a power of two; a CTA past G only joins the
// cluster barriers). Each CTA
//   1. computes its group's Sq x Skp LOGIT codes (int8) into shared memory
//      (__dp4a on CUDA cores, K staged by 128-key tiles; masked keys at the
//      LOGIT minimum, keys past kv_len do not exist);
//   2. sums each row's exp values over all Skp keys in the reference's
//      order (acam_common.cuh chunk_bounds) and takes the row max, then
//      LOG(S) and the row's max PROB code;
//   3. folds its max PROB code into a cell in CTA 0's shared memory with a
//      distributed-shared-memory atomicMax; after cluster.sync() every CTA
//      reads the call-wide cmax (seeded with cmax_floor) from there;
//   4. rewrites its LOGIT codes in place as requantized PROB codes and
//      accumulates PROB . V, one V column per thread, reading V from device
//      memory (L2) once per pass over up to 16 rows per thread.
// Shared memory per CTA is at most 256 x 512 codes (128 KiB) plus the
// queries (32 KiB at D = 128), one K tile and the run partials: < 200 KiB.
//
// Bit-exactness: the same f32 op sequence as the two-pass kernels
// (acam_common.cuh); the row sum is ONE reduction over the Skp keys of the
// tile, as in _attn_kernel_single.
//
// What bounds it on an H100: launch latency and bytes; at the command-r solo
// decode shape (8 groups, 8 rows, 512 keys, D 128) it must read 1 MiB of K
// and V, a fraction of a microsecond at 3.35 TB/s. One CTA per group leaves
// most of the card idle; that is the price of one launch with no scratch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "acam_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace acam;

constexpr int kThreads = 256;
constexpr int kSub = 128;   // keys per staged K tile
constexpr int kOut = 16;    // int32 accumulators (rows) per thread per pass
constexpr int kMaxRows = 256;
constexpr int kMaxKeys = 512;

struct SParams {
  const int8_t* q;            // (G, Sq, D)
  const int8_t* k;            // (G, Sk, D)
  const int8_t* v;            // (G, Sk, D)
  const int* kv_len;          // (G,) valid keys per group, <= Sk
  const int8_t* mask;         // (G / mask_div, Sq, Sk) or null; 0 = masked key
  int mask_div;
  const float* logit_scale;   // () s_q * s_k
  const int* q_offset;        // () causal offset of row 0
  const float* exp_val;       // [256] f32
  const int* log_lut;         // [256]
  const int* prob_lut;        // [256]
  int* out;                   // (G, Sq, D) int32
  int* cmax;                  // [1] seeded with cmax_floor; the result
  int G, Sq, Sk, D, skp, causal, per_row;
  PotConsts pot;
  int frac_shift;
};

__device__ __forceinline__ bool masked(const SParams& p, int g, int row,
                                       int kpos, int qoff) {
  if (p.mask != nullptr) {
    const long long at = ((long long)(g / p.mask_div) * p.Sq + row) * p.Sk
                         + kpos;
    return p.mask[at] == 0;
  }
  return p.causal && kpos > row + qoff;
}

__global__ void __launch_bounds__(kThreads) single_tile(SParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int cmax_cell;    // CTA 0's cell is the cluster-wide max
  __shared__ int local_cmax;
  __shared__ int call_cmax;

  const int g = blockIdx.x;
  const bool live_cta = g < p.G;
  const int Sq = p.Sq, skp = p.skp, D = p.D, d4 = D / 4, ks = d4 + 1;
  const int nch = n_chunks(skp);
  const int len = live_cta ? p.kv_len[g] : 0;
  const float s1 = *p.logit_scale;
  const int qoff = p.causal ? *p.q_offset : 0;

  float* exp_s = reinterpret_cast<float*>(smem);          // 256
  int* rq_s = reinterpret_cast<int*>(exp_s + 256);        // 256
  int* lsh_s = rq_s + 256;                                // Sq
  int* xmax_s = lsh_s + Sq;                               // Sq
  float* run_s = reinterpret_cast<float*>(xmax_s + Sq);   // Sq * nch
  int* q_s = reinterpret_cast<int*>(run_s + Sq * nch);    // Sq * d4
  int* kv_s = q_s + Sq * d4;                              // kSub * ks
  int8_t* x_s = reinterpret_cast<int8_t*>(kv_s + kSub * ks);  // Sq * skp

  for (int i = threadIdx.x; i < 256; i += blockDim.x) exp_s[i] = p.exp_val[i];
  for (int r = threadIdx.x; r < Sq; r += blockDim.x) xmax_s[r] = kLogitMin;
  if (threadIdx.x == 0) {
    cmax_cell = *p.cmax;   // the floor (0 unless the caller seeds it)
    local_cmax = 0;
  }
  if (live_cta) load_words(q_s, d4, p.q + (long long)g * Sq * D, Sq, d4);

  // 1. LOGIT codes of the tile; keys past the fill level are never read
  for (int t0 = 0; t0 < skp; t0 += kSub) {
    const int nt = min(kSub, skp - t0);
    const int live = max(0, min(nt, len - t0));
    __syncthreads();
    load_words(kv_s, ks, p.k + ((long long)g * p.Sk + t0) * D, live, d4);
    __syncthreads();
    for (int idx = threadIdx.x; idx < Sq * nt; idx += blockDim.x) {
      const int r = idx / nt, c = idx % nt;
      int x = kLogitMin;
      if (c < live)
        x = masked(p, g, r, t0 + c, qoff)
                ? kLogitMin
                : logit_code(q_s + r * d4, kv_s + c * ks, d4, s1);
      x_s[r * skp + t0 + c] = (int8_t)x;
    }
  }
  __syncthreads();

  // 2. one row-sum reduction over the Skp keys, run by run, and the row max
  for (int idx = threadIdx.x; idx < Sq * nch; idx += blockDim.x) {
    const int r = idx / nch, c = idx % nch;
    int a, b;
    chunk_bounds(skp, c, a, b);
    const int8_t* xr = x_s + r * skp;
    float s = a < len ? exp_s[xr[a] + 128] : 0.0f;
    int m = a < len ? (int)xr[a] : kLogitMin;
    for (int t = a + 1; t < b; ++t) {
      const bool valid = t < len;
      s = __fadd_rn(s, valid ? exp_s[xr[t] + 128] : 0.0f);
      if (valid) m = max(m, (int)xr[t]);
    }
    run_s[idx] = s;
    atomicMax(&xmax_s[r], m);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < Sq; r += blockDim.x) {
    float S = run_s[r * nch];
    for (int c = 1; c < nch; ++c) S = __fadd_rn(S, run_s[r * nch + c]);
    const int L = p.log_lut[pot_encode(S, p.pot)];
    lsh_s[r] = L * (1 << p.frac_shift);
    const int dmax = min(max(xmax_s[r] - lsh_s[r], kLogitMin), kLogitMax);
    // zero-length groups of a per-group vector: zero rows, no cmax
    const int cr = (p.per_row && len == 0) ? 0 : p.prob_lut[dmax + 128];
    if (live_cta) atomicMax(&local_cmax, cr);
  }
  __syncthreads();

  // 3. the call-wide max PROB code, across the cluster through CTA 0's cell
  cluster.sync();  // every CTA's cell holds the floor before any atomic
  if (threadIdx.x == 0)
    atomicMax(cluster.map_shared_rank(&cmax_cell, 0), local_cmax);
  cluster.sync();
  if (threadIdx.x == 0) {
    call_cmax = *cluster.map_shared_rank(&cmax_cell, 0);
    if (g == 0) *p.cmax = call_cmax;
  }
  cluster.sync();  // CTA 0's shared memory outlives every remote read

  // 4. requantized PROB codes in place, then PROB . V over the live keys
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    rq_s[i] = requant_code(p.prob_lut[i], call_cmax);
  __syncthreads();
  for (int idx = threadIdx.x; idx < Sq * skp; idx += blockDim.x) {
    const int r = idx / skp, t = idx % skp;
    const int d = min(max((int)x_s[idx] - lsh_s[r], kLogitMin), kLogitMax);
    x_s[idx] = (int8_t)(t < len ? rq_s[d + 128] : 0);
  }
  __syncthreads();
  if (!live_cta) return;
  // thread (g, d): column d of V, rows g, g + ngrp, ... of each pass; a
  // warp reads one V row (coalesced) and broadcasts the PROB codes
  const int8_t* vg = p.v + (long long)g * p.Sk * D;
  const int ngrp = kThreads / D, grp = threadIdx.x / D, d = threadIdx.x % D;
  if (grp >= ngrp) return;
  for (int r0 = 0; r0 < Sq; r0 += ngrp * kOut) {
    int acc[kOut];
#pragma unroll
    for (int u = 0; u < kOut; ++u) acc[u] = 0;
    for (int t = 0; t < len; ++t) {
      const int vt = (int)__ldg(vg + (long long)t * D + d);
#pragma unroll
      for (int u = 0; u < kOut; ++u) {
        const int r = r0 + u * ngrp + grp;
        if (r < Sq) acc[u] += (int)x_s[r * skp + t] * vt;
      }
    }
#pragma unroll
    for (int u = 0; u < kOut; ++u) {
      const int r = r0 + u * ngrp + grp;
      if (r < Sq) p.out[((long long)g * Sq + r) * D + d] = acc[u];
    }
  }
}

size_t smem_single(int Sq, int skp, int d4) {
  const int nch = skp / kRun + 1;
  return sizeof(int) * (2 * 256 + 2 * Sq + Sq * nch + Sq * d4
                        + kSub * (d4 + 1)) + (size_t)Sq * skp;
}

}  // namespace

// Launch the one-tile kernel on `stream`; returns the launch's cudaError_t.
extern "C" int acam_attention_single_launch(
    const void* q, const void* k, const void* v, const void* kv_len,
    const void* mask, int mask_div, const void* logit_scale,
    const void* q_offset, const void* exp_val, const void* log_lut,
    const void* prob_lut, void* out, void* cmax, int G, int Sq, int Sk,
    int D, int skp, int causal, int per_row, float e_min, float step_scale,
    float safe_min, float thr, int frac_shift, void* stream) {
  if (D % 4 != 0 || D > 128 || G <= 0 || G > 8 || Sq <= 0 ||
      Sq > kMaxRows || Sk <= 0 || skp < Sk || skp > kMaxKeys)
    return (int)cudaErrorInvalidValue;
  SParams p;
  p.q = static_cast<const int8_t*>(q);
  p.k = static_cast<const int8_t*>(k);
  p.v = static_cast<const int8_t*>(v);
  p.kv_len = static_cast<const int*>(kv_len);
  p.mask = static_cast<const int8_t*>(mask);
  p.mask_div = mask_div;
  p.logit_scale = static_cast<const float*>(logit_scale);
  p.q_offset = static_cast<const int*>(q_offset);
  p.exp_val = static_cast<const float*>(exp_val);
  p.log_lut = static_cast<const int*>(log_lut);
  p.prob_lut = static_cast<const int*>(prob_lut);
  p.out = static_cast<int*>(out);
  p.cmax = static_cast<int*>(cmax);
  p.G = G; p.Sq = Sq; p.Sk = Sk; p.D = D; p.skp = skp;
  p.causal = causal; p.per_row = per_row;
  p.pot = PotConsts{e_min, step_scale, safe_min, thr};
  p.frac_shift = frac_shift;

  int cluster = 1;
  while (cluster < G) cluster *= 2;
  const size_t smem = smem_single(Sq, skp, D / 4);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)single_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, single_tile, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
