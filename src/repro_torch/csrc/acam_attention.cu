// Fused Fig.-12 RACE-IT attention over int8 codes, two passes, for sm_90a:
// over a block-paged KV pool (pass_a / pass_b) and over contiguous (G, Sk, D)
// k/v (contiguous_sums / contiguous_probv).
//
// Replaces the TPU kernel src/repro/kernels/acam_attention.py::_attn_kernel
// (its paged scalar-prefetch grid, its contiguous decode grid with scalar or
// per-group kv_len, and its causal / masked prefill grid). What it computes,
// per group g (a query head, or a KV head with its rep sharing queries) and
// query row i:
//
//   pass A  x = LOGIT code of round(f32(q.k) * s1 / 2^-3), masked keys at the
//           LOGIT minimum; S = sum over valid keys of exp_val[x] in the
//           reference's order; xmax = max valid x; the row's max PROB code
//           c = prob_lut[clip(xmax - LOG(S)<<fs)], folded into one call-wide
//           cmax with an integer atomicMax (order-free, so deterministic)
//           into a cell the wrapper seeds with cmax_floor.
//   pass B  requant table from the global cmax, PROB code of every valid key
//           through it, and the int32 product with V.
//
// The two passes are two launches on the caller's stream: pass B needs the
// grid-wide cmax of pass A, and blocks of one launch cannot wait for each
// other. Each block follows the block table itself (the TPU kernel
// prefetched it as a scalar operand) and stops at the group's own fill
// level: key blocks past kv_len hold no valid key and add exact zeros.
//
// Bit-exactness with the reference (the plain PyTorch versions in
// repro_torch/kernels/acam_attention.py repeat every step):
//   * rintf rounds half to even like jnp.round; the file is built with
//     -fmad=false and every f32 step is an explicit __f*_rn operation, so
//     nvcc fuses nothing the reference does not fuse;
//   * the row sum adds per-block sums in block order (a block is a page, or
//     bk = min(512, max(128, Sk)) contiguous keys); inside a block XLA's CPU
//     reduction adds runs of keys one by one and then the runs in order
//     (acam_common.cuh chunk_bounds), and so do these kernels;
//   * the PoT encoder's log is XLA's float32 log (a Cephes polynomial with
//     fused multiply-adds), and log * f32(1/ln 2) - e_min is one more FMA,
//     as XLA contracts it, so codes at half-step boundaries agree;
//   * constant divisors are reciprocal multiplies, as XLA rewrites them:
//     max(cmax/256, 1e-12) * f32(1/127); the table entry itself divides.
//
// What bounds it on an H100: bytes at decode (the int8 K read twice, once
// per pass, and V once, over the live keys only, plus the queries and the
// int32 output), operations in a long prefill. At 3.35 TB/s the decode
// bound is microseconds. This simple design stays far from it: one block
// per (group, 16-row tile) walks the keys one page or one 128-key tile at a
// time with plain loads, computes the logits with __dp4a on CUDA cores, and
// the row sums serially per run. A group stops at its own fill level, and a
// causally masked key skips its dot product. wgmma tiles, TMA loads,
// several groups per block and a persistent grid are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include "acam_common.cuh"

namespace {

using namespace acam;

constexpr int kThreads = 128;
constexpr int kRowTile = 16;
constexpr int kSub = 128;  // contiguous keys per K/V tile in shared memory

struct Params {
  const int8_t* q;            // (G, Sq, D)
  const int8_t* k;            // (n_pages * gps, page_size, D)
  const int8_t* v;            // (n_pages * gps, page_size, D)
  const int* block_table;     // (n_slots, max_pages)
  const int* kv_len;          // (G,) valid keys per group, <= max_pages*page_size
  const int8_t* mask;         // (G / mask_div, Sq, Sk) or null; 0 = masked key
  int mask_div;
  const float* logit_scale;   // () s_q * s_k
  const float* exp_val;       // [256] f32
  const int* log_lut;         // [256]
  const int* prob_lut;        // [256]
  int* out;                   // (G, Sq, D) int32
  float* row_sum;             // (G * Sq) f32 scratch: pass A -> pass B
  int* cmax;                  // [1] seeded with cmax_floor
  int G, Sq, D, page_size, max_pages, gps;
  PotConsts pot;
  int frac_shift;
};

__device__ __forceinline__ bool key_masked(const Params& p, int g, int row,
                                           int kpos) {
  if (p.mask == nullptr) return false;
  const long long sk = (long long)p.max_pages * p.page_size;
  const long long at = ((long long)(g / p.mask_div) * p.Sq + row) * sk + kpos;
  return p.mask[at] == 0;
}

__global__ void __launch_bounds__(kThreads) pass_a(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x, r0 = blockIdx.y * kRowTile;
  const int nr = min(kRowTile, p.Sq - r0);
  const int ps = p.page_size, d4 = p.D / 4, ks = d4 + 1;
  const int nrun = (ps + kRun - 1) / kRun;
  const int len = p.kv_len[g];
  const int nblk = len > 0 ? (len + ps - 1) / ps : 0;
  const int slot = g / p.gps, sub = g % p.gps;
  const float s1 = *p.logit_scale;

  float* exp_s = reinterpret_cast<float*>(smem);         // 256
  int* q_s = reinterpret_cast<int*>(exp_s + 256);        // kRowTile * d4
  int* k_s = q_s + kRowTile * d4;                        // ps * ks
  float* e_s = reinterpret_cast<float*>(k_s + ps * ks);  // kRowTile * ps
  int* x_s = reinterpret_cast<int*>(e_s + kRowTile * ps);  // kRowTile * ps
  float* run_s = reinterpret_cast<float*>(x_s + kRowTile * ps);  // kRowTile*nrun
  int* runmax_s = reinterpret_cast<int*>(run_s + kRowTile * nrun);
  float* sum_s = reinterpret_cast<float*>(runmax_s + kRowTile * nrun);  // kRowTile
  int* xmax_s = reinterpret_cast<int*>(sum_s + kRowTile);  // kRowTile
  __shared__ int block_cmax;

  for (int i = threadIdx.x; i < 256; i += blockDim.x) exp_s[i] = p.exp_val[i];
  load_words(q_s, d4, p.q + ((long long)g * p.Sq + r0) * p.D, nr, d4);
  if (threadIdx.x < kRowTile) {
    sum_s[threadIdx.x] = 0.0f;
    xmax_s[threadIdx.x] = kLogitMin;
  }
  if (threadIdx.x == 0) block_cmax = INT_MIN;
  __syncthreads();

  for (int j = 0; j < nblk; ++j) {
    const long long page = p.block_table[(long long)slot * p.max_pages + j];
    load_words(k_s, ks, p.k + (page * p.gps + sub) * ps * p.D, ps, d4);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nr * ps; idx += blockDim.x) {
      const int r = idx / ps, c = idx % ps, kpos = j * ps + c;
      int x = logit_code(q_s + r * d4, k_s + c * ks, d4, s1);
      if (key_masked(p, g, r0 + r, kpos)) x = kLogitMin;
      const bool valid = kpos < len;
      e_s[idx] = valid ? exp_s[x + 128] : 0.0f;
      x_s[idx] = valid ? x : kLogitMin;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nr * nrun; idx += blockDim.x) {
      const int r = idx / nrun, t0 = (idx % nrun) * kRun;
      const int t1 = min(t0 + kRun, ps);
      float s = e_s[r * ps + t0];
      int m = x_s[r * ps + t0];
      for (int t = t0 + 1; t < t1; ++t) {
        s = __fadd_rn(s, e_s[r * ps + t]);
        m = max(m, x_s[r * ps + t]);
      }
      run_s[idx] = s;
      runmax_s[idx] = m;
    }
    __syncthreads();
    if (threadIdx.x < nr) {
      const int r = threadIdx.x;
      float s = run_s[r * nrun];
      int m = runmax_s[r * nrun];
      for (int t = 1; t < nrun; ++t) {
        s = __fadd_rn(s, run_s[r * nrun + t]);
        m = max(m, runmax_s[r * nrun + t]);
      }
      sum_s[r] = __fadd_rn(sum_s[r], s);
      xmax_s[r] = max(xmax_s[r], m);
    }
    __syncthreads();
  }

  if (threadIdx.x < nr) {
    const int r = threadIdx.x;
    const float S = sum_s[r];
    const int L = p.log_lut[pot_encode(S, p.pot)];
    const int dmax = min(max(xmax_s[r] - L * (1 << p.frac_shift), kLogitMin),
                         kLogitMax);
    // a zero-length group has no keys: all-zero rows, no cmax contribution
    const int c = len > 0 ? p.prob_lut[dmax + 128] : 0;
    p.row_sum[(long long)g * p.Sq + r0 + r] = S;
    atomicMax(&block_cmax, c);
  }
  __syncthreads();
  if (threadIdx.x == 0) atomicMax(p.cmax, block_cmax);
}

__global__ void __launch_bounds__(kThreads) pass_b(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x, r0 = blockIdx.y * kRowTile;
  const int nr = min(kRowTile, p.Sq - r0);
  const int ps = p.page_size, D = p.D, d4 = D / 4, ks = d4 + 1;
  const int len = p.kv_len[g];
  const int nblk = len > 0 ? (len + ps - 1) / ps : 0;
  const int slot = g / p.gps, sub = g % p.gps;
  const float s1 = *p.logit_scale;

  int* rq_s = reinterpret_cast<int*>(smem);              // 256
  int* lsh_s = rq_s + 256;                               // kRowTile
  int* q_s = lsh_s + kRowTile;                           // kRowTile * d4
  int* k_s = q_s + kRowTile * d4;                        // ps * ks
  int* pc_s = k_s + ps * ks;                             // kRowTile * ps
  int8_t* v_s = reinterpret_cast<int8_t*>(pc_s + kRowTile * ps);  // ps * D

  // requant table from the global cmax (quantize_tensor of the PROB values)
  const int cm = *p.cmax;
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    rq_s[i] = requant_code(p.prob_lut[i], cm);
  if (threadIdx.x < nr) {
    const float S = p.row_sum[(long long)g * p.Sq + r0 + threadIdx.x];
    lsh_s[threadIdx.x] = p.log_lut[pot_encode(S, p.pot)] * (1 << p.frac_shift);
  }
  load_words(q_s, d4, p.q + ((long long)g * p.Sq + r0) * D, nr, d4);

  constexpr int kMaxOut = kRowTile * 128 / kThreads;  // D <= 128
  int acc[kMaxOut];
#pragma unroll
  for (int t = 0; t < kMaxOut; ++t) acc[t] = 0;
  __syncthreads();

  for (int j = 0; j < nblk; ++j) {
    const long long page = p.block_table[(long long)slot * p.max_pages + j];
    const long long base = (page * p.gps + sub) * ps * D;
    load_words(k_s, ks, p.k + base, ps, d4);
    {
      const int* src = reinterpret_cast<const int*>(p.v + base);
      int* dst = reinterpret_cast<int*>(v_s);
      for (int idx = threadIdx.x; idx < ps * d4; idx += blockDim.x)
        dst[idx] = src[idx];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nr * ps; idx += blockDim.x) {
      const int r = idx / ps, c = idx % ps, kpos = j * ps + c;
      int x = logit_code(q_s + r * d4, k_s + c * ks, d4, s1);
      if (key_masked(p, g, r0 + r, kpos)) x = kLogitMin;
      const int d = min(max(x - lsh_s[r], kLogitMin), kLogitMax);
      pc_s[idx] = kpos < len ? rq_s[d + 128] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kMaxOut; ++t) {
      const int idx = threadIdx.x + t * kThreads;
      if (idx < nr * D) {
        const int r = idx / D, d = idx % D;
        int a = acc[t];
        for (int c = 0; c < ps; ++c) a += pc_s[r * ps + c] * (int)v_s[c * D + d];
        acc[t] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < kMaxOut; ++t) {
    const int idx = threadIdx.x + t * kThreads;
    if (idx < nr * D) {
      const int r = idx / D, d = idx % D;
      p.out[((long long)g * p.Sq + r0 + r) * D + d] = acc[t];
    }
  }
}

size_t smem_pass_a(int ps, int d4) {
  const int nrun = (ps + kRun - 1) / kRun;
  return sizeof(int) * (256 + kRowTile * d4 + ps * (d4 + 1) + 2 * kRowTile * ps
                        + 2 * kRowTile * nrun + 2 * kRowTile);
}

size_t smem_pass_b(int ps, int d4) {
  return sizeof(int) * (256 + kRowTile + kRowTile * d4 + ps * (d4 + 1)
                        + kRowTile * ps) + (size_t)ps * d4 * 4;
}

// ---------------------------------------------------------------------------
// contiguous layout: k/v (G, Sk, D), key blocks of bk keys
// ---------------------------------------------------------------------------

struct CParams {
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
  float* row_sum;             // (G * Sq) f32 scratch: pass A -> pass B
  int* cmax;                  // [1] seeded with cmax_floor
  int G, Sq, Sk, D, bk, causal, per_row;
  PotConsts pot;
  int frac_shift;
};

// a masked key sits at the LOGIT minimum (mask array first, else causal)
__device__ __forceinline__ bool c_masked(const CParams& p, int g, int row,
                                         int kpos, int qoff) {
  if (p.mask != nullptr) {
    const long long at = ((long long)(g / p.mask_div) * p.Sq + row) * p.Sk
                         + kpos;
    return p.mask[at] == 0;
  }
  return p.causal && kpos > row + qoff;
}

__global__ void __launch_bounds__(kThreads) contiguous_sums(CParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x, r0 = blockIdx.y * kRowTile;
  const int nr = min(kRowTile, p.Sq - r0);
  const int D = p.D, d4 = D / 4, ks = d4 + 1, bk = p.bk;
  const int nch = n_chunks(bk);
  const int len = p.kv_len[g];
  const int nblk = (len + bk - 1) / bk;  // blocks past the fill add zeros
  const float s1 = *p.logit_scale;
  const int qoff = p.causal ? *p.q_offset : 0;

  float* exp_s = reinterpret_cast<float*>(smem);          // 256
  int* q_s = reinterpret_cast<int*>(exp_s + 256);         // kRowTile * d4
  int* k_s = q_s + kRowTile * d4;                         // kSub * ks
  float* e_s = reinterpret_cast<float*>(k_s + kSub * ks);  // kRowTile * bk
  float* run_s = e_s + kRowTile * bk;                     // kRowTile * nch
  float* sum_s = run_s + kRowTile * nch;                  // kRowTile
  int* xmax_s = reinterpret_cast<int*>(sum_s + kRowTile);  // kRowTile
  __shared__ int block_cmax;

  for (int i = threadIdx.x; i < 256; i += blockDim.x) exp_s[i] = p.exp_val[i];
  load_words(q_s, d4, p.q + ((long long)g * p.Sq + r0) * D, nr, d4);
  if (threadIdx.x < kRowTile) {
    sum_s[threadIdx.x] = 0.0f;
    xmax_s[threadIdx.x] = kLogitMin;
  }
  if (threadIdx.x == 0) block_cmax = INT_MIN;

  for (int j = 0; j < nblk; ++j) {
    const int kb0 = j * bk;
    for (int t0 = 0; t0 < bk; t0 += kSub) {
      const int nt = min(kSub, bk - t0);
      const int live = max(0, min(nt, len - (kb0 + t0)));
      __syncthreads();  // the previous tile's readers are done with k_s
      load_words(k_s, ks, p.k + ((long long)g * p.Sk + kb0 + t0) * D, live,
                 d4);
      __syncthreads();
      for (int idx = threadIdx.x; idx < nr * nt; idx += blockDim.x) {
        const int r = idx / nt, c = idx % nt, kpos = kb0 + t0 + c;
        float e = 0.0f;  // keys past the fill level do not exist
        if (c < live) {
          const int x = c_masked(p, g, r0 + r, kpos, qoff)
                            ? kLogitMin
                            : logit_code(q_s + r * d4, k_s + c * ks, d4, s1);
          e = exp_s[x + 128];
          atomicMax(&xmax_s[r], x);
        }
        e_s[r * bk + t0 + c] = e;
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nr * nch; idx += blockDim.x) {
      const int r = idx / nch, c = idx % nch;
      int a, b;
      chunk_bounds(bk, c, a, b);
      const float* er = e_s + r * bk;
      float s = er[a];
      for (int t = a + 1; t < b; ++t) s = __fadd_rn(s, er[t]);
      run_s[idx] = s;
    }
    __syncthreads();
    if (threadIdx.x < nr) {
      const int r = threadIdx.x;
      float s = run_s[r * nch];
      for (int c = 1; c < nch; ++c) s = __fadd_rn(s, run_s[r * nch + c]);
      sum_s[r] = __fadd_rn(sum_s[r], s);
    }
  }
  __syncthreads();

  if (threadIdx.x < nr) {
    const int r = threadIdx.x;
    const float S = sum_s[r];
    const int L = p.log_lut[pot_encode(S, p.pot)];
    const int dmax = min(max(xmax_s[r] - L * (1 << p.frac_shift), kLogitMin),
                         kLogitMax);
    // a zero-length group of a per-group vector has no keys: zero rows and
    // no cmax contribution (a scalar length keeps the reference's rule)
    const int c = (p.per_row && len == 0) ? 0 : p.prob_lut[dmax + 128];
    p.row_sum[(long long)g * p.Sq + r0 + r] = S;
    atomicMax(&block_cmax, c);
  }
  __syncthreads();
  if (threadIdx.x == 0) atomicMax(p.cmax, block_cmax);
}

__global__ void __launch_bounds__(kThreads) contiguous_probv(CParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x, r0 = blockIdx.y * kRowTile;
  const int nr = min(kRowTile, p.Sq - r0);
  const int D = p.D, d4 = D / 4, ks = d4 + 1;
  const int len = p.kv_len[g];
  const float s1 = *p.logit_scale;
  const int qoff = p.causal ? *p.q_offset : 0;

  int* rq_s = reinterpret_cast<int*>(smem);              // 256
  int* lsh_s = rq_s + 256;                               // kRowTile
  int* q_s = lsh_s + kRowTile;                           // kRowTile * d4
  int* k_s = q_s + kRowTile * d4;                        // kSub * ks
  int* pc_s = k_s + kSub * ks;                           // kRowTile * kSub
  int8_t* v_s = reinterpret_cast<int8_t*>(pc_s + kRowTile * kSub);  // kSub*D

  const int cm = *p.cmax;
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    rq_s[i] = requant_code(p.prob_lut[i], cm);
  if (threadIdx.x < nr) {
    const float S = p.row_sum[(long long)g * p.Sq + r0 + threadIdx.x];
    lsh_s[threadIdx.x] = p.log_lut[pot_encode(S, p.pot)] * (1 << p.frac_shift);
  }
  load_words(q_s, d4, p.q + ((long long)g * p.Sq + r0) * D, nr, d4);

  constexpr int kMaxOut = kRowTile * 128 / kThreads;  // D <= 128
  int acc[kMaxOut];
#pragma unroll
  for (int t = 0; t < kMaxOut; ++t) acc[t] = 0;

  // keys past the fill level hold PROB code 0: only live keys are visited
  for (int t0 = 0; t0 < len; t0 += kSub) {
    const int nt = min(kSub, len - t0);
    const long long base = ((long long)g * p.Sk + t0) * D;
    __syncthreads();  // the previous tile's readers are done
    load_words(k_s, ks, p.k + base, nt, d4);
    {
      const int* src = reinterpret_cast<const int*>(p.v + base);
      int* dst = reinterpret_cast<int*>(v_s);
      for (int idx = threadIdx.x; idx < nt * d4; idx += blockDim.x)
        dst[idx] = src[idx];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nr * nt; idx += blockDim.x) {
      const int r = idx / nt, c = idx % nt, kpos = t0 + c;
      const int x = c_masked(p, g, r0 + r, kpos, qoff)
                        ? kLogitMin
                        : logit_code(q_s + r * d4, k_s + c * ks, d4, s1);
      const int d = min(max(x - lsh_s[r], kLogitMin), kLogitMax);
      pc_s[r * kSub + c] = rq_s[d + 128];
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kMaxOut; ++t) {
      const int idx = threadIdx.x + t * kThreads;
      if (idx < nr * D) {
        const int r = idx / D, d = idx % D;
        int a = acc[t];
        for (int c = 0; c < nt; ++c) a += pc_s[r * kSub + c] * (int)v_s[c * D + d];
        acc[t] = a;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kMaxOut; ++t) {
    const int idx = threadIdx.x + t * kThreads;
    if (idx < nr * D) {
      const int r = idx / D, d = idx % D;
      p.out[((long long)g * p.Sq + r0 + r) * D + d] = acc[t];
    }
  }
}

size_t smem_sums(int bk, int d4) {
  return sizeof(int) * (256 + kRowTile * d4 + kSub * (d4 + 1) + kRowTile * bk
                        + kRowTile * (bk / kRun + 1) + 2 * kRowTile);
}

size_t smem_probv(int d4) {
  return sizeof(int) * (256 + kRowTile + kRowTile * d4 + kSub * (d4 + 1)
                        + kRowTile * kSub) + (size_t)kSub * d4 * 4;
}

}  // namespace

// Launch one pass (0 = A, 1 = B) on `stream`; returns cudaGetLastError().
extern "C" int acam_attention_paged_launch(
    int pass, const void* q, const void* k, const void* v,
    const void* block_table, const void* kv_len, const void* mask,
    int mask_div, const void* logit_scale, const void* exp_val,
    const void* log_lut, const void* prob_lut, void* out, void* row_sum,
    void* cmax, int G, int Sq, int D, int page_size, int max_pages, int gps,
    float e_min, float step_scale, float safe_min, float thr, int frac_shift,
    void* stream) {
  if (D % 4 != 0 || D > 128 || G <= 0 || Sq <= 0 || page_size <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const int8_t*>(q);
  p.k = static_cast<const int8_t*>(k);
  p.v = static_cast<const int8_t*>(v);
  p.block_table = static_cast<const int*>(block_table);
  p.kv_len = static_cast<const int*>(kv_len);
  p.mask = static_cast<const int8_t*>(mask);
  p.mask_div = mask_div;
  p.logit_scale = static_cast<const float*>(logit_scale);
  p.exp_val = static_cast<const float*>(exp_val);
  p.log_lut = static_cast<const int*>(log_lut);
  p.prob_lut = static_cast<const int*>(prob_lut);
  p.out = static_cast<int*>(out);
  p.row_sum = static_cast<float*>(row_sum);
  p.cmax = static_cast<int*>(cmax);
  p.G = G; p.Sq = Sq; p.D = D; p.page_size = page_size;
  p.max_pages = max_pages; p.gps = gps;
  p.pot = PotConsts{e_min, step_scale, safe_min, thr};
  p.frac_shift = frac_shift;

  const dim3 grid(G, (Sq + kRowTile - 1) / kRowTile);
  const int d4 = D / 4;
  const size_t smem = pass == 0 ? smem_pass_a(page_size, d4)
                                : smem_pass_b(page_size, d4);
  const void* fn = pass == 0 ? (const void*)pass_a : (const void*)pass_b;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pass == 0) {
    pass_a<<<grid, kThreads, smem, s>>>(p);
  } else {
    pass_b<<<grid, kThreads, smem, s>>>(p);
  }
  return (int)cudaGetLastError();
}

// Launch one pass (0 = sums, 1 = PROB . V) of the contiguous layout on
// `stream`; returns cudaGetLastError().
extern "C" int acam_attention_contiguous_launch(
    int pass, const void* q, const void* k, const void* v, const void* kv_len,
    const void* mask, int mask_div, const void* logit_scale,
    const void* q_offset, const void* exp_val, const void* log_lut,
    const void* prob_lut, void* out, void* row_sum, void* cmax, int G, int Sq,
    int Sk, int D, int bk, int causal, int per_row, float e_min,
    float step_scale, float safe_min, float thr, int frac_shift,
    void* stream) {
  if (D % 4 != 0 || D > 128 || G <= 0 || Sq <= 0 || Sk <= 0 || bk <= 0 ||
      bk > 512)
    return (int)cudaErrorInvalidValue;
  CParams p;
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
  p.row_sum = static_cast<float*>(row_sum);
  p.cmax = static_cast<int*>(cmax);
  p.G = G; p.Sq = Sq; p.Sk = Sk; p.D = D; p.bk = bk;
  p.causal = causal; p.per_row = per_row;
  p.pot = PotConsts{e_min, step_scale, safe_min, thr};
  p.frac_shift = frac_shift;

  const dim3 grid(G, (Sq + kRowTile - 1) / kRowTile);
  const int d4 = D / 4;
  const size_t smem = pass == 0 ? smem_sums(bk, d4) : smem_probv(d4);
  const void* fn = pass == 0 ? (const void*)contiguous_sums
                             : (const void*)contiguous_probv;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pass == 0) {
    contiguous_sums<<<grid, kThreads, smem, s>>>(p);
  } else {
    contiguous_probv<<<grid, kThreads, smem, s>>>(p);
  }
  return (int)cudaGetLastError();
}
