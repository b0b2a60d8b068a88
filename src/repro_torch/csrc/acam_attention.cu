// Fused Fig.-12 RACE-IT attention over a block-paged int8 KV pool, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/acam_attention.py::_attn_kernel
// (its paged scalar-prefetch grid). What it computes, per group g (a query
// head of a slot, or a KV head with its rep sharing queries) and query row i:
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
// Bit-exactness with the reference (the plain PyTorch version in
// repro_torch/kernels/acam_attention.py repeats every step):
//   * rintf rounds half to even like jnp.round; the file is built with
//     -fmad=false and every f32 step is an explicit __f*_rn operation, so
//     nvcc fuses nothing the reference does not fuse;
//   * the row sum adds per-page block sums in page order; inside a block
//     XLA's CPU reduction adds runs of 32 keys one by one and then the runs
//     in order, and so does this kernel (pages of <= 32 keys or a multiple);
//   * the PoT encoder's log is XLA's float32 log (a Cephes polynomial with
//     fused multiply-adds), and log * f32(1/ln 2) - e_min is one more FMA,
//     as XLA contracts it, so codes at half-step boundaries agree;
//   * constant divisors are reciprocal multiplies, as XLA rewrites them:
//     max(cmax/256, 1e-12) * f32(1/127); the table entry itself divides.
//
// What bounds it on an H100: bytes. Per call it must read the int8 K pages
// twice (once per pass) and the V pages once, over the live pages only, plus
// the int8 queries and the int32 output; at 3.35 TB/s that is microseconds.
// This simple design stays far from it: one block per (group, 16-row tile)
// walks the pages one at a time with plain loads, computes the logits with
// __dp4a on CUDA cores, and the row sums serially per 32-key run. wgmma
// tiles, TMA page loads, several groups per block and a persistent grid are
// left for later work.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowTile = 16;
constexpr int kLogitMin = -128;
constexpr int kLogitMax = 127;
constexpr int kRun = 32;  // XLA's CPU reduction adds keys in runs of 32

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
  float e_min, step_scale, safe_min, thr;
  int frac_shift;
};

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

// PoT-encode a row sum exactly as repro.kernels.acam_attention._pot_encode_sum
__device__ __forceinline__ int pot_encode(float S, const Params& p) {
  const float kInvLn2 = 0x1.715476p+0f;  // f32(1 / f32(ln 2))
  const float safe = fmaxf(S, p.safe_min);
  // log(x) * (1/ln 2) - e_min, contracted into one FMA as XLA does
  float y = __fmaf_rn(ref_logf(safe), kInvLn2, -p.e_min);
  if (p.step_scale != 1.0f) y = __fmul_rn(y, p.step_scale);
  const float e = fminf(fmaxf(rintf(y), 0.0f), 254.0f);
  return S < p.thr ? 0 : __float2int_rn(e) + 1;
}

// the LOGIT code of (row r, key c) of this block: matmul-1 + div-add
__device__ __forceinline__ int logit_code(const int* q_row, const int* k_row,
                                          int d4, float s1) {
  int dot = 0;
  for (int w = 0; w < d4; ++w) dot = __dp4a(q_row[w], k_row[w], dot);
  const float logits = __fmul_rn(__int2float_rn(dot), s1);
  const float x = rintf(__fdiv_rn(logits, 0.125f));
  return __float2int_rn(fminf(fmaxf(x, (float)kLogitMin), (float)kLogitMax));
}

__device__ __forceinline__ void load_words(int* dst, int dst_stride,
                                           const int8_t* src, int rows, int d4) {
  const int* s = reinterpret_cast<const int*>(src);
  for (int idx = threadIdx.x; idx < rows * d4; idx += blockDim.x) {
    const int r = idx / d4, w = idx % d4;
    dst[r * dst_stride + w] = s[idx];
  }
}

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
    const int L = p.log_lut[pot_encode(S, p)];
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
  const float amax = __fmul_rn(__int2float_rn(*p.cmax), 0.00390625f);
  const float scale = __fmul_rn(fmaxf(amax, 1e-12f), 0x1.020408p-7f);
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const float pv = __fmul_rn(__int2float_rn(p.prob_lut[i]), 0.00390625f);
    const float c = rintf(__fdiv_rn(pv, scale));
    rq_s[i] = __float2int_rn(fminf(fmaxf(c, -128.0f), 127.0f));
  }
  if (threadIdx.x < nr) {
    const float S = p.row_sum[(long long)g * p.Sq + r0 + threadIdx.x];
    lsh_s[threadIdx.x] = p.log_lut[pot_encode(S, p)] * (1 << p.frac_shift);
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
  p.e_min = e_min; p.step_scale = step_scale; p.safe_min = safe_min;
  p.thr = thr; p.frac_shift = frac_shift;

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
