// Fused Fig.-12 RACE-IT attention over int8 codes, two passes, for sm_90a:
// over a block-paged KV pool (paged_sums / paged_probv) and over contiguous
// (G, Sk, D) k/v (contiguous_sums / contiguous_probv).
//
// Replaces the TPU kernel src/repro/kernels/acam_attention.py::_attn_kernel
// (its paged scalar-prefetch grid, its contiguous decode grid with scalar or
// per-group kv_len, and its causal / masked prefill grid). What it computes,
// per group g (a query head, or a KV head with its rep sharing queries) and
// query row i:
//
//   pass A  x = LOGIT code of round(f32(q.k) * s1 [* rsd] / 2^-3), masked keys
//           at the LOGIT minimum (rsd = f32(1 / sqrt(d)) where the reference
//           divides by sqrt(d) in the kernel, acam_common.cuh logit_of); S = sum over valid keys of exp_val[x] in the
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
// What bounds it on an H100: bytes at decode (the int8 K and V of the live
// keys, the queries and the int32 output: microseconds at 3.35 TB/s), the
// int8 operations in a long prefill.
//
// The paged kernels (paged_sums / paged_probv) are built for that card:
//   * the pages of a group are split over blocks (kernels/acam_attention.py
//     paged_plan), so groups x splits fill the 132 SMs several times over,
//     and each block copies its pages in key tiles with 16-byte cp.async
//     into a ring of 4, three tiles in flight while one is computed;
//   * q . K and PROB . V run on the int8 tensor cores (mma.sync m16n8k32):
//     K pages are D-contiguous, the K-major layout the product takes; V is
//     transposed with byte permutes as it is staged. A block takes up to 64
//     query rows; with fewer than 17 (decode, GQA decode) its four warps
//     share one 16-row tile and split the keys or the output columns;
//   * pass A writes each page's row sum (runs of 32 added key by key, the
//     run totals in order, as the reference adds a key block) and LOGIT
//     max, and keeps the LOGIT codes for pass B, so K is read once. The
//     block that finishes a row tile last (an arrival counter behind a
//     __threadfence) adds the page sums in page order from 0.0, which is
//     the reference's order whichever block finishes last, and folds the
//     rows' max PROB codes into cmax; a call stays at two launches;
//   * pass B adds its int32 PROB . V partials with atomicAdd (integer, so
//     order-free and exact) into rows that pass A's finishing block zeroed;
//   * the chunk mask is staged per key tile with coalesced copies.
// The contiguous kernels (contiguous_sums / contiguous_probv) follow the
// same design over (G, Sk, D) k/v: each group's keys split into spans on
// run boundaries of its key block (kernels/acam_attention.py
// contiguous_plan), each span's run totals added in run and block order by
// the unit's last block; see acam_contiguous.cuh.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include "acam_common.cuh"
#include "acam_contiguous.cuh"
#include "acam_mma.cuh"

namespace {

using namespace acam;

// ---------------------------------------------------------------------------
// contiguous layout: k/v (G, Sk, D), key blocks of bk keys
// (acam_contiguous.cuh)
// ---------------------------------------------------------------------------

// Pass A: LOGIT codes, run totals and span maxima of the block's rows and
// span; the unit's last block finishes the rows. kW warps: 4 for units of
// up to 16 rows (decode: more blocks resident, one wave), else 8.
template <int kW, bool kWide>
__global__ void __launch_bounds__(32 * kW) contiguous_sums(CParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const CSlice s = contiguous_slice(p);
  const CLayout L = c_layout(p, 0);
  contiguous_pass_a<false, kW, kWide>(p, s, smem, L);
  if (contiguous_arrive(p, s)) contiguous_finish<kW>(p, s, smem, L);
}

// Pass B: PROB . V of the block's rows and span.
template <int kW>
__global__ void __launch_bounds__(32 * kW) contiguous_probv(CParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const CSlice s = contiguous_slice(p);
  contiguous_pass_b<false, kW>(p, s, smem, c_layout(p, 1));
}

// ---------------------------------------------------------------------------
// block-paged layout: pages split over blocks, int8 tensor cores
// ---------------------------------------------------------------------------

constexpr int kPRows = 64;     // query rows per block: 4 warps x 16
constexpr int kPThreads = 128;
constexpr int kRing = 4;       // key tiles in flight per block (cp.async)

struct PParams {
  const int8_t* q;            // (G, Sq, D)
  const int8_t* k;            // (n_pages * gps, page_size, D)
  const int8_t* v;            // (n_pages * gps, page_size, D)
  const int* block_table;     // (n_slots, max_pages)
  const int* kv_len;          // (G,) valid keys, <= max_pages * page_size
  const int8_t* mask;         // (G / mask_div, Sq, Sk) or null; 0 = masked key
  int mask_div;
  const float* logit_scale;   // () s_q * s_k
  float rsd;                  // f32(1 / sqrt(d)), or 0: folded into s1
  const float* exp_val;       // [256] f32
  const int* log_lut;         // [256]
  const int* prob_lut;        // [256]
  int* out;                   // (G, Sq, D) int32
  float* page_sum;            // (G * Sq, max_pages): pass A's page sums
  int* page_max;              // (G * Sq, max_pages): and page LOGIT maxima
  int8_t* codes;              // (G * Sq, max_pages, psp): the LOGIT codes
  int* lsh;                   // (G * Sq): LOG(S) << frac_shift, for pass B
  int* cells;                 // [0] cmax seeded with cmax_floor, [1 + unit]
                              // arrival counters, zeroed
  int G, Sq, D, dp, page_size, max_pages, gps;
  int row_tiles, rows, splits, pages_per_split, kt, psp;
  PotConsts pot;
  int frac_shift;
};

// the rows, keys and pages one block of either pass takes
struct PSlice {
  int unit, g, r0, nr, len, npages, j0, j1, slot, sub;
};

__device__ __forceinline__ PSlice paged_slice(const PParams& p) {
  PSlice s;
  s.unit = blockIdx.x;
  s.g = s.unit / p.row_tiles;
  s.r0 = (s.unit % p.row_tiles) * kPRows;
  s.nr = min(kPRows, p.Sq - s.r0);
  s.len = p.kv_len[s.g];
  s.npages = (s.len + p.page_size - 1) / p.page_size;
  s.j0 = blockIdx.y * p.pages_per_split;
  s.j1 = min(s.j0 + p.pages_per_split, s.npages);
  s.slot = s.g / p.gps;
  s.sub = s.g % p.gps;
  return s;
}

// whether the mask is staged per key tile with 4-byte copies (page size,
// key tile and mask row all multiples of 4), else read where it is used
__host__ __device__ __forceinline__ bool mask_tiles(const PParams& p) {
  return p.mask != nullptr &&
         ((p.page_size | p.kt | p.max_pages * p.page_size) & 3) == 0;
}

// the physical pages of the block's logical pages j0..j1-1, read once
// (ahead of the copies that need them)
__device__ __forceinline__ void load_pages(int* pg_s, const PParams& p,
                                           const PSlice& s) {
  for (int i = threadIdx.x; i < s.j1 - s.j0; i += blockDim.x)
    pg_s[i] = p.block_table[(long long)s.slot * p.max_pages + s.j0 + i];
  __syncthreads();
}

// Pass A: the LOGIT codes of the block's pages (q . K on the int8 tensor
// cores), each page's row sums in the reference's order and its LOGIT max;
// the block that finishes a row tile last adds the page sums in page order
// and folds the rows' max PROB codes into cmax. kWide (D > 128) adds the
// q . K steps past 128 dims, q read from shared memory.
template <bool kWide>
__global__ void __launch_bounds__(kPThreads) paged_sums(PParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const PSlice s = paged_slice(p);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int ps = p.page_size, kt = p.kt, spp = ps / kt, D = p.D;
  const int qs_b = p.dp + 16;            // staged q / K row bytes
  const int ktp = (kt + 7) & ~7;         // keys of a tile, in n8 tiles
  const int ktm = (kt + 15) & ~15;       // mask row bytes
  // row strides of the exp values (one float of skew per run of 32 and
  // one per row) and of the codes (4 bytes of skew): the threads adding
  // runs of neighbouring rows hit different banks
  const int es = kt + kt / kRun + 1, xs_b = ktm + 4;
  const int rl = min(kt, kRun), nrs = kt / rl, npr = ps / rl;
  const long long sk = (long long)p.max_pages * ps;
  const long long mrow0 = ((long long)(s.g / p.mask_div) * p.Sq + s.r0) * sk;
  const bool mvec = mask_tiles(p);
  const float s1 = *p.logit_scale;

  const int R = p.rows;                  // rows staged: Sq up to 64, in 16s
  unsigned char* q_s = smem;                              // R * qs_b
  unsigned char* k_s = q_s + R * qs_b;                    // kRing*ktp*qs_b
  unsigned char* m_s = k_s + kRing * ktp * qs_b;          // kRing * R * ktm
  int8_t* x_s =
      reinterpret_cast<int8_t*>(m_s + (mvec ? kRing * R * ktm : 0));
  float* exp_s = reinterpret_cast<float*>(x_s + R * xs_b);  // 256
  float* e_s = exp_s + 256;                               // R * es
  float* rt_s = e_s + R * es;                             // R * nrs
  int* rm_s = reinterpret_cast<int*>(rt_s + R * nrs);     // R * nrs
  int* pg_s = rm_s + R * nrs;                 // pages_per_split page ids
  __shared__ int last_s, cmax_s;

  const int nsub = max(0, s.j1 - s.j0) * spp;
  load_pages(pg_s, p, s);
  auto issue = [&](int st) {
    const int j = s.j0 + st / spp, sb = st % spp;
    const long long page = pg_s[st / spp];
    stage_rows(k_s + (st % kRing) * ktp * qs_b, qs_b,
               p.k + ((page * p.gps + s.sub) * ps + sb * kt) * D, D, kt, D);
    if (mvec)
      stage_rows(m_s + (st % kRing) * R * ktm, ktm,
                 p.mask + mrow0 + j * ps + sb * kt, sk, s.nr, kt);
  };
  if (nsub > 0)
    stage_rows(q_s, qs_b, p.q + ((long long)s.g * p.Sq + s.r0) * D, D,
               s.nr, D);
  for (int st = 0; st < kRing - 1; ++st) {  // q joins the first group
    if (st < nsub) issue(st);
    cp_async_commit();
  }
  if (nsub > 0) {  // while the copies fly
    for (int i = tid; i < R * (p.dp - D); i += kPThreads)
      q_s[(i / (p.dp - D)) * qs_b + D + i % (p.dp - D)] = 0;  // zero pad
    for (int i = tid; i < 256; i += kPThreads) exp_s[i] = p.exp_val[i];
  }

  const int wpr = warps_per_row_tile<4>(s.nr);
  const int rt = warp / wpr, kq = warp % wpr;
  const bool mma_warp = rt * 16 < s.nr;
  const int nk = p.dp / 32;
  unsigned qa[4][4];
  // the running state of row `tid`: its page sum, the level-2 group of
  // run totals (pages of more than 32 runs), and the page's LOGIT max
  float pg = 0.0f, gacc = 0.0f;
  int gi = 0, ga = 0, gb = 0, pmax = kLogitMin, ri = 0;

  for (int st = 0; st < nsub; ++st) {
    // tile st + kRing - 1 goes where tile st - 1 was read, before the
    // barrier that ended its reads
    if (st + kRing - 1 < nsub) issue(st + kRing - 1);
    cp_async_commit();
    cp_async_wait<kRing - 1>();
    __syncthreads();
    const int j = s.j0 + st / spp, sb = st % spp;
    const int key0 = j * ps + sb * kt;
    const unsigned char* kb = k_s + (st % kRing) * ktp * qs_b;
    const unsigned char* mb = m_s + (st % kRing) * R * ktm;
    if (mma_warp) {
      if (st == 0) {
        const unsigned char* qr = q_s + (rt * 16 + gq) * qs_b + 4 * tq;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk >= nk) break;
          const unsigned char* q0 = qr + kk * 32;
          qa[kk][0] = *reinterpret_cast<const unsigned*>(q0);
          qa[kk][1] = *reinterpret_cast<const unsigned*>(q0 + 8 * qs_b);
          qa[kk][2] = *reinterpret_cast<const unsigned*>(q0 + 16);
          qa[kk][3] = *reinterpret_cast<const unsigned*>(q0 + 8 * qs_b + 16);
        }
      }
      for (int nt = kq; nt < ktp / 8; nt += wpr) {
        int acc[4] = {0, 0, 0, 0};
        const unsigned char* kr = kb + (nt * 8 + gq) * qs_b + 4 * tq;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk >= nk) break;
          const unsigned b[2] = {
              *reinterpret_cast<const unsigned*>(kr + kk * 32),
              *reinterpret_cast<const unsigned*>(kr + kk * 32 + 16)};
          mma_s8(acc, qa[kk], b);
        }
        if constexpr (kWide) {  // head dims past 128
          const unsigned char* qr = q_s + (rt * 16 + gq) * qs_b + 4 * tq;
          for (int kk = 4; kk < nk; ++kk)
            mma_s8_smem(acc, qr + kk * 32, qs_b, kr + kk * 32);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rt * 16 + gq + (e >= 2 ? 8 : 0);
          const int c = nt * 8 + 2 * tq + (e & 1);
          if (r >= s.nr || c >= kt) continue;
          int x = logit_of(acc[e], s1, p.rsd);
          bool masked = false;
          if (mvec) masked = mb[r * ktm + c] == 0;
          else if (p.mask != nullptr)
            masked = p.mask[mrow0 + r * sk + key0 + c] == 0;
          if (masked) x = kLogitMin;
          const bool valid = key0 + c < s.len;
          e_s[r * es + c + c / kRun] = valid ? exp_s[x + 128] : 0.0f;
          x_s[r * xs_b + c] = (int8_t)(valid ? x : kLogitMin);
        }
      }
    }
    __syncthreads();
    // runs of rl keys, added key by key (the reference's order)
    for (int idx = tid; idx < s.nr * nrs; idx += kPThreads) {
      const int r = idx / nrs, a = (idx % nrs) * rl;
      const float* er = e_s + r * es + a + a / kRun;
      const int8_t* xr = x_s + r * xs_b + a;
      float sum = er[0];
      int m = xr[0];
      if (rl == kRun) {  // a full run: every load issued before the adds
        float ev[kRun];
#pragma unroll
        for (int c = 0; c < kRun; ++c) ev[c] = er[c];
#pragma unroll
        for (int c = 1; c < kRun; ++c) {
          sum = __fadd_rn(sum, ev[c]);
          m = max(m, (int)xr[c]);
        }
      } else {
        for (int c = 1; c < rl; ++c) {
          sum = __fadd_rn(sum, er[c]);
          m = max(m, (int)xr[c]);
        }
      }
      rt_s[idx] = sum;
      rm_s[idx] = m;
    }
    {  // the tile's codes, for pass B
      const long long cs = (long long)p.max_pages * p.psp;
      int8_t* cd = p.codes + ((long long)(s.g * p.Sq + s.r0) * p.max_pages
                              + j) * p.psp + sb * kt;
      if ((kt & 3) == 0) {
        const int n = kt / 4;
        for (int i = tid; i < s.nr * n; i += kPThreads)
          *reinterpret_cast<int*>(cd + (i / n) * cs + 4 * (i % n)) =
              *reinterpret_cast<const int*>(x_s + (i / n) * xs_b + 4 * (i % n));
      } else {
        for (int i = tid; i < s.nr * kt; i += kPThreads)
          cd[(i / kt) * cs + i % kt] = x_s[(i / kt) * xs_b + i % kt];
      }
    }
    __syncthreads();
    if (tid < s.nr) {  // run totals into the page sum, in run order
      if (sb == 0) {
        ri = 0;
        gi = 0;
        chunk_bounds(npr, 0, ga, gb);
        pmax = kLogitMin;
      }
      for (int run = 0; run < nrs; ++run, ++ri) {
        const float tot = rt_s[tid * nrs + run];
        pmax = max(pmax, rm_s[tid * nrs + run]);
        gacc = ri == ga ? tot : __fadd_rn(gacc, tot);
        if (ri == gb - 1) {
          pg = gi == 0 ? gacc : __fadd_rn(pg, gacc);
          if (++gi < n_chunks(npr)) chunk_bounds(npr, gi, ga, gb);
        }
      }
      if (sb == spp - 1) {
        const long long at =
            (long long)(s.g * p.Sq + s.r0 + tid) * p.max_pages + j;
        p.page_sum[at] = pg;
        p.page_max[at] = pmax;
      }
    }
  }

  // the last block of this row tile to arrive finishes its rows
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last_s = atomicAdd(&p.cells[1 + s.unit], 1) == p.splits - 1;
    cmax_s = INT_MIN;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  if (tid < s.nr) {
    const long long row = (long long)s.g * p.Sq + s.r0 + tid;
    float S = 0.0f;
    int xm = kLogitMin;
    for (int j0 = 0; j0 < s.npages; j0 += 8) {  // 8 loads in flight
      float ps8[8];
      int pm8[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const bool in = j0 + u < s.npages;
        ps8[u] = in ? __ldcg(p.page_sum + row * p.max_pages + j0 + u) : 0.0f;
        pm8[u] = in ? __ldcg(p.page_max + row * p.max_pages + j0 + u)
                    : kLogitMin;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (j0 + u < s.npages) S = __fadd_rn(S, ps8[u]);
        xm = max(xm, pm8[u]);
      }
    }
    const int L = p.log_lut[pot_encode(S, p.pot)] * (1 << p.frac_shift);
    const int dmax = min(max(xm - L, kLogitMin), kLogitMax);
    // a zero-length group has no keys: all-zero rows, no cmax contribution
    const int c = s.len > 0 ? p.prob_lut[dmax + 128] : 0;
    p.lsh[row] = L;
    atomicMax(&cmax_s, c);
  }
  if (p.splits > 1) {  // pass B adds its partials into zeroed rows
    int* o = p.out + ((long long)s.g * p.Sq + s.r0) * D;
    for (int i = tid; i < s.nr * D; i += kPThreads) o[i] = 0;
  }
  __syncthreads();
  if (tid == 0) atomicMax(p.cells, cmax_s);
}

// Pass B: the PROB codes of the block's keys through the requant table of
// the call-wide cmax, times V on the int8 tensor cores (V transposed as it
// is staged); int32 partials added order-free into out.
__global__ void __launch_bounds__(kPThreads) paged_probv(PParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const PSlice s = paged_slice(p);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int ps = p.page_size, kt = p.kt, spp = ps / kt, D = p.D, dp = p.dp;
  const int ktq = (kt + 31) & ~31;       // keys of a tile, in k32 steps
  const int pc_b = ktq + 16;             // PROB / V^T row bytes
  const int nsub = max(0, s.j1 - s.j0) * spp;
  const bool atomic = p.splits > 1;
  if (nsub == 0 && atomic) return;       // adds nothing to a zeroed out

  const int R = p.rows;                  // rows staged: Sq up to 64, in 16s
  unsigned char* c_s = smem;                           // kRing * R * ktq
  unsigned char* v_s = c_s + kRing * R * ktq;          // kRing * ktq * dp
  unsigned char* pc_s = v_s + kRing * ktq * dp;        // R * pc_b
  unsigned char* vt_s = pc_s + R * pc_b;               // dp * pc_b
  int* rq_s = reinterpret_cast<int*>(vt_s + dp * pc_b);  // 256
  int* lsh_s = rq_s + 256;                             // R
  int* pg_s = lsh_s + R;                     // pages_per_split page ids

  load_pages(pg_s, p, s);
  auto issue = [&](int st) {
    const int j = s.j0 + st / spp, sb = st % spp;
    const long long page = pg_s[st / spp];
    stage_rows(c_s + (st % kRing) * R * ktq, ktq,
               p.codes + ((long long)(s.g * p.Sq + s.r0) * p.max_pages + j)
                             * p.psp + sb * kt,
               (long long)p.max_pages * p.psp, s.nr, kt);
    stage_rows(v_s + (st % kRing) * ktq * dp, dp,
               p.v + ((page * p.gps + s.sub) * ps + sb * kt) * D, D, kt, D);
  };
  const int wpr = warps_per_row_tile<4>(s.nr);
  const int rt = warp / wpr, dq = warp % wpr;
  const bool mma_warp = rt * 16 < s.nr;
  const int ndt = (D + 7) / 8;
  // one sweep over the pages for every 16 x wpr output tiles of 8 columns:
  // one sweep up to D 128, two at D 256 and three at D 320 when a warp
  // has a row tile alone
  for (int d0 = 0; d0 < ndt; d0 += 16 * wpr) {
    if (d0 > 0) {  // the last sweep's copies and reads are done
      cp_async_wait<0>();
      __syncthreads();
    }
    for (int st = 0; st < kRing - 1; ++st) {
      if (st < nsub) issue(st);
      cp_async_commit();
    }
    if (d0 == 0) {
      // requant table from the global cmax (quantize_tensor of the PROB
      // values)
      const int cm = p.cells[0];
      for (int i = tid; i < 256; i += kPThreads)
        rq_s[i] = requant_code(p.prob_lut[i], cm);
      if (tid < s.nr) lsh_s[tid] = p.lsh[(long long)s.g * p.Sq + s.r0 + tid];
    }
    int acc[16][4];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;

    for (int st = 0; st < nsub; ++st) {
      if (st + kRing - 1 < nsub) issue(st + kRing - 1);
      cp_async_commit();
      cp_async_wait<kRing - 1>();
      __syncthreads();
      const int j = s.j0 + st / spp, sb = st % spp;
      const int key0 = j * ps + sb * kt;
      const unsigned char* cb = c_s + (st % kRing) * R * ktq;
      for (int i = tid; i < R * (ktq / 4); i += kPThreads) {
        const int r = i / (ktq / 4), c0 = 4 * (i % (ktq / 4));
        unsigned word = 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = c0 + b;
          if (r < s.nr && c < kt && key0 + c < s.len) {
            const int x = (int)(int8_t)cb[r * ktq + c];
            const int d = min(max(x - lsh_s[r], kLogitMin), kLogitMax);
            word |= ((unsigned)rq_s[d + 128] & 0xffu) << (8 * b);
          }
        }
        *reinterpret_cast<unsigned*>(pc_s + r * pc_b + c0) = word;
      }
      transpose_tile(vt_s, pc_b, v_s + (st % kRing) * ktq * dp, dp, ktq, dp,
                     tid, kPThreads);
      __syncthreads();
      if (mma_warp) {
        const unsigned char* ar = pc_s + (rt * 16 + gq) * pc_b + 4 * tq;
        for (int kk = 0; kk < ktq / 32; ++kk) {
          const unsigned a[4] = {
              *reinterpret_cast<const unsigned*>(ar + kk * 32),
              *reinterpret_cast<const unsigned*>(ar + 8 * pc_b + kk * 32),
              *reinterpret_cast<const unsigned*>(ar + kk * 32 + 16),
              *reinterpret_cast<const unsigned*>(ar + 8 * pc_b + kk * 32 + 16)};
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int nd = d0 + dq + i * wpr;
            if (nd >= ndt) break;
            const unsigned char* br = vt_s + (nd * 8 + gq) * pc_b + 4 * tq;
            const unsigned b[2] = {
                *reinterpret_cast<const unsigned*>(br + kk * 32),
                *reinterpret_cast<const unsigned*>(br + kk * 32 + 16)};
            mma_s8(acc[i], a, b);
          }
        }
      }
    }
    if (!mma_warp) continue;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int nd = d0 + dq + i * wpr;
      if (nd >= ndt) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rt * 16 + gq + (e >= 2 ? 8 : 0);
        const int d = nd * 8 + 2 * tq + (e & 1);
        if (r >= s.nr || d >= D) continue;
        int* o = p.out + ((long long)s.g * p.Sq + s.r0 + r) * D + d;
        if (atomic) atomicAdd(o, acc[i][e]);
        else *o = acc[i][e];
      }
    }
  }
}

size_t smem_paged_sums(const PParams& p) {
  const int qs_b = p.dp + 16, ktp = (p.kt + 7) & ~7, ktm = (p.kt + 15) & ~15;
  const int nrs = p.kt / (p.kt < kRun ? p.kt : kRun);
  const bool mvec = mask_tiles(p);
  const int es = p.kt + p.kt / kRun + 1;
  return (size_t)p.rows * qs_b + kRing * ktp * qs_b
         + (mvec ? kRing * p.rows * ktm : 0) + p.rows * (ktm + 4)
         + sizeof(float) * (256 + p.rows * es + 2 * p.rows * nrs)
         + sizeof(int) * p.pages_per_split;
}

size_t smem_paged_probv(const PParams& p) {
  const int ktq = (p.kt + 31) & ~31;
  return (size_t)kRing * p.rows * ktq + kRing * ktq * p.dp
         + p.rows * (ktq + 16) + p.dp * (ktq + 16)
         + sizeof(int) * (256 + p.rows + p.pages_per_split);
}

// the shape fields of a paged launch (the layouts above read these)
void paged_shape(PParams& p, int G, int Sq, int D, int page_size,
                 int max_pages, int splits, int pages_per_split, int kt) {
  p.G = G; p.Sq = Sq; p.D = D; p.dp = (D + 31) & ~31;
  p.page_size = page_size; p.max_pages = max_pages;
  p.row_tiles = (Sq + kPRows - 1) / kPRows;
  p.rows = min(kPRows, (Sq + 15) / 16 * 16);
  p.splits = splits; p.pages_per_split = pages_per_split; p.kt = kt;
}

}  // namespace

// The dynamic shared memory (bytes) one pass of the paged layout takes at
// these shapes, from the layout the launch uses; `masked` says whether a mask
// is given.
extern "C" int acam_attention_paged_smem(int pass, int G, int Sq, int D,
                                         int page_size, int max_pages,
                                         int masked, int splits,
                                         int pages_per_split, int kt) {
  PParams p = {};
  int cell = 0;
  p.mask = masked ? reinterpret_cast<const int8_t*>(&cell) : nullptr;
  paged_shape(p, G, Sq, D, page_size, max_pages, splits, pages_per_split, kt);
  return (int)(pass == 0 ? smem_paged_sums(p) : smem_paged_probv(p));
}

// Launch one pass of the paged layout (0 = A, 1 = B) on `stream`; returns
// the CUDA error code. The split and the scratch come from
// kernels/acam_attention.py paged_plan: blocks (G * ceil(Sq / 64), splits),
// each taking pages_per_split pages in key tiles of kt keys.
extern "C" int acam_attention_paged_launch(
    int pass, const void* q, const void* k, const void* v,
    const void* block_table, const void* kv_len, const void* mask,
    int mask_div, const void* logit_scale, float rsd, const void* exp_val,
    const void* log_lut, const void* prob_lut, void* out, void* page_sum,
    void* page_max, void* codes, void* lsh, void* cells, int G, int Sq, int D,
    int page_size, int max_pages, int gps, int splits, int pages_per_split,
    int kt, int psp, float e_min, float step_scale, float safe_min, float thr,
    int frac_shift, void* stream) {
  if (D % 4 != 0 || D <= 0 || D > kMaxD || G <= 0 || Sq <= 0 ||
      page_size <= 0 || page_size > 32768 || max_pages <= 0 || kt <= 0 ||
      kt > 64 || page_size % kt != 0 || (kt > kRun && kt % kRun != 0) ||
      psp < page_size || psp % 16 != 0 || splits <= 0 ||
      pages_per_split <= 0 || splits * pages_per_split < max_pages)
    return (int)cudaErrorInvalidValue;
  PParams p;
  p.q = static_cast<const int8_t*>(q);
  p.k = static_cast<const int8_t*>(k);
  p.v = static_cast<const int8_t*>(v);
  p.block_table = static_cast<const int*>(block_table);
  p.kv_len = static_cast<const int*>(kv_len);
  p.mask = static_cast<const int8_t*>(mask);
  p.mask_div = mask_div;
  p.logit_scale = static_cast<const float*>(logit_scale);
  p.rsd = rsd;
  p.exp_val = static_cast<const float*>(exp_val);
  p.log_lut = static_cast<const int*>(log_lut);
  p.prob_lut = static_cast<const int*>(prob_lut);
  p.out = static_cast<int*>(out);
  p.page_sum = static_cast<float*>(page_sum);
  p.page_max = static_cast<int*>(page_max);
  p.codes = static_cast<int8_t*>(codes);
  p.lsh = static_cast<int*>(lsh);
  p.cells = static_cast<int*>(cells);
  paged_shape(p, G, Sq, D, page_size, max_pages, splits, pages_per_split, kt);
  p.gps = gps;
  p.psp = psp;
  p.pot = PotConsts{e_min, step_scale, safe_min, thr};
  p.frac_shift = frac_shift;

  const dim3 grid(G * p.row_tiles, splits);
  const size_t smem = pass == 0 ? smem_paged_sums(p) : smem_paged_probv(p);
  const bool wide_d = D > 128;
  const void* fn = pass != 0 ? (const void*)paged_probv
                   : wide_d  ? (const void*)paged_sums<true>
                             : (const void*)paged_sums<false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pass == 0 && wide_d) {
    paged_sums<true><<<grid, kPThreads, smem, st>>>(p);
  } else if (pass == 0) {
    paged_sums<false><<<grid, kPThreads, smem, st>>>(p);
  } else {
    paged_probv<<<grid, kPThreads, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

// The dynamic shared memory (bytes) one pass of the contiguous layout takes
// at these shapes (acam_contiguous.cuh c_layout), or -1 for a shape the
// kernels do not take; `masked` says whether a mask is given.
extern "C" int acam_attention_contiguous_smem(int pass, int G, int Sq,
                                              int Sk, int D, int bk,
                                              int masked, int splits,
                                              int per, int psp) {
  CParams p;
  int cell = 0;
  void* c = &cell;
  if (!contiguous_params(p, c, c, c, c, masked ? c : nullptr, 1, c, 0.0f,
                         nullptr, 0, c, c, c, c, c, c, c, c, c, G, Sq, Sk, D,
                         bk, 0, 0, splits, per, psp, 0.0f, 1.0f, 0.0f, 0.0f,
                         0))
    return -1;
  return c_layout(p, pass == 0 ? 0 : 1).total;
}

// Launch one pass (0 = A, 1 = B) of the contiguous layout on `stream`;
// returns the CUDA error code. The split and the scratch come from
// kernels/acam_attention.py contiguous_plan: blocks (G * ceil(Sq / 64),
// splits), each taking `per` runs of the one key block or `per` key blocks.
extern "C" int acam_attention_contiguous_launch(
    int pass, const void* q, const void* k, const void* v, const void* kv_len,
    const void* mask, int mask_div, const void* logit_scale, float rsd,
    const void* q_offset, int q_off, const void* exp_val,
    const void* log_lut, const void* prob_lut, void* out, void* run_tot,
    void* span_max,
    void* codes, void* lsh, void* cells, int G, int Sq, int Sk, int D, int bk,
    int causal, int per_row, int splits, int per, int psp, float e_min,
    float step_scale, float safe_min, float thr, int frac_shift,
    void* stream) {
  CParams p;
  if (codes == nullptr ||
      !contiguous_params(p, q, k, v, kv_len, mask, mask_div, logit_scale,
                         rsd, q_offset, q_off, exp_val, log_lut, prob_lut,
                         out, run_tot, span_max, codes, lsh, cells, G, Sq, Sk, D,
                         bk, causal, per_row, splits, per, psp, e_min,
                         step_scale, safe_min, thr, frac_shift))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.units, splits);
  const size_t smem = c_layout(p, pass == 0 ? 0 : 1).total;
  const bool wide = Sq > 16;  // 8 warps a block, else 4
  const bool wide_d = D > 128;
  const void* fn =
      pass == 0 ? (wide ? (wide_d ? (const void*)contiguous_sums<8, true>
                                  : (const void*)contiguous_sums<8, false>)
                        : (wide_d ? (const void*)contiguous_sums<4, true>
                                  : (const void*)contiguous_sums<4, false>))
                : (wide ? (const void*)contiguous_probv<8>
                        : (const void*)contiguous_probv<4>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = wide ? 256 : 128;
  if (pass == 0 && wide && wide_d) {
    contiguous_sums<8, true><<<grid, threads, smem, st>>>(p);
  } else if (pass == 0 && wide) {
    contiguous_sums<8, false><<<grid, threads, smem, st>>>(p);
  } else if (pass == 0 && wide_d) {
    contiguous_sums<4, true><<<grid, threads, smem, st>>>(p);
  } else if (pass == 0) {
    contiguous_sums<4, false><<<grid, threads, smem, st>>>(p);
  } else if (wide) {
    contiguous_probv<8><<<grid, threads, smem, st>>>(p);
  } else {
    contiguous_probv<4><<<grid, threads, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}
