// The blocks of the contiguous Fig.-12 attention kernels for sm_90a, shared
// by the two-pass kernels (acam_attention.cu contiguous_sums /
// contiguous_probv) and the one-launch one-tile kernel
// (acam_attention_single.cu single_tile). k/v are (G, Sk, D) int8, split
// into key blocks of bk keys as the reference splits them.
//
// A block of kW warps takes one unit (a group and up to 64 of its query
// rows: four 16-row tiles of mma.sync, their warps splitting the keys or
// the output columns) and one span of that group's keys
// (kernels/acam_attention.py contiguous_plan): `per` consecutive runs of
// the one key block (`sum_chunks(bk)`, acam_common.cuh chunk_bounds), or
// `per` whole key blocks when the group has several. So a span starts and ends on a run boundary of its key block,
// and every run is summed whole by one block.
//
//   pass A  K staged in tiles of 64 keys with 16-byte cp.async into a ring
//           of 4; q . K on the int8 tensor cores (mma.sync m16n8k32, K rows
//           are D-contiguous, the K-major operand); the LOGIT codes of a
//           segment (the span's part of one key block) kept in shared
//           memory. At each segment's end every run of its rows is added
//           key by key into a run total in device memory (and, two-pass,
//           the codes are written for pass B, so K is read once). The rows'
//           LOGIT max is kept in registers per warp and reduced once.
//   finish  the block of a unit that arrives last (an arrival counter
//           behind a __threadfence) adds each key block's run totals in
//           run order and the block sums in block order from 0.0 (the
//           reference's order, whichever block finishes last), takes
//           LOG(S), folds the rows' max PROB codes into cmax with an integer
//           atomicMax and zeroes the rows that pass B adds into.
//   pass B  the kept codes through the requant table of the call-wide cmax,
//           PROB . V on the int8 tensor cores (V transposed by byte permutes
//           as it is staged), int32 partials added with atomicAdd (exact
//           and order-free) when a unit's keys are split.
//
// What the reference's semantics ask of the order (the plain versions in
// kernels/acam_attention.py):
//   * a masked key is not an absent key: at the LOGIT minimum its exp value
//     (1.1920929e-07 in pot and pot_fine) is added in its place in the run
//     and it counts toward the row max. A causal tile past every row's
//     diagonal is masked whole, so its codes are known and only its q . K
//     product is skipped;
//   * keys past kv_len add nothing: a run is summed up to the fill level, a
//     span wholly past it is skipped, and the finisher stops at the fill
//     level (what it leaves out are exact +0.0 run totals);
//   * the mask (one row per G / mask_div groups) is staged per key tile
//     with coalesced copies; the causal mask with q_offset is computed.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "acam_common.cuh"
#include "acam_mma.cuh"

namespace acam {

constexpr int kCRows = 64;     // query rows per block: 4 tiles of 16
constexpr int kCMaxWarps = 8;  // warps per block (kW): 4 or 8
constexpr int kCRing = 4;      // key tiles in flight per block (cp.async)
constexpr int kCTile = 64;     // keys per staged tile; divides bk past 512

struct CParams {
  const int8_t* q;            // (G, Sq, D)
  const int8_t* k;            // (G, Sk, D)
  const int8_t* v;            // (G, Sk, D)
  const int* kv_len;          // (G,) valid keys per group, <= Sk
  const int8_t* mask;         // (G / mask_div, Sq, Sk) or null; 0 = masked
  int mask_div;
  const float* logit_scale;   // () s_q * s_k
  float rsd;                  // f32(1 / sqrt(d)), or 0: folded into s1
  const int* q_offset;        // () causal offset of row 0, or null: q_off
  int q_off;
  const float* exp_val;       // [256] f32
  const int* log_lut;         // [256]
  const int* prob_lut;        // [256]
  int* out;                   // (G, Sq, D) int32
  float* run_tot;             // (G * Sq, nb * nch): every run's total
  int* span_max;              // (G * Sq, splits): every span's LOGIT max
  int8_t* codes;              // (G * Sq, psp) LOGIT codes for pass B; null
                              // in the one-tile kernel (shared memory)
  int* lsh;                   // (G * Sq): LOG(S) << frac_shift
  int* cells;                 // [0] cmax seeded with cmax_floor, [1 + unit]
                              // arrival counters, [1 + units] the one-tile
                              // kernel's grid barrier; zeroed
  int G, Sq, Sk, D, dp, bk, nb, nch, causal, per_row;
  int row_tiles, rows, units, splits, per, psp, xs_b;
  PotConsts pot;
  int frac_shift;
};

// the rows and keys one block of either pass takes
struct CSlice {
  int unit, g, r0, nr, len, qoff, span, ka, ke, c0, c1, ntile;
};

// first key of span s: run s * per of the one key block, or block s * per
__host__ __device__ __forceinline__ int span_start(const CParams& p, int s) {
  if (p.nb > 1) return s * p.per * p.bk;
  int a, b;
  chunk_bounds(p.bk, s * p.per, a, b);
  return a;
}

__device__ __forceinline__ CSlice contiguous_slice(const CParams& p) {
  CSlice s;
  s.unit = blockIdx.x;
  s.g = s.unit / p.row_tiles;
  s.r0 = (s.unit % p.row_tiles) * kCRows;
  s.nr = min(kCRows, p.Sq - s.r0);
  s.len = p.kv_len[s.g];
  s.qoff = !p.causal ? 0
           : (p.q_offset != nullptr ? *p.q_offset : p.q_off);
  s.span = blockIdx.y;
  const int n = p.nb > 1 ? p.nb : p.nch;  // runs, or key blocks
  const int u0 = s.span * p.per, u1 = min(u0 + p.per, n);
  s.c0 = p.nb > 1 ? 0 : u0;
  s.c1 = p.nb > 1 ? p.nch : u1;
  s.ka = span_start(p, s.span);
  s.ke = min(u1 == n ? p.Sk : span_start(p, s.span + 1), s.len);
  s.ntile = s.ka < s.ke ? (s.ke - s.ka + kCTile - 1) / kCTile : 0;
  return s;
}

// byte offsets of the shared-memory arrays: kind 0 pass A, 1 pass B, 2 the
// one-tile kernel (pass A's arrays, then pass B's; V reuses the K ring)
struct CLayout {
  int q, k, m, x, exp, lut, rm, c, v, pc, vt, rq, lsh, total;
};

__host__ __device__ inline CLayout c_layout(const CParams& p, int kind) {
  CLayout L = {};
  const int R = p.rows, qs_b = p.dp + 16, pc_b = kCTile + 16;
  int at = 0;
  if (kind != 1) {
    L.q = at;   at += R * qs_b;
    L.k = at;   at += kCRing * kCTile * qs_b;
    L.m = at;   at += p.mask != nullptr ? kCRing * R * kCTile : 0;
    L.x = at;   at += R * p.xs_b;
    L.exp = at; at += 4 * 256;
    L.lut = at; at += 4 * 512;   // log_lut, prob_lut: the finisher's
    L.rm = at;  at += 4 * kCMaxWarps * R;
    L.v = L.k;
  } else {
    L.c = at;   at += kCRing * R * kCTile;
    L.v = at;   at += kCRing * kCTile * p.dp;
  }
  if (kind != 0) {
    L.pc = at;  at += R * pc_b;
    L.vt = at;  at += p.dp * pc_b;
    L.rq = at;  at += 4 * 256;
    L.lsh = at; at += 4 * R;
  }
  L.total = at;
  return L;
}

// Pass A of one block (see the header). With kKeep the codes stay in
// shared memory for pass B of the same block (the one-tile kernel, whose
// span is one segment); else each segment's codes go to p.codes. kWide
// (D > 128) adds the q . K steps past 128 dims, q read from shared memory.
template <bool kKeep, int kW, bool kWide>
__device__ __forceinline__ void contiguous_pass_a(const CParams& p,
                                                  const CSlice& s,
                                                  unsigned char* smem,
                                                  const CLayout& L) {
  constexpr int nth = 32 * kW;  // threads
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int D = p.D, R = p.rows, qs_b = p.dp + 16, xs_b = p.xs_b;
  unsigned char* q_s = smem + L.q;
  unsigned char* k_s = smem + L.k;
  unsigned char* m_s = smem + L.m;
  int8_t* x_s = reinterpret_cast<int8_t*>(smem + L.x);
  float* exp_s = reinterpret_cast<float*>(smem + L.exp);
  int* rm_s = reinterpret_cast<int*>(smem + L.rm);
  const bool mvec = p.mask != nullptr;
  const long long mrow0 =
      ((long long)(s.g / p.mask_div) * p.Sq + s.r0) * p.Sk;
  const float s1 = *p.logit_scale;
  const long long row0 = (long long)s.g * p.Sq + s.r0;

  // a causal tile whose first key is past the last row's diagonal
  auto masked_whole = [&](int key0) {
    return !mvec && p.causal && key0 > s.r0 + s.nr - 1 + s.qoff;
  };
  auto issue = [&](int st) {
    const int key0 = s.ka + st * kCTile, nt = min(kCTile, s.ke - key0);
    if (!masked_whole(key0))
      stage_rows(k_s + (st % kCRing) * kCTile * qs_b, qs_b,
                 p.k + ((long long)s.g * p.Sk + key0) * D, D, nt, D);
    if (mvec)
      stage_rows(m_s + (st % kCRing) * R * kCTile, kCTile,
                 p.mask + mrow0 + key0, p.Sk, s.nr, nt);
  };
  if (s.ntile > 0)
    stage_rows(q_s, qs_b, p.q + row0 * D, D, s.nr, D);
  for (int st = 0; st < kCRing - 1; ++st) {  // q joins the first group
    if (st < s.ntile) issue(st);
    cp_async_commit();
  }
  // the exp values, and log_lut and prob_lut for the finisher
  int* lut_s = reinterpret_cast<int*>(smem + L.lut);
  for (int i = tid; i < 256; i += nth) {
    exp_s[i] = p.exp_val[i];
    lut_s[i] = p.log_lut[i];
    lut_s[256 + i] = p.prob_lut[i];
  }
  if (s.ntile > 0)  // zero pad of q to the k32 step, while the copies fly
    for (int i = tid; i < R * (p.dp - D); i += nth)
      q_s[(i / (p.dp - D)) * qs_b + D + i % (p.dp - D)] = 0;

  const int wpr = warps_per_row_tile<kW>(s.nr);
  const int rt = warp / wpr, kq = warp % wpr;
  const bool mma_warp = rt * 16 < s.nr;
  const int nk = p.dp / 32;
  unsigned qa[4][4];
  bool q_in = false;
  int m_lo = kLogitMin, m_hi = kLogitMin;  // rows rt*16 + gq and + 8

  for (int st = 0; st < s.ntile; ++st) {
    cp_async_wait<kCRing - 2>();
    __syncthreads();  // tile st is in; every thread is done with st - 1
    if (st + kCRing - 1 < s.ntile) issue(st + kCRing - 1);
    cp_async_commit();
    const int key0 = s.ka + st * kCTile, nt = min(kCTile, s.ke - key0);
    const int seg0 = p.nb > 1 ? key0 / p.bk * p.bk : s.ka;
    const int seg1 = p.nb > 1 ? min(seg0 + p.bk, s.ke) : s.ke;
    int8_t* xt = x_s + (key0 - seg0);
    if (masked_whole(key0)) {
      for (int i = tid; i < s.nr * nt; i += nth)
        xt[(i / nt) * xs_b + i % nt] = (int8_t)kLogitMin;
    } else if (mma_warp) {
      if (!q_in) {
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
        q_in = true;
      }
      const unsigned char* kb = k_s + (st % kCRing) * kCTile * qs_b;
      const unsigned char* mb = m_s + (st % kCRing) * R * kCTile;
      for (int n8 = kq; n8 * 8 < nt; n8 += wpr) {
        int acc[4] = {0, 0, 0, 0};
        const unsigned char* kr = kb + (n8 * 8 + gq) * qs_b + 4 * tq;
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
          const int c = n8 * 8 + 2 * tq + (e & 1);
          if (r >= s.nr || c >= nt) continue;
          int x = logit_of(acc[e], s1, p.rsd);
          const bool masked =
              mvec ? mb[r * kCTile + c] == 0
                   : (p.causal && key0 + c > s.r0 + r + s.qoff);
          if (masked) x = kLogitMin;
          xt[r * xs_b + c] = (int8_t)x;
          if (e < 2) m_lo = max(m_lo, x);
          else m_hi = max(m_hi, x);
        }
      }
    }
    if (key0 + nt < seg1) continue;
    // the segment is complete: its runs, key by key, and (two-pass) its
    // codes for pass B
    __syncthreads();
    const int j = seg0 / p.bk;
    const int c0 = p.nb > 1 ? 0 : s.c0, c1 = p.nb > 1 ? p.nch : s.c1;
    const int nrun = c1 - c0;
    const int rstride = p.nb * p.nch;
    for (int idx = tid; idx < s.nr * nrun; idx += nth) {
      const int r = idx / nrun, c = c0 + idx % nrun;
      int a, b;
      chunk_bounds(p.bk, c, a, b);
      a += j * p.bk;
      b = min(b + j * p.bk, seg1);
      if (a >= seg1) continue;  // past the fill level: never read
      const int8_t* xr = x_s + r * xs_b + (a - seg0);
      float sum = exp_s[xr[0] + 128];
      if (b - a == kRun && ((a - seg0) & 3) == 0) {
        // a full run: every load issued before the adds
        float ev[kRun];
#pragma unroll
        for (int w = 0; w < kRun / 4; ++w) {
          const int word = reinterpret_cast<const int*>(xr)[w];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            ev[4 * w + u] = exp_s[((word << (24 - 8 * u)) >> 24) + 128];
        }
#pragma unroll
        for (int t = 1; t < kRun; ++t) sum = __fadd_rn(sum, ev[t]);
      } else {
        for (int t = 1; t < b - a; ++t)
          sum = __fadd_rn(sum, exp_s[xr[t] + 128]);
      }
      p.run_tot[(row0 + r) * rstride + j * p.nch + c] = sum;
    }
    if (!kKeep) {
      const int n = seg1 - seg0;
      int8_t* cd = p.codes + row0 * p.psp + seg0;
      if (((seg0 | n) & 3) == 0) {
        const int w = n / 4;
        for (int i = tid; i < s.nr * w; i += nth)
          *reinterpret_cast<int*>(cd + (i / w) * (long long)p.psp +
                                  4 * (i % w)) =
              *reinterpret_cast<const int*>(x_s + (i / w) * xs_b +
                                            4 * (i % w));
      } else {
        for (int i = tid; i < s.nr * n; i += nth)
          cd[(i / n) * (long long)p.psp + i % n] = x_s[(i / n) * xs_b + i % n];
      }
    }
  }

  // the rows' LOGIT max over the span: lanes of a quad, then the warps of
  // a row tile
  if (mma_warp) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m_lo = max(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, o));
      m_hi = max(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, o));
    }
    if (tq == 0) {
      rm_s[kq * R + rt * 16 + gq] = m_lo;
      rm_s[kq * R + rt * 16 + gq + 8] = m_hi;
    }
  }
  __syncthreads();
  if (tid < s.nr && s.ntile > 0) {
    int m = rm_s[tid];
    for (int w = 1; w < wpr; ++w) m = max(m, rm_s[w * R + tid]);
    p.span_max[(row0 + tid) * p.splits + s.span] = m;
  }
}

// Whether this block is the last of its unit to finish pass A (every
// block's run totals and maxima are then visible to it).
__device__ __forceinline__ bool contiguous_arrive(const CParams& p,
                                                  const CSlice& s) {
  __shared__ int last_s;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_s = atomicAdd(&p.cells[1 + s.unit], 1) == p.splits - 1;
  __syncthreads();
  const bool last = last_s;
  if (last) __threadfence();
  return last;
}

// The unit's rows: S = the block sums in block order from 0.0, each block
// sum its run totals in run order (a run total left out past the fill
// level is an exact +0.0, and x + 0.0 == x for these sums); LOG(S), the
// rows' max PROB code into cmax; with split keys, zeroed output rows.
template <int kW>
__device__ __forceinline__ void contiguous_finish(const CParams& p,
                                                  const CSlice& s,
                                                  const unsigned char* smem,
                                                  const CLayout& L) {
  __shared__ int cmax_s;
  // pass A's copies of log_lut and prob_lut
  const int* lut_s = reinterpret_cast<const int*>(smem + L.lut);
  constexpr int nth = 32 * kW;  // threads
  const int tid = threadIdx.x;
  if (tid == 0) cmax_s = INT_MIN;
  __syncthreads();
  const long long row0 = (long long)s.g * p.Sq + s.r0;
  if (tid < s.nr) {
    const long long row = row0 + tid;
    float S = 0.0f;
    for (int j = 0; j < p.nb && j * p.bk < s.len; ++j) {
      const float* rt = p.run_tot + row * (p.nb * p.nch) + j * p.nch;
      float bs = 0.0f;  // 0.0 + the first run total is that total
      for (int c0 = 0; c0 < p.nch; c0 += 17) {  // a key block's 16 or 17
        float t17[17];                          // runs: every load at once
#pragma unroll
        for (int u = 0; u < 17; ++u) {
          int a = 0, b = 0;
          if (c0 + u < p.nch) chunk_bounds(p.bk, c0 + u, a, b);
          t17[u] = c0 + u < p.nch && j * p.bk + a < s.len
                       ? __ldcg(rt + c0 + u) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 17; ++u) bs = __fadd_rn(bs, t17[u]);
      }
      S = __fadd_rn(S, bs);
    }
    int xm = kLogitMin;
    for (int s0 = 0; s0 < p.splits; s0 += 16) {  // 16 loads in flight
      int m16[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int sp = s0 + u;
        m16[u] = sp < p.splits && span_start(p, sp) < s.len
                     ? __ldcg(p.span_max + row * p.splits + sp) : kLogitMin;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) xm = max(xm, m16[u]);
    }
    const int lsh = lut_s[pot_encode(S, p.pot)] * (1 << p.frac_shift);
    const int dmax = min(max(xm - lsh, kLogitMin), kLogitMax);
    // a zero-length group of a per-group vector has no keys: zero rows
    // and no cmax contribution (a scalar length keeps the reference's rule)
    const int c = (p.per_row && s.len == 0) ? 0 : lut_s[256 + dmax + 128];
    p.lsh[row] = lsh;
    atomicMax(&cmax_s, c);
  }
  if (p.splits > 1) {  // pass B adds its partials into zeroed rows
    int* o = p.out + row0 * p.D;
    for (int i = tid; i < s.nr * p.D; i += nth) o[i] = 0;
  }
  __syncthreads();
  if (tid == 0) atomicMax(p.cells, cmax_s);
}

// Pass B of one block (see the header). With kKeep the codes are pass A's
// in shared memory (x_s, the span's one segment); else each tile's codes
// are staged from p.codes beside its V tile.
template <bool kKeep, int kW>
__device__ __forceinline__ void contiguous_pass_b(const CParams& p,
                                                  const CSlice& s,
                                                  unsigned char* smem,
                                                  const CLayout& L) {
  constexpr int nth = 32 * kW;  // threads
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int D = p.D, dp = p.dp, R = p.rows;
  constexpr int pc_b = kCTile + 16;      // PROB / V^T row bytes
  const bool atomic = p.splits > 1;
  if (s.ntile == 0 && atomic) return;    // adds nothing to a zeroed out
  unsigned char* c_s = smem + L.c;
  unsigned char* v_s = smem + L.v;
  unsigned char* pc_s = smem + L.pc;
  unsigned char* vt_s = smem + L.vt;
  int* rq_s = reinterpret_cast<int*>(smem + L.rq);
  int* lsh_s = reinterpret_cast<int*>(smem + L.lsh);
  const int8_t* x_s = reinterpret_cast<const int8_t*>(smem + L.x);
  const long long row0 = (long long)s.g * p.Sq + s.r0;

  auto issue = [&](int st) {
    const int key0 = s.ka + st * kCTile, nt = min(kCTile, s.ke - key0);
    if (!kKeep)
      stage_rows(c_s + (st % kCRing) * R * kCTile, kCTile,
                 p.codes + row0 * p.psp + key0, p.psp, s.nr, nt);
    stage_rows(v_s + (st % kCRing) * kCTile * dp, dp,
               p.v + ((long long)s.g * p.Sk + key0) * D, D, nt, D);
  };
  const int wpr = warps_per_row_tile<kW>(s.nr);
  const int rt = warp / wpr, dq = warp % wpr;
  const bool mma_warp = rt * 16 < s.nr;
  const int ndt = (D + 7) / 8;
  // one sweep over the keys for every 16 x wpr output tiles of 8 columns:
  // one sweep up to D 128, two at D 256 and three at D 320 when a warp
  // has a row tile alone
  for (int d0 = 0; d0 < ndt; d0 += 16 * wpr) {
    if (d0 > 0) {  // the last sweep's copies and reads are done
      cp_async_wait<0>();
      __syncthreads();
    }
    for (int st = 0; st < kCRing - 1; ++st) {
      if (st < s.ntile) issue(st);
      cp_async_commit();
    }
    if (d0 == 0) {
      // requant table from the call-wide cmax (quantize_tensor of the PROB
      // values), written by other blocks: read past L1
      const int cm = __ldcg(p.cells);
      for (int i = tid; i < 256; i += nth)
        rq_s[i] = requant_code(p.prob_lut[i], cm);
      if (tid < s.nr) lsh_s[tid] = __ldcg(p.lsh + row0 + tid);
    }
    int acc[16][4];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;

    for (int st = 0; st < s.ntile; ++st) {
      cp_async_wait<kCRing - 2>();
      __syncthreads();  // tile st is in; every warp is done with st - 1
      if (st + kCRing - 1 < s.ntile) issue(st + kCRing - 1);
      cp_async_commit();
      const int key0 = s.ka + st * kCTile, nt = min(kCTile, s.ke - key0);
      const unsigned char* cb =
          kKeep ? reinterpret_cast<const unsigned char*>(x_s) + (key0 - s.ka)
                : c_s + (st % kCRing) * R * kCTile;
      const int cpitch = kKeep ? p.xs_b : kCTile;
      // code rows are 4-byte aligned (a pitch of 64, or xs_b from a tile
      // start), so each thread takes a word of 4 codes
      for (int i = tid; i < R * (kCTile / 4); i += nth) {
        const int r = i / (kCTile / 4), c0 = 4 * (i % (kCTile / 4));
        unsigned word = 0u;
        if (r < s.nr && c0 < nt) {
          const int lr = lsh_s[r];
          const int xw = *reinterpret_cast<const int*>(cb + r * cpitch + c0);
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int x = (xw << (24 - 8 * b)) >> 24;
            const int d = min(max(x - lr, kLogitMin), kLogitMax);
            if (c0 + b < nt)
              word |= ((unsigned)rq_s[d + 128] & 0xffu) << (8 * b);
          }
        }
        *reinterpret_cast<unsigned*>(pc_s + r * pc_b + c0) = word;
      }
      transpose_tile(vt_s, pc_b, v_s + (st % kCRing) * kCTile * dp, dp,
                     kCTile, dp, tid, nth);
      __syncthreads();
      if (mma_warp) {
        const unsigned char* ar = pc_s + (rt * 16 + gq) * pc_b + 4 * tq;
#pragma unroll
        for (int kk = 0; kk < kCTile / 32; ++kk) {
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
        int* o = p.out + (row0 + r) * D + d;
        if (atomic) atomicAdd(o, acc[i][e]);
        else *o = acc[i][e];
      }
    }
  }
}

// Fill a CParams from the launch arguments; false for a shape the kernels
// do not take. xcap is the most keys of one segment.
inline bool contiguous_params(
    CParams& p, const void* q, const void* k, const void* v,
    const void* kv_len, const void* mask, int mask_div,
    const void* logit_scale, float rsd, const void* q_offset, int q_off,
    const void* exp_val, const void* log_lut, const void* prob_lut,
    void* out, void* run_tot,
    void* span_max, void* codes, void* lsh, void* cells, int G, int Sq,
    int Sk, int D, int bk, int causal, int per_row, int splits, int per,
    int psp, float e_min, float step_scale, float safe_min, float thr,
    int frac_shift) {
  if (D % 4 != 0 || D <= 0 || D > kMaxD || G <= 0 || Sq <= 0 || Sk <= 0 ||
      bk <= 0 || bk > 512 || (Sk > bk && bk % kCTile != 0) || splits <= 0 ||
      per <= 0)
    return false;
  p.q = static_cast<const int8_t*>(q);
  p.k = static_cast<const int8_t*>(k);
  p.v = static_cast<const int8_t*>(v);
  p.kv_len = static_cast<const int*>(kv_len);
  p.mask = static_cast<const int8_t*>(mask);
  p.mask_div = mask_div;
  p.logit_scale = static_cast<const float*>(logit_scale);
  p.rsd = rsd;
  p.q_offset = static_cast<const int*>(q_offset);
  p.q_off = q_off;
  p.exp_val = static_cast<const float*>(exp_val);
  p.log_lut = static_cast<const int*>(log_lut);
  p.prob_lut = static_cast<const int*>(prob_lut);
  p.out = static_cast<int*>(out);
  p.run_tot = static_cast<float*>(run_tot);
  p.span_max = static_cast<int*>(span_max);
  p.codes = static_cast<int8_t*>(codes);
  p.lsh = static_cast<int*>(lsh);
  p.cells = static_cast<int*>(cells);
  p.G = G; p.Sq = Sq; p.Sk = Sk; p.D = D; p.dp = (D + 31) & ~31;
  p.bk = bk; p.nb = (Sk + bk - 1) / bk; p.nch = n_chunks(bk);
  p.causal = causal; p.per_row = per_row;
  p.row_tiles = (Sq + kCRows - 1) / kCRows;
  p.rows = Sq < kCRows ? (Sq + 15) / 16 * 16 : kCRows;
  p.units = G * p.row_tiles;
  p.splits = splits; p.per = per; p.psp = psp;
  const int n = p.nb > 1 ? p.nb : p.nch;
  if ((splits - 1) * per >= n || splits * per < n) return false;
  if (codes != nullptr && psp < p.nb * bk) return false;
  // a run is at most 32 keys, a segment at most one key block
  const int xcap = p.nb > 1 ? bk : (per * kRun < bk ? per * kRun : bk);
  p.xs_b = (xcap + 15) / 16 * 16 + 4;
  p.pot = PotConsts{e_min, step_scale, safe_min, thr};
  p.frac_shift = frac_shift;
  return true;
}

}  // namespace acam
