// The paged attention entries' operand prolog, for sm_90a: int8 codes of
// q and of the live rows of a block-paged K/V pool, with their three
// per-tensor scales, in two launches (prolog_max, prolog_quant) and no
// host synchronisation.
//
// Replaces, on the card, the torch composition of
// repro_torch/kernels/ops.py paged_operands_plain (the reference's
// quantize_tensor(q), page_valid_lengths, masked_page_quantize of K and V,
// then the stripe row layout the paged kernels read). What it computes:
//
//   live(p)   page p's live rows: the max over the block-table entries
//             (b, j) naming p of clip(kv_len[b] - j*ps, 0, ps); 0 for the
//             trash page 0 and for pages no entry names;
//   amax      max |x| over q; over the live rows of K; of V;
//   scale     max(amax, f32(1e-12)) * f32(1/127) (recip_scale), NaN kept;
//   code      clip(rint(x / scale), -128, 127) as int8 (a true division,
//             round half to even, NaN kept through the clip and cast as
//             torch casts it), and 0 in the rows past live(p).
//
// prolog_max: every block takes one block-table entry and a slab of its
// page's live rows (a page's first live rows are one contiguous run of the
// pool) or a piece of q, and folds max |x| into the workspace with an
// unsigned atomicMax on the float's bits. |x| has its sign bit clear, so
// the bits order as the floats do, and every NaN (exponent all ones, a
// mantissa) lies above +Inf: the max propagates NaN as torch.amax does.
// The entry's block 0 folds live + 1 into the page's workspace word (0
// stays "no entry names the page"). Max is order-free: exact whatever the
// blocks' order, and a page that two slots share (the prefix cache) is
// read twice to the same result.
//
// prolog_quant: every block takes a slab of one physical page (or a piece
// of q), reads the three amaxes and the page's word, and writes the codes
// of its rows in the stripe layout: row ((p*KV + kvh)*rep + t)*ps + r of
// (n_pages*KV*rep, ps, hd), rep copies of each KV head (rep = H / KV for
// the flat entry, 1 for the GQA-native one), so no transpose pass
// follows. Live rows are read and quantized, dead rows of a named page get
// code 0 without a read, and pages no entry names are not touched (the
// paged kernels reach a page only through the block table). The block that
// arrives last (a counter behind a __threadfence) clears the workspace
// words again, so the next call starts from zeros without a fill launch and
// a captured graph replays unchanged.
//
// Bit-exactness with the torch composition on the card: every float step
// is an explicit __f*_rn operation (built with -fmad=false); bfloat16 pools
// widen exactly to float32, as the serving layer's .float() did; the
// clamp_min and the clip pass NaN through as torch's clamp kernels do.
//
// What bounds it on an H100: bytes. The live float rows are read twice
// (once a launch) and the int8 codes written once: on gpt2-large's pool
// (20 KV heads of 64, 64-row pages, 32 slots of ~600 keys) some 0.4 GB a
// call, about 0.15 ms at 3 TB/s, against the ~4.6 GB of the composition's
// whole-pool passes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// workspace words: [0..2] amax bits of q, K, V; [3] the quantise launch's
// arrivals; [kPages + p] page p's live rows + 1 (0: no entry names it)
constexpr int kPages = 4;

struct Prolog {
  const float* q;             // (B, H, Sq, D) float32, d contiguous
  long long sb, sh, ss;       // q's strides of b, h, s
  int H, Sq, D;
  long long nq;               // B * H * Sq * D
  const void* k;              // (n_pages, ps, KV, hd) float32 or bfloat16
  const void* v;
  int n_pages, ps, KV, hd, rep;
  int slab;                   // ps * KV * hd elements of one page
  const int* block_table;     // (n_slots, max_pages)
  const int* kv_len;          // (n_slots,)
  int max_pages;
  long long entries;          // n_slots * max_pages
  int8_t* qc;                 // (B, H, Sq, D)
  int8_t* kc;                 // (n_pages * KV * rep, ps, hd)
  int8_t* vc;
  float* stats;               // amax of q, K, V (clamped); scale of each
  unsigned* ws;               // the workspace (above), zero between calls
  int chunk;                  // elements of a slab or of q a block takes
  int slab_blocks;            // blocks of one page slab
};

__device__ __forceinline__ float bf16_to_f32(uint16_t h) {
  return __uint_as_float((unsigned)h << 16);
}

// V consecutive elements of a pool from element i, widened to float
template <typename T, int V>
__device__ __forceinline__ void load(const T* x, long long i, float (&f)[V]) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (V == 4) {
      const float4 u = *reinterpret_cast<const float4*>(x + i);
      f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
    } else {
      f[0] = x[i];
    }
  } else {
    if constexpr (V == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(x + i);
      f[0] = __uint_as_float(u.x << 16);
      f[1] = __uint_as_float(u.x & 0xffff0000u);
      f[2] = __uint_as_float(u.y << 16);
      f[3] = __uint_as_float(u.y & 0xffff0000u);
    } else {
      f[0] = bf16_to_f32(x[i]);
    }
  }
}

__device__ __forceinline__ unsigned abs_bits(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}

// q's offset of element o of its (B, H, Sq, D) order
__device__ __forceinline__ long long q_at(const Prolog& p, long long o) {
  const int d = (int)(o % p.D);
  long long t = o / p.D;
  const int s = (int)(t % p.Sq);
  t /= p.Sq;
  const int h = (int)(t % p.H);
  return (t / p.H) * p.sb + h * p.sh + s * p.ss + d;
}

// fold a block's max bits into a workspace word
__device__ __forceinline__ void block_max(unsigned m, unsigned* dst,
                                          unsigned* red) {
  m = __reduce_max_sync(0xffffffffu, m);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) m = max(m, red[w]);
    atomicMax(dst, m);
  }
  __syncthreads();
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) prolog_max(Prolog p) {
  __shared__ unsigned red[2][kWarps];
  const long long page_blocks = p.entries * p.slab_blocks;
  const long long blk = blockIdx.x;
  if (blk < page_blocks) {
    const long long e = blk / p.slab_blocks;
    const int c = (int)(blk % p.slab_blocks);
    const int pg = p.block_table[e];
    if (pg < 0 || pg >= p.n_pages) return;  // not a page of the pool
    const int j = (int)(e % p.max_pages);
    int live = min(max(p.kv_len[e / p.max_pages] - j * p.ps, 0), p.ps);
    if (pg == 0) live = 0;  // the trash page is never live
    if (c == 0 && threadIdx.x == 0) atomicMax(p.ws + kPages + pg, live + 1u);
    const int n = live * p.KV * p.hd;
    const int lo = c * p.chunk, hi = min(lo + p.chunk, n);
    if (lo >= hi) return;
    const T* k = static_cast<const T*>(p.k) + (long long)pg * p.slab;
    const T* v = static_cast<const T*>(p.v) + (long long)pg * p.slab;
    unsigned mk = 0, mv = 0;
#pragma unroll 4
    for (int i = lo + threadIdx.x * V; i < hi; i += kThreads * V) {
      float fk[V], fv[V];
      load<T, V>(k, i, fk);
      load<T, V>(v, i, fv);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        mk = max(mk, abs_bits(fk[u]));
        mv = max(mv, abs_bits(fv[u]));
      }
    }
    block_max(mk, p.ws + 1, red[0]);
    block_max(mv, p.ws + 2, red[1]);
    return;
  }
  const long long lo = (blk - page_blocks) * p.chunk;
  const long long hi = min(lo + p.chunk, p.nq);
  unsigned mq = 0;
  for (long long o = lo + threadIdx.x * V; o < hi; o += kThreads * V) {
    float f[V];
    load<float, V>(p.q, q_at(p, o), f);
#pragma unroll
    for (int u = 0; u < V; ++u) mq = max(mq, abs_bits(f[u]));
  }
  block_max(mq, p.ws, red[0]);
}

// torch.clamp_min(amax, f32(1e-12)): NaN passes through
__device__ __forceinline__ float clamped(float amax) {
  return amax != amax ? amax : fmaxf(amax, 1e-12f);
}

// clip(rint(x / scale), -128, 127).to(int8) as torch's kernels run it
__device__ __forceinline__ int8_t code_of(float x, float scale) {
  float r = rintf(__fdiv_rn(x, scale));
  if (r == r) r = fminf(fmaxf(r, -128.0f), 127.0f);
  return static_cast<int8_t>(r);
}

template <int V>
__device__ __forceinline__ void store(int8_t* dst, const int8_t (&c)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<char4*>(dst) = make_char4(c[0], c[1], c[2], c[3]);
  } else {
    dst[0] = c[0];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) prolog_quant(Prolog p) {
  __shared__ float scale_s[3];
  __shared__ unsigned tag_s;
  __shared__ bool last_s;
  const long long page_blocks = (long long)p.n_pages * p.slab_blocks;
  const long long blk = blockIdx.x;
  if (threadIdx.x < 3) {
    const float a = clamped(__uint_as_float(p.ws[threadIdx.x]));
    const float s = __fmul_rn(a, 1.0f / 127.0f);
    scale_s[threadIdx.x] = s;
    if (blk == 0) {
      p.stats[threadIdx.x] = a;
      p.stats[3 + threadIdx.x] = s;
    }
  }
  if (threadIdx.x == 0)
    tag_s = blk < page_blocks ? p.ws[kPages + blk / p.slab_blocks] : 0u;
  __syncthreads();
  if (blk < page_blocks) {
    if (tag_s != 0) {  // a page some entry names
      const int pg = (int)(blk / p.slab_blocks);
      const int c = (int)(blk % p.slab_blocks);
      const int row = p.KV * p.hd;
      const int n = (int)(tag_s - 1) * row;
      const int lo = c * p.chunk, hi = min(lo + p.chunk, p.slab);
      const T* k = static_cast<const T*>(p.k) + (long long)pg * p.slab;
      const T* v = static_cast<const T*>(p.v) + (long long)pg * p.slab;
      const float sk = scale_s[1], sv = scale_s[2];
      for (int i = lo + threadIdx.x * V; i < hi; i += kThreads * V) {
        int8_t ck[V], cv[V];
        if (i < n) {
          float fk[V], fv[V];
          load<T, V>(k, i, fk);
          load<T, V>(v, i, fv);
#pragma unroll
          for (int u = 0; u < V; ++u) {
            ck[u] = code_of(fk[u], sk);
            cv[u] = code_of(fv[u], sv);
          }
        } else {
#pragma unroll
          for (int u = 0; u < V; ++u) ck[u] = cv[u] = 0;
        }
        const int r = i / row, kvh = (i % row) / p.hd, d = i % p.hd;
        const long long g0 = ((long long)pg * p.KV + kvh) * p.rep;
        for (int t = 0; t < p.rep; ++t) {
          const long long at = ((g0 + t) * p.ps + r) * p.hd + d;
          store<V>(p.kc + at, ck);
          store<V>(p.vc + at, cv);
        }
      }
    }
  } else {
    const long long lo = (blk - page_blocks) * p.chunk;
    const long long hi = min(lo + p.chunk, p.nq);
    const float sq = scale_s[0];
    for (long long o = lo + threadIdx.x * V; o < hi; o += kThreads * V) {
      float f[V];
      load<float, V>(p.q, q_at(p, o), f);
      int8_t cq[V];
#pragma unroll
      for (int u = 0; u < V; ++u) cq[u] = code_of(f[u], sq);
      store<V>(p.qc + o, cq);
    }
  }
  // the last block to arrive clears the workspace for the next call: every
  // block read its words before it arrived
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last_s = atomicAdd(p.ws + 3, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_s) return;
  for (int i = threadIdx.x; i < kPages + p.n_pages; i += kThreads)
    p.ws[i] = 0u;
}

template <typename T, int V>
cudaError_t launch(const Prolog& p, long long grid_max, long long grid_quant,
                   cudaStream_t s) {
  prolog_max<T, V><<<(unsigned)grid_max, kThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  prolog_quant<T, V><<<(unsigned)grid_quant, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Both launches on `stream`; the host plan (kernels/acam_prolog.py
// prolog_plan) gives chunk, slab_blocks and q_blocks. A thread steps 4
// elements where every row and stride of q and of the pool is a multiple
// of 4 elements and the operands are aligned to such a step, else one. ws
// holds 4 + n_pages zeroed words and is left zeroed. Returns the CUDA
// error code.
extern "C" int acam_prolog_launch(
    const void* q, long long sb, long long sh, long long ss, int B, int H,
    int Sq, int D, const void* k, const void* v, int pool_bf16, int n_pages,
    int ps, int KV, int hd, int rep, const void* block_table,
    const void* kv_len, int n_slots, int max_pages, void* qc, void* kc,
    void* vc, void* stats, void* ws, int chunk, int slab_blocks,
    long long q_blocks, void* stream) {
  const long long slab = (long long)ps * KV * hd;
  const size_t step = pool_bf16 ? 8 : 16;  // 4 elements of the pool
  const int vec = (D % 4 == 0 && hd % 4 == 0 && sb % 4 == 0 && sh % 4 == 0 &&
                   ss % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % step == 0 &&
                   reinterpret_cast<uintptr_t>(v) % step == 0) ? 4 : 1;
  if (B <= 0 || H <= 0 || Sq <= 0 || D <= 0 || n_pages <= 0 || ps <= 0 ||
      KV <= 0 || hd <= 0 || rep <= 0 || n_slots <= 0 || max_pages <= 0 ||
      chunk <= 0 || chunk % (kThreads * 4) != 0 || slab >= (1LL << 31) ||
      (long long)slab_blocks * chunk < slab || D != hd)
    return (int)cudaErrorInvalidValue;
  Prolog p;
  p.q = static_cast<const float*>(q);
  p.sb = sb; p.sh = sh; p.ss = ss;
  p.H = H; p.Sq = Sq; p.D = D;
  p.nq = (long long)B * H * Sq * D;
  p.k = k; p.v = v;
  p.n_pages = n_pages; p.ps = ps; p.KV = KV; p.hd = hd; p.rep = rep;
  p.slab = (int)slab;
  p.block_table = static_cast<const int*>(block_table);
  p.kv_len = static_cast<const int*>(kv_len);
  p.max_pages = max_pages;
  p.entries = (long long)n_slots * max_pages;
  p.qc = static_cast<int8_t*>(qc);
  p.kc = static_cast<int8_t*>(kc);
  p.vc = static_cast<int8_t*>(vc);
  p.stats = static_cast<float*>(stats);
  p.ws = static_cast<unsigned*>(ws);
  p.chunk = chunk;
  p.slab_blocks = slab_blocks;
  const long long grid_max = p.entries * slab_blocks + q_blocks;
  const long long grid_quant = (long long)n_pages * slab_blocks + q_blocks;
  if (grid_max >= (1LL << 31) || grid_quant >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (pool_bf16)
    err = vec == 4 ? launch<uint16_t, 4>(p, grid_max, grid_quant, s)
                   : launch<uint16_t, 1>(p, grid_max, grid_quant, s);
  else
    err = vec == 4 ? launch<float, 4>(p, grid_max, grid_quant, s)
                   : launch<float, 1>(p, grid_max, grid_quant, s);
  return (int)err;
}
