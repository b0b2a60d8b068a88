// Bit-sliced ReRAM crossbar MVM with Compute-ACAM ADCs, for sm_90a:
// x (M, K) int8 codes times w (K, N) int8 codes -> (M, N) int32.
//
// Replaces the TPU kernel src/repro/kernels/acam_mvm.py::_mvm_kernel (its
// (M/bm, N/bn, K/bk) grid with an int32 VMEM accumulator revisited over k).
// What it computes, for every K tile of bk rows (one crossbar when
// bk == cfg.rows):
//
//   xu = x + 2^(input_bits-1), wu = w + 2^(weight_bits-1)  (ISAAC offsets;
//        rows past K carry zero in this unsigned domain)
//   exact ADC      acc += sum_k xu*wu
//   quantize ADC   for every input slice t (dac_bits wide) and weight slice
//                  s (cell_bits wide): p = sum_k xu_t*wu_s over the tile,
//                  q = rint(rint(p * f32(1/step)) * step), acc += q << shift
//   both           acc -= ow*rowsum(xu) + ox*colsum(wu) over the tile
//
// and at the end out = acc + K*ox*ow. The ADC's step comes from cfg.rows,
// not from bk, and it is applied per bk-row tile, as the Pallas kernel does.
// The reference's jitted p / step is a multiply by the float32 reciprocal
// of float32(step), which the wrapper passes in. Every sum is taken modulo
// 2^32, as the reference's int32 arithmetic wraps, so the result equals it
// bit for bit in any order of summation.
//
// What bounds it on an H100. Exact ADC: bytes (gpt2-large fc1, 17.7 MB,
// 5.3 us at 3.35 TB/s; its 6.7 G int8 operations take 3.4 us at the
// tensor-core peak). Quantizing ADC: operations, 32 plane products per
// output at the default slicing (108.5 us at fc1), and beside them the
// ADC's float steps per output, plane and tile on the CUDA cores.
//
// The design. The offsets cancel modulo 2^32:
//   sum (x+ox)(w+ow) - ow sum (x+ox) - ox sum (w+ow) + K ox ow = sum x w,
// so the exact mode is a plain s8 x s8 -> s32 product of the raw codes on
// the int8 tensor cores, with no offsets and no corrections: `mvm_wgmma`
// (wgmma m64n128k32, two warpgroups on a 128 x 128 tile) at M > 16, the
// `mvm_kernel` template (mma.sync m16n8k32, 16 x 128 tiles) for a decode
// step's M <= 16. The quantizing mode runs its plane products on the u8
// tensor cores: each staged tile is offset-encoded once (a per-byte add,
// __vadd4), and as each fragment register holds 4 consecutive k bytes, a
// shift and a per-byte mask take a bit plane of four codes straight from
// the register. A thread keeps the plane sums of 4 weight slices of one
// input slice over a bk tile, then applies the ADC (with full-rate float
// adds in place of the quarter-rate conversions, `adc`) and shift-adds into
// an unsigned accumulator. The row and column sums are linear, so they are
// taken once over the whole K.
//   The tensor cores take int8 operands K-major only; w arrives (K, N) with
// N contiguous, so each stage is copied raw (16-byte cp.async into a ring
// of 2 to 4 stages, the next ones in flight while one is computed) and
// then transposed in shared memory with byte permutes of 4 x 4 blocks.
//   Quantizing block tiles are 64 x 32 (the plane sums fill the
// registers), 16 x 64 when M <= 16. When the tiles do not fill the card,
// K is split over blocks (on stage boundaries) and the int32 partials are
// added with atomicAdd, exact and order-free modulo 2^32. The wrapper
// picks the split and lays out the operands (kernels/acam_mvm.py
// mvm_plan, mvm_operands): K in stages of `kstage` bytes (64 exact; bk
// rounded up to 32, quantize), padded rows carrying the code whose
// offset-encoded value is 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "acam_mma.cuh"

namespace {

using namespace acam;

struct MvmParams {
  const int8_t* x;          // (M, kp) codes, kp = n_stages * kstage
  const int8_t* w;          // (kp, ldw) codes, ldw a multiple of 16
  int* out;                 // (M, N) int32; zeroed by the wrapper if split
  int M, N, ldw, kp, kstage, n_stages, stages_per_split, atomic;
  int ox, ow;               // input / weight offsets
  int dac_bits, cell_bits;
  int n_in, n_w;            // input / weight slices
  float step, inv_step;
  int magic_adc;            // every ADC value < 2^22: float tricks, no cvt
  unsigned k_ox_ow;         // K * ox * ow, modulo 2^32
};

// The ADC on a plane sum p >= 0: rint(rint(p * inv) * step), as the
// reference's float32 graph. With p and the values after it below 2^22
// (`magic`), the int <-> float conversions and the two rints (quarter-rate
// conversion instructions) become full-rate adds: 2^23 + p is p's bits
// over 2^23's, and x + 1.5 * 2^23 rounds x to an integer half to even.
__device__ __forceinline__ unsigned adc(int p, float inv, float step,
                                        bool magic) {
  if (magic) {
    const float pf = __fsub_rn(__int_as_float(p + 0x4B000000), 8388608.0f);
    const float r = __fsub_rn(__fadd_rn(__fmul_rn(pf, inv), 12582912.0f),
                              12582912.0f);
    return (unsigned)(__float_as_int(__fadd_rn(__fmul_rn(r, step),
                                               12582912.0f)) - 0x4B400000);
  }
  const float r = rintf(__fmul_rn(__int2float_rn(p), inv));
  return (unsigned)__float2int_rn(__fmul_rn(r, step));
}

// MT x NT mma tiles per warp, WM x WN warps, a ring of S stages
template <int MT, int NT, int WM, int WN, int S, bool Q>
__global__ void __launch_bounds__(WM * WN * 32) mvm_kernel(MvmParams p) {
  constexpr int BM = 16 * MT * WM, BN = 8 * NT * WN, NTH = WM * WN * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ks = p.kstage;
  const int rs_b = ks + 16;  // staged row bytes: conflict-free fragments
  unsigned char* xs = smem;                         // S x BM x rs_b
  unsigned char* wr = xs + S * BM * rs_b;           // S x ks x BN (raw w)
  unsigned char* wt = wr + S * ks * BN;             // BN x rs_b (w^T)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int st0 = blockIdx.z * p.stages_per_split;
  const int nst = min(p.stages_per_split, p.n_stages - st0);

  auto load_stage = [&](int st, int slot) {
    const int k0 = st * ks, kc = ks / 16;
    unsigned char* xd = xs + slot * BM * rs_b;
    for (int c = tid; c < BM * kc; c += NTH) {
      const int r = c / kc, cc = c % kc;
      const int m = min(m0 + r, p.M - 1);  // rows past M: discarded
      cp_async16(xd + r * rs_b + cc * 16,
                 p.x + (long long)m * p.kp + k0 + cc * 16);
    }
    unsigned char* wd = wr + slot * ks * BN;
    constexpr int nc = BN / 16;
    for (int c = tid; c < ks * nc; c += NTH) {
      const int r = c / nc, cc = c % nc;
      const int n = min(n0 + cc * 16, p.ldw - 16);  // past N: discarded
      cp_async16(wd + r * BN + cc * 16,
                 p.w + (long long)(k0 + r) * p.ldw + n);
    }
  };

  unsigned acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0u;
  unsigned rsum[MT][2], csum[NT];  // sums of xu, wu (quantize only)
#pragma unroll
  for (int i = 0; i < MT; ++i) rsum[i][0] = rsum[i][1] = 0u;
#pragma unroll
  for (int j = 0; j < NT; ++j) csum[j] = 0u;

  const unsigned ox4 = (unsigned)p.ox * 0x01010101u;
  const unsigned ow4 = (unsigned)p.ow * 0x01010101u;
  const bool magic = p.magic_adc != 0;
  const unsigned dmask = (1u << p.dac_bits) - 1u;
  const unsigned cmask = (1u << p.cell_bits) - 1u;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nst) load_stage(st0 + s, s);
    cp_async_commit();
  }

  for (int s = 0; s < nst; ++s) {
    cp_async_wait<S - 2>();
    __syncthreads();  // stage s landed; every warp is done with stage s-1
    if (s + S - 1 < nst) load_stage(st0 + s + S - 1, (s + S - 1) % S);
    cp_async_commit();
    const int slot = s % S;
    if (Q) {  // offset-encode the staged codes once: xu = x + ox per byte
      unsigned* xw = reinterpret_cast<unsigned*>(xs + slot * BM * rs_b);
      const int wpr = ks / 4, wst = rs_b / 4;
      for (int i = tid; i < BM * wpr; i += NTH)
        xw[(i / wpr) * wst + i % wpr] =
            __vadd4(xw[(i / wpr) * wst + i % wpr], ox4);
    }
    transpose_tile(wt, rs_b, wr + slot * ks * BN, BN, ks, BN, tid, NTH,
                   Q ? ow4 : 0u);
    __syncthreads();
    const unsigned char* xa = xs + slot * BM * rs_b;
    const int arow = wm * 16 * MT + g, bcol = wn * 8 * NT + g;
    const int nk = ks / 32;

    if (!Q) {
      for (int kk = 0; kk < nk; ++kk) {
        const int kb = kk * 32 + 4 * t;
        unsigned a[MT][4], b[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const unsigned char* r0 = xa + (arow + 16 * i) * rs_b + kb;
          a[i][0] = *reinterpret_cast<const unsigned*>(r0);
          a[i][1] = *reinterpret_cast<const unsigned*>(r0 + 8 * rs_b);
          a[i][2] = *reinterpret_cast<const unsigned*>(r0 + 16);
          a[i][3] = *reinterpret_cast<const unsigned*>(r0 + 8 * rs_b + 16);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const unsigned char* c0 = wt + (bcol + 8 * j) * rs_b + kb;
          b[j][0] = *reinterpret_cast<const unsigned*>(c0);
          b[j][1] = *reinterpret_cast<const unsigned*>(c0 + 16);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma_s8(reinterpret_cast<int(&)[4]>(acc[i][j]), a[i], b[j]);
      }
      continue;
    }

    // quantizing ADC: per input slice t and group of 4 weight slices, the
    // plane sums over this bk tile, then the ADC and the shift-add
    for (int sg = 0; sg < p.n_w; sg += 4) {
      for (int ti = 0; ti < p.n_in; ++ti) {
        const int xsh = ti * p.dac_bits;
        const unsigned xm = (dmask & (0xffu >> xsh)) * 0x01010101u;
        int pl[4][MT][NT][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) pl[q][i][j][e] = 0;
        const bool sums = sg == 0 && ti == 0;
        for (int kk = 0; kk < nk; ++kk) {
          const int kb = kk * 32 + 4 * t;
          unsigned a[MT][4], b[NT][2];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const unsigned char* r0 = xa + (arow + 16 * i) * rs_b + kb;
            a[i][0] = *reinterpret_cast<const unsigned*>(r0);
            a[i][1] = *reinterpret_cast<const unsigned*>(r0 + 8 * rs_b);
            a[i][2] = *reinterpret_cast<const unsigned*>(r0 + 16);
            a[i][3] = *reinterpret_cast<const unsigned*>(r0 + 8 * rs_b + 16);
            if (sums) {
              rsum[i][0] = __dp4a(a[i][0], 0x01010101u, rsum[i][0]);
              rsum[i][0] = __dp4a(a[i][2], 0x01010101u, rsum[i][0]);
              rsum[i][1] = __dp4a(a[i][1], 0x01010101u, rsum[i][1]);
              rsum[i][1] = __dp4a(a[i][3], 0x01010101u, rsum[i][1]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) a[i][e] = (a[i][e] >> xsh) & xm;
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const unsigned char* c0 = wt + (bcol + 8 * j) * rs_b + kb;
            b[j][0] = *reinterpret_cast<const unsigned*>(c0);
            b[j][1] = *reinterpret_cast<const unsigned*>(c0 + 16);
            if (sums) {
              csum[j] = __dp4a(b[j][0], 0x01010101u, csum[j]);
              csum[j] = __dp4a(b[j][1], 0x01010101u, csum[j]);
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (sg + q >= p.n_w) break;
            const int wsh = (sg + q) * p.cell_bits;
            const unsigned wm4 = (cmask & (0xffu >> wsh)) * 0x01010101u;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const unsigned bp[2] = {(b[j][0] >> wsh) & wm4,
                                      (b[j][1] >> wsh) & wm4};
#pragma unroll
              for (int i = 0; i < MT; ++i) mma_u8(pl[q][i][j], a[i], bp);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (sg + q >= p.n_w) break;
          const int sh = xsh + (sg + q) * p.cell_bits;
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[i][j][e] += adc(pl[q][i][j][e], p.inv_step, p.step,
                                    magic) << sh;
        }
      }
    }
  }

  // epilogue: the offset corrections (quantize), then store or add
  unsigned corr_r[MT][2], corr_c[NT][2];
  if (Q) {  // padded rows hold xu = wu = 0 and add nothing to the sums
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned v = rsum[i][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        // ow * rowsum(xu) (- K ox ow once, by the first split)
        corr_r[i][h] = (unsigned)p.ow * v
                       - (blockIdx.z == 0 ? p.k_ox_ow : 0u);
      }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      unsigned v = csum[j];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      // column g's sum sits on lanes 4g..4g+3: fetch columns 2t and 2t+1
      corr_c[j][0] = (unsigned)p.ox * __shfl_sync(0xffffffffu, v, 8 * t);
      corr_c[j][1] = (unsigned)p.ox * __shfl_sync(0xffffffffu, v, 8 * t + 4);
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 16 * MT + 16 * i + g + (e >= 2 ? 8 : 0);
        const int n = n0 + wn * 8 * NT + 8 * j + 2 * t + (e & 1);
        if (m >= p.M || n >= p.N) continue;
        unsigned v = acc[i][j][e];
        if (Q) v -= corr_r[i][e >> 1] + corr_c[j][e & 1];
        int* o = p.out + (long long)m * p.N + n;
        if (p.atomic) atomicAdd(o, (int)v);
        else *o = (int)v;
      }
}

template <int MT, int NT, int WM, int WN, int S, bool Q>
int launch(const MvmParams& p, int splits, cudaStream_t stream) {
  constexpr int BM = 16 * MT * WM, BN = 8 * NT * WN;
  const size_t smem = (size_t)S * BM * (p.kstage + 16)
                      + (size_t)S * p.kstage * BN
                      + (size_t)BN * (p.kstage + 16);
  auto fn = mvm_kernel<MT, NT, WM, WN, S, Q>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, splits);
  fn<<<grid, WM * WN * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// exact ADC, M > 16: wgmma m64n128k32 on the int8 tensor cores
// ---------------------------------------------------------------------------

// A wgmma shared-memory descriptor, no swizzle: K-major core matrices of 8
// rows x 16 bytes, `lbo` bytes to the next 16 k bytes, `sbo` to the next 8
// rows (cute's GmmaDescriptor, layout INTERLEAVE)
__device__ __forceinline__ uint64_t gmma_desc(const void* smem, int lbo,
                                              int sbo) {
  const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(smem));
  return ((a & 0x3FFFFull) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x 128 s32, this warpgroup's) += A (64 x 32 s8) . B (32 x 128 s8)
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64],
                                                    uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence_operands(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

constexpr int kWgBM = 128, kWgBN = 128, kWgBK = 64, kWgS = 4;
constexpr int kWgTile = kWgBM * kWgBK;  // bytes of one staged x or w tile

// Two warpgroups of 64 rows share a 128 x 128 output tile; K in stages of
// 64 bytes in a ring of 4 (cp.async, two stages ahead). x goes straight
// into the core-matrix layout; the raw w stage is transposed into one of
// two w^T buffers while the products of the stage before are in flight.
__global__ void __launch_bounds__(256) mvm_wgmma(MvmParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* xs = smem;                      // kWgS x (BM x BK) core
  unsigned char* wr = xs + kWgS * kWgTile;       // kWgS x (BK x BN) raw
  unsigned char* wt = wr + kWgS * kWgTile;       // 2 x (BN x BK) core
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kWgBM, n0 = blockIdx.x * kWgBN;
  const int st0 = blockIdx.z * p.stages_per_split;
  const int nst = min(p.stages_per_split, p.n_stages - st0);

  auto load_stage = [&](int st, int slot) {
    const int k0 = st * kWgBK;
    unsigned char* xd = xs + slot * kWgTile;
    for (int c = tid; c < kWgBM * 4; c += 256) {  // 16-byte chunks
      const int r = c >> 2, cc = c & 3;
      const int m = min(m0 + r, p.M - 1);  // rows past M: discarded
      cp_async16(xd + ((r >> 3) * 4 + cc) * 128 + (r & 7) * 16,
                 p.x + (long long)m * p.kp + k0 + cc * 16);
    }
    unsigned char* wd = wr + slot * kWgTile;
    for (int c = tid; c < kWgBK * (kWgBN / 16); c += 256) {
      const int r = c / (kWgBN / 16), cc = c % (kWgBN / 16);
      const int n = min(n0 + cc * 16, p.ldw - 16);  // past N: discarded
      cp_async16(wd + r * kWgBN + cc * 16,
                 p.w + (long long)(k0 + r) * p.ldw + n);
    }
  };

  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;

  // stage s + 2 is loaded while stage s is transposed and stage s - 1's
  // products run: a slot is refilled only after the products reading it
#pragma unroll
  for (int s = 0; s < kWgS - 2; ++s) {
    if (s < nst) load_stage(st0 + s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kWgS - 3>();
    __syncthreads();  // stage s landed; the products of stage s-2 are done
    if (s + kWgS - 2 < nst)
      load_stage(st0 + s + kWgS - 2, (s + kWgS - 2) % kWgS);
    cp_async_commit();
    const int slot = s % kWgS;
    unsigned char* wts = wt + (s & 1) * kWgTile;
    // raw w (k, n) -> core layout (n, k): 4 x 4 blocks, k quads r4, n quads c4
    const unsigned char* src = wr + slot * kWgTile;
    for (int b = tid; b < (kWgBK / 4) * (kWgBN / 4); b += 256) {
      const int ln = b & 31, wb = b >> 5;
      const int c4 = (wb % (kWgBN / 32)) * 8 + (ln & 7);
      const int r4 = (wb / (kWgBN / 32)) * 4 + (ln >> 3);
      const unsigned char* sp = src + (4 * r4) * kWgBN + 4 * c4;
      unsigned c[4];
      transpose4x4(*reinterpret_cast<const unsigned*>(sp),
                   *reinterpret_cast<const unsigned*>(sp + kWgBN),
                   *reinterpret_cast<const unsigned*>(sp + 2 * kWgBN),
                   *reinterpret_cast<const unsigned*>(sp + 3 * kWgBN), c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 4 * c4 + j, k = 4 * r4;
        *reinterpret_cast<unsigned*>(
            wts + ((n >> 3) * 4 + (k >> 4)) * 128 + (n & 7) * 16 + (k & 15)) =
            c[j];
      }
    }
    // the copies and the transpose are generic-proxy writes; wgmma reads
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const unsigned char* xa = xs + slot * kWgTile + wg * (64 / 8) * 4 * 128;
    wgmma_fence_operands(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kWgBK / 32; ++kk)
      wgmma_s8_m64n128k32(d, gmma_desc(xa + kk * 256, 128, 512),
                          gmma_desc(wts + kk * 256, 128, 512));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wgmma_fence_operands(d);
  const int row = m0 + wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = row + (e >= 2 ? 8 : 0);
      const int n = n0 + 8 * j + 2 * t + (e & 1);
      if (m >= p.M || n >= p.N) continue;
      int* o = p.out + (long long)m * p.N + n;
      if (p.atomic) atomicAdd(o, d[4 * j + e]);
      else *o = d[4 * j + e];
    }
}

int launch_wgmma(const MvmParams& p, int splits, cudaStream_t stream) {
  if (p.kstage != kWgBK) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 * kWgS + 2) * kWgTile;
  cudaError_t err = cudaFuncSetAttribute(
      mvm_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.N + kWgBN - 1) / kWgBN, (p.M + kWgBM - 1) / kWgBM,
                  splits);
  mvm_wgmma<<<grid, 256, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the CUDA error code. The operands come
// laid out by kernels/acam_mvm.py mvm_operands: x (M, kp), w (kp, ldw),
// kp = n_stages * kstage, kstage a multiple of 32 (64 in exact mode), ldw
// a multiple of 16. `config` is the block tile of mvm_plan: 0 exact
// 128 x 128, 1 exact 16 x 128 (M <= 16), 2 quantize 64 x 32, 3 quantize
// 16 x 64. The K stages are split into `splits` runs of `stages_per_split`
// (splits > 1 adds into a zeroed out). quantize != 0 asks for the
// quantizing ADC with step = f32(p_max / levels), inv_step = f32(1 / step).
extern "C" int acam_mvm_launch(const void* x, const void* w, void* out,
                               int M, int N, int ldw, int kp, int kstage,
                               int config, int splits, int stages_per_split,
                               int k_real, int input_bits, int weight_bits,
                               int dac_bits, int cell_bits, int quantize,
                               float step, float inv_step, void* stream) {
  const int n_stages = kstage > 0 ? kp / kstage : 0;
  if (M <= 0 || N <= 0 || kstage <= 0 || kstage % 32 || kstage > 256 ||
      kp != n_stages * kstage || ldw % 16 || ldw < N || splits <= 0 ||
      stages_per_split <= 0 || (splits - 1) * stages_per_split >= n_stages ||
      splits * stages_per_split < n_stages || input_bits < 1 ||
      input_bits > 8 || weight_bits < 1 || weight_bits > 8 || dac_bits < 1 ||
      dac_bits > 8 || cell_bits < 1 || cell_bits > 8 || config < 0 ||
      config > 3 || (config >= 2) != (quantize != 0))
    return (int)cudaErrorInvalidValue;
  MvmParams p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.out = static_cast<int*>(out);
  p.M = M; p.N = N; p.ldw = ldw; p.kp = kp; p.kstage = kstage;
  p.n_stages = n_stages; p.stages_per_split = stages_per_split;
  p.atomic = splits > 1;
  p.ox = 1 << (input_bits - 1);
  p.ow = 1 << (weight_bits - 1);
  p.dac_bits = dac_bits; p.cell_bits = cell_bits;
  p.n_in = (input_bits + dac_bits - 1) / dac_bits;
  p.n_w = (weight_bits + cell_bits - 1) / cell_bits;
  p.step = step; p.inv_step = inv_step;
  // the largest plane sum of a stage, and the ADC values after it
  const double p_max = (double)kstage * ((1 << dac_bits) - 1)
                       * ((1 << cell_bits) - 1);
  p.magic_adc = p_max + 2.0 * step < 4194304.0;
  p.k_ox_ow = (unsigned)k_real * (unsigned)p.ox * (unsigned)p.ow;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (config) {
    case 0: return launch_wgmma(p, splits, s);
    case 1: return launch<1, 4, 1, 4, 3, false>(p, splits, s);
    case 2: return launch<2, 2, 2, 2, 2, true>(p, splits, s);
    default: return launch<1, 2, 1, 4, 2, true>(p, splits, s);
  }
}
