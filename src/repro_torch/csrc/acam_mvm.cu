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
// not from bk, and it is applied per bk-row tile, as the Pallas kernel does:
// with bk != cfg.rows the quantize mode follows the kernel, not the
// core.crossbar oracle. The reference's jitted p / step is a multiply by
// the float32 reciprocal of float32(step), which the wrapper passes in.
//
// Integer sums are exact; acc is unsigned, so every intermediate wraps as
// the reference's int32 does and the result equals it bit for bit.
//
// What bounds it on an H100: operations. An (M, K) x (K, N) call is 2MNK
// int8 operations, 32 times that in quantize mode at the default slicing
// (8 input slices x 4 weight slices, each plane product counted). This
// first design computes them with __dp4a on CUDA cores (about 1/15 of the
// int8 tensor-core rate): one block per 64 x 64 output tile walks the K
// tiles, stages the tile's offset-encoded bytes in shared memory (w
// transposed, so four consecutive k form one word), and extracts each bit
// plane of four codes at once with a shift and a per-byte mask. Tensor-core
// products (mma.sync / wgmma on u8) of the planes are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

struct MvmParams {
  const int8_t* x;
  const int8_t* w;
  int* out;
  int M, N, K, bk;
  int ox, ow;              // input / weight offsets
  int dac_bits, cell_bits;
  int n_in, n_w;           // input / weight slices
  int quantize;
  float step, inv_step;
  unsigned k_ox_ow;        // K * ox * ow, modulo 2^32
};

__global__ void __launch_bounds__(kThreads) mvm_kernel(MvmParams p) {
  extern __shared__ uint32_t smem[];
  const int wpr = p.bk / 4 + 1;  // words per staged row (one word of skew)
  uint32_t* xs = smem;           // kBM rows of xu bytes
  uint32_t* ws = smem + kBM * wpr;  // kBN rows (columns of w) of wu bytes
  uint8_t* xb = reinterpret_cast<uint8_t*>(xs);
  uint8_t* wb = reinterpret_cast<uint8_t*>(ws);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  const int n_t = p.quantize ? p.n_in : 1;
  const int n_s = p.quantize ? p.n_w : 1;
  const uint32_t dmask = p.quantize ? (1u << p.dac_bits) - 1u : 0xffu;
  const uint32_t cmask = p.quantize ? (1u << p.cell_bits) - 1u : 0xffu;

  uint32_t acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0u;

  for (int k0 = 0; k0 < p.K; k0 += p.bk) {
    __syncthreads();  // the previous tile's words are read
    for (int idx = tid; idx < kBM * p.bk; idx += kThreads) {
      const int r = idx / p.bk, kk = idx % p.bk;
      const int m = m0 + r, k = k0 + kk;
      xb[r * wpr * 4 + kk] =
          (m < p.M && k < p.K) ? (uint8_t)(p.x[(long long)m * p.K + k] + p.ox)
                               : (uint8_t)0;
    }
    for (int idx = tid; idx < kBN * p.bk; idx += kThreads) {
      const int kk = idx / kBN, c = idx % kBN;
      const int n = n0 + c, k = k0 + kk;
      wb[c * wpr * 4 + kk] =
          (n < p.N && k < p.K) ? (uint8_t)(p.w[(long long)k * p.N + n] + p.ow)
                               : (uint8_t)0;
    }
    __syncthreads();

    const int nk4 = p.bk / 4;
    for (int t = 0; t < n_t; ++t) {
      const int xsh = t * p.dac_bits;
      const uint32_t xm = (dmask & (0xffu >> xsh)) * 0x01010101u;
      for (int s = 0; s < n_s; ++s) {
        const int wsh = s * p.cell_bits;
        const uint32_t wm = (cmask & (0xffu >> wsh)) * 0x01010101u;
        uint32_t pp[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) pp[i][j] = 0u;
        for (int k4 = 0; k4 < nk4; ++k4) {
          uint32_t a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[i] = (xs[(ty + 16 * i) * wpr + k4] >> xsh) & xm;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            b[j] = (ws[(tx + 16 * j) * wpr + k4] >> wsh) & wm;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              pp[i][j] = __dp4a(a[i], b[j], pp[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t q = pp[i][j];
            if (p.quantize) {
              const float r = rintf(__fmul_rn((float)q, p.inv_step));
              q = (uint32_t)__float2int_rn(rintf(__fmul_rn(r, p.step)));
            }
            acc[i][j] += q << (xsh + wsh);
          }
      }
    }
    // offset corrections of this tile: rowsum of xu, colsum of wu
    uint32_t rs[4] = {0u, 0u, 0u, 0u}, cs[4] = {0u, 0u, 0u, 0u};
    for (int k4 = 0; k4 < nk4; ++k4) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rs[i] = __dp4a(xs[(ty + 16 * i) * wpr + k4], 0x01010101u, rs[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cs[j] = __dp4a(ws[(tx + 16 * j) * wpr + k4], 0x01010101u, cs[j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] -= (uint32_t)p.ow * rs[i] + (uint32_t)p.ox * cs[j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < p.N)
        p.out[(long long)m * p.N + n] = (int)(acc[i][j] + p.k_ox_ow);
    }
  }
}

}  // namespace

// Launches on `stream` and returns the CUDA error code. quantize != 0 asks
// for the quantizing ADC (the wrapper decides: adc_mode "quantize" and
// p_max > levels), with step = f32(p_max / levels) and inv_step = f32(1 /
// step). Takes input_bits and weight_bits <= 8 and bk a multiple of 4 up
// to 256.
extern "C" int acam_mvm_launch(const void* x, const void* w, void* out,
                               int M, int N, int K, int bk, int input_bits,
                               int weight_bits, int dac_bits, int cell_bits,
                               int quantize, float step, float inv_step,
                               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bk < 4 || bk > 256 || bk % 4 != 0 ||
      input_bits < 1 || input_bits > 8 || weight_bits < 1 ||
      weight_bits > 8 || dac_bits < 1 || dac_bits > 8 || cell_bits < 1 ||
      cell_bits > 8)
    return (int)cudaErrorInvalidValue;
  MvmParams p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.out = static_cast<int*>(out);
  p.M = M; p.N = N; p.K = K; p.bk = bk;
  p.ox = 1 << (input_bits - 1);
  p.ow = 1 << (weight_bits - 1);
  p.dac_bits = dac_bits; p.cell_bits = cell_bits;
  p.n_in = (input_bits + dac_bits - 1) / dac_bits;
  p.n_w = (weight_bits + cell_bits - 1) / cell_bits;
  p.quantize = quantize;
  p.step = step; p.inv_step = inv_step;
  p.k_ox_ow = (unsigned)K * (unsigned)p.ox * (unsigned)p.ow;
  const size_t smem = (size_t)(kBM + kBN) * (bk / 4 + 1) * sizeof(uint32_t);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  mvm_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
