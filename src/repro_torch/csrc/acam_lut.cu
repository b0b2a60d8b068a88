// Compute-ACAM one-variable op as a table gather over int codes, for sm_90a:
// out[i] = lut[x[i] + bias], int8 or int32 codes in, int32 codes out.
//
// Replaces the TPU kernel src/repro/kernels/acam_lut.py::_lut_kernel (its
// (block_rows x 128)-tiled grid over a VMEM-resident table). The tile shape
// there only matches the TPU's lanes; the function is elementwise, so here
// the codes are one flat array and every thread maps four of them.
//
// The table (2^n int32 entries, 256 for the 8-bit ops) is copied into shared
// memory by every block before its first gather. An index outside the table
// is clamped to it: codes of the op's input format never are, and the clamp
// keeps a stray code from reading past the table.
//
// What bounds it on an H100: bytes. Each code is read once (1 or 4 bytes)
// and its output written once (4 bytes), against one shared-memory gather;
// at 3.35 TB/s a (512, 5120) int8 call moves 13 MB in about 3.9 us. The
// design keeps the loads and stores wide (4 codes a thread: a 4-byte or
// 16-byte load, one 16-byte store) and coalesced; the ragged tail, and
// operands that are not 16-byte aligned, take a scalar loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int gather(const int* s_lut, int n_lut, int code,
                                      int bias) {
  const int i = min(max(code + bias, 0), n_lut - 1);
  return s_lut[i];
}

template <typename T, typename T4>
__global__ void __launch_bounds__(kThreads)
lut_kernel(const T* __restrict__ x, const int* __restrict__ lut, int n_lut,
           int bias, int* __restrict__ out, long long n, int vec) {
  extern __shared__ int s_lut[];
  for (int i = threadIdx.x; i < n_lut; i += blockDim.x) s_lut[i] = lut[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    const T4* x4 = reinterpret_cast<const T4*>(x);
    int4* out4 = reinterpret_cast<int4*>(out);
    for (long long i = start; i < n4; i += stride) {
      const T4 c = x4[i];
      out4[i] = make_int4(gather(s_lut, n_lut, (int)c.x, bias),
                          gather(s_lut, n_lut, (int)c.y, bias),
                          gather(s_lut, n_lut, (int)c.z, bias),
                          gather(s_lut, n_lut, (int)c.w, bias));
    }
    done = n4 * 4;
  }
  for (long long i = done + start; i < n; i += stride)
    out[i] = gather(s_lut, n_lut, (int)x[i], bias);
}

}  // namespace

// x: n codes (int8 when x_is_int8, else int32); lut: n_lut int32 entries;
// out: n int32. Launches on `stream` and returns the CUDA error code.
extern "C" int acam_lut_launch(const void* x, int x_is_int8, const void* lut,
                               int n_lut, int bias, void* out, long long n,
                               void* stream) {
  if (n < 0 || n_lut <= 0 || n_lut > 16384) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  const int vec = (oa % 16 == 0) && (xa % (x_is_int8 ? 4 : 16) == 0);
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 per SM
  const size_t smem = (size_t)n_lut * sizeof(int);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(lut);
  int* o = static_cast<int*>(out);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        x_is_int8 ? (const void*)lut_kernel<int8_t, char4>
                  : (const void*)lut_kernel<int, int4>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (x_is_int8)
    lut_kernel<int8_t, char4><<<(int)blocks, kThreads, smem, s>>>(
        static_cast<const int8_t*>(x), l, n_lut, bias, o, n, vec);
  else
    lut_kernel<int, int4><<<(int)blocks, kThreads, smem, s>>>(
        static_cast<const int*>(x), l, n_lut, bias, o, n, vec);
  return (int)cudaGetLastError();
}
