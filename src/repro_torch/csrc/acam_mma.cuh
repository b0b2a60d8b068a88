// Hopper building blocks shared by the crossbar MVM (acam_mvm.cu) and the
// attention kernels (acam_attention.cu, acam_attention_single.cu): 16-byte
// asynchronous copies into shared memory, the int8 tensor-core product
// mma.sync m16n8k32, and the 4 x 4 byte transpose that turns N-contiguous
// int8 rows into the K-contiguous operand the tensor cores take.
//
// m16n8k32 fragments (g = lane / 4, t = lane % 4), one 32-bit register =
// 4 consecutive k bytes:
//   A (16 x 32, row-major):  a0 row g, k 4t..4t+3; a1 row g+8; a2 row g,
//                            k +16; a3 row g+8, k +16
//   B (32 x 8, column-major): b0 column g, k 4t..4t+3; b1 k +16
//   C (16 x 8):               c0, c1 row g, columns 2t, 2t+1; c2, c3 row g+8
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace acam {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// d += a . b on signed int8 codes, int32 sums (wrapping)
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b with both fragments read from shared memory: A's row g at a
// (row g + 8 a pitch of `pitch` bytes below), B's column g at b
__device__ __forceinline__ void mma_s8_smem(int (&d)[4],
                                            const unsigned char* a, int pitch,
                                            const unsigned char* b) {
  const unsigned af[4] = {
      *reinterpret_cast<const unsigned*>(a),
      *reinterpret_cast<const unsigned*>(a + 8 * pitch),
      *reinterpret_cast<const unsigned*>(a + 16),
      *reinterpret_cast<const unsigned*>(a + 8 * pitch + 16)};
  const unsigned bf[2] = {*reinterpret_cast<const unsigned*>(b),
                          *reinterpret_cast<const unsigned*>(b + 16)};
  mma_s8(d, af, bf);
}

// d += a . b on unsigned int8 values (bit planes), int32 sums
__device__ __forceinline__ void mma_u8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// r[i] holds bytes (row i, columns 0..3); c[j] gets bytes (rows 0..3,
// column j): a 4 x 4 byte transpose in six permutes
__device__ __forceinline__ void transpose4x4(unsigned r0, unsigned r1,
                                             unsigned r2, unsigned r3,
                                             unsigned (&c)[4]) {
  const unsigned t0 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const unsigned t1 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const unsigned u0 = __byte_perm(r2, r3, 0x5140);
  const unsigned u1 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, u0, 0x5410);
  c[1] = __byte_perm(t0, u0, 0x7632);
  c[2] = __byte_perm(t1, u1, 0x5410);
  c[3] = __byte_perm(t1, u1, 0x7632);
}

// Transpose a (rows x cols) int8 tile, row stride `src_stride` bytes, into
// (cols x rows) with row stride `dst_stride` bytes, adding `add4`'s bytes
// to every byte (modulo 256) on the way; rows a multiple of 4, cols of 32.
// A warp takes 8 column quads x 4 row quads: 4-way bank conflicts at most
// on both sides.
__device__ __forceinline__ void transpose_tile(unsigned char* dst,
                                               int dst_stride,
                                               const unsigned char* src,
                                               int src_stride, int rows,
                                               int cols, int tid, int nth,
                                               unsigned add4 = 0u) {
  const int cq = cols / 4, rq = rows / 4, cgroups = cq / 8;
  const int total = ((rq + 3) / 4) * 4 * cq;
  for (int b = tid; b < total; b += nth) {
    const int lane = b & 31, wb = b >> 5;
    const int c4 = (wb % cgroups) * 8 + (lane & 7);
    const int r4 = (wb / cgroups) * 4 + (lane >> 3);
    if (r4 >= rq) continue;
    const unsigned char* s = src + (4 * r4) * src_stride + 4 * c4;
    unsigned c[4];
    transpose4x4(*reinterpret_cast<const unsigned*>(s),
                 *reinterpret_cast<const unsigned*>(s + src_stride),
                 *reinterpret_cast<const unsigned*>(s + 2 * src_stride),
                 *reinterpret_cast<const unsigned*>(s + 3 * src_stride), c);
    unsigned char* d = dst + (4 * c4) * dst_stride + 4 * r4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<unsigned*>(d + j * dst_stride) =
          add4 ? __vadd4(c[j], add4) : c[j];
  }
}

// rows x bytes from src (row stride ss bytes) into shared memory (row
// stride ds): cp.async in 16- or 4-byte pieces where every address allows,
// else plain byte copies
__device__ __forceinline__ void stage_rows(unsigned char* dst, int ds,
                                           const int8_t* src, long long ss,
                                           int rows, int bytes) {
  const long long al = (long long)reinterpret_cast<uintptr_t>(src) | ss |
                       bytes | ds;
  if ((al & 15) == 0) {
    const int n = bytes / 16;
    for (int c = threadIdx.x; c < rows * n; c += blockDim.x)
      cp_async16(dst + (c / n) * ds + 16 * (c % n),
                 src + (c / n) * ss + 16 * (c % n));
  } else if ((al & 3) == 0) {
    const int n = bytes / 4;
    for (int c = threadIdx.x; c < rows * n; c += blockDim.x)
      cp_async4(dst + (c / n) * ds + 4 * (c % n),
                src + (c / n) * ss + 4 * (c % n));
  } else {
    for (int c = threadIdx.x; c < rows * bytes; c += blockDim.x)
      dst[(c / bytes) * ds + c % bytes] =
          (unsigned char)src[(c / bytes) * ss + c % bytes];
  }
}

// 16-row tiles of a block's rows over its kW warps (4 or 8): one tile
// takes all (each warp takes every kW-th key or output tile), two take
// half each, three or four a quarter each
template <int kW>
__device__ __forceinline__ int warps_per_row_tile(int nr) {
  const int nrt = (nr + 15) / 16;
  return kW / (nrt == 1 ? 1 : (nrt == 2 ? 2 : 4));
}

}  // namespace acam
