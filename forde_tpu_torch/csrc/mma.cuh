// Tensor-core building blocks of the bf16 kernels under csrc/, in inline
// PTX (no CuTe): asynchronous 16-byte copies into shared memory, ldmatrix,
// the m16n8k16 bf16 product with fp32 accumulators, packing of fp32 pairs
// into bf16x2, and the XOR swizzle of 64 x D bf16 tiles that makes ldmatrix
// free of bank conflicts.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), which the kernels rely on:
//   A (16 x 16, row-major), 4 registers of 2 bf16: a[0] = (g, 2t..2t+1),
//     a[1] = (g + 8, 2t..), a[2] = (g, 2t + 8..), a[3] = (g + 8, 2t + 8..);
//   B (16 x 8, k x n), 2 registers: b[0] = (k 2t..2t+1, n g),
//     b[1] = (k 2t + 8.., n g);
//   C (16 x 8 fp32), 4 floats: c[0..1] = (g, 2t..2t+1), c[2..3] = (g + 8,
//     2t..).
// So the accumulators of two neighbouring n8 tiles j = 2kk and 2kk + 1,
// rounded to bf16 in pairs, are the A operand of k-step kk of the next
// product: (c[0], c[1]) of tile 2kk -> a[0], (c[2], c[3]) -> a[1], those of
// tile 2kk + 1 -> a[2], a[3]. A softmax's p never leaves the registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace forde {
namespace mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, past L1. With valid == false the
// 16 bytes are zero-filled and src is not read.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes (one fp32), zero-filled when !valid.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and r[i] receives (row g, cols 2t..2t+1) of it.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// The same, each matrix transposed: r[i] receives (rows 2t..2t+1, col g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a * b: one 16 x 8 x 16 product of bf16, summed in fp32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to nearest bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Element offset of (row, 16-byte chunk) in a row-major bf16 tile of width
// D: the chunk index is XORed with row % 8, so the 8 rows that one ldmatrix
// matrix reads (or one cp.async pass writes) fall in 8 distinct bank groups.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

// Rows [row0, row0 + 64) of a D-wide slice (row stride `stride` elements)
// into a swizzled tile, 16 bytes per thread and copy; rows at or past
// `limit` are zero. Every one of the block's NT threads takes part. The
// caller commits.
template <int D, int NT>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int row0, int limit,
                                                long long stride) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int idx = threadIdx.x; idx < 64 * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH;
    const int g = row0 + r;
    const bool ok = g < limit;
    cp_async_16(dst + swz<D>(r, c), ok ? src + g * stride + c * 8 : src, ok);
  }
}

// A operand of k-step kk: rows row0..row0+15, cols 16kk..16kk+15.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int row0, int kk, int lane) {
  ldmatrix_x4(a, tile + swz<D>(row0 + (lane & 15), 2 * kk + (lane >> 4)));
}

// B operands of k-step kk for two n8 tiles whose n runs along the tile's
// rows n0..n0+15 (a product with the tile transposed, e.g. q k^T): b[0],
// b[1] for rows n0..n0+7, b[2], b[3] for rows n0+8..n0+15.
template <int D>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile,
                                       int n0, int kk, int lane) {
  ldmatrix_x4(b, tile + swz<D>(n0 + (lane & 7) + ((lane >> 4) << 3),
                               2 * kk + ((lane >> 3) & 1)));
}

// B operands for k along the tile's rows k0..k0+15 and n along its cols
// (a product with the tile as it is, e.g. p v): b[0], b[1] for cols
// 16np..16np+7, b[2], b[3] for cols 16np+8..16np+15.
template <int D>
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* tile,
                                        int k0, int np, int lane) {
  ldmatrix_x4_trans(b, tile + swz<D>(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                     2 * np + (lane >> 4)));
}

// A warp's 16 x D fp32 accumulator (n8 tile j = cols 8j..8j+7), rows
// scaled by s0 (row g) and s1 (row g + 8) and rounded to bf16, into rows
// row0..row0+15 of a swizzled tile.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* tile, const float (&acc)[D / 8][4],
                                           int row0, float s0, float s1,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(tile + swz<D>(row0 + g, j) + 2 * t) =
        pack_bf16x2(acc[j][0] * s0, acc[j][1] * s0);
    *reinterpret_cast<uint32_t*>(tile + swz<D>(row0 + g + 8, j) + 2 * t) =
        pack_bf16x2(acc[j][2] * s1, acc[j][3] * s1);
  }
}

// Rows row0..row0+15 of a swizzled tile to global rows grow0..grow0+15 of
// dst (row stride `stride` elements), 16 bytes per store; rows at or past
// `limit` are not written. One warp.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long stride,
                                           const bf16* tile, int row0,
                                           int grow0, int limit, int lane) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c = idx % CH;
    if (grow0 + r < limit)
      *reinterpret_cast<uint4*>(dst + (grow0 + r) * stride + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz<D>(row0 + r, c));
  }
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 2^x on the special-function unit (ex2.approx.ftz: relative error below
// 2^-22, 2^-inf = 0, +inf for x past 128).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Max and sum over the 4 lanes (t = 0..3) that share an accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace mma
}  // namespace forde
