// Tensor-core building blocks of the kernels under csrc/, in inline PTX (no
// CuTe): asynchronous 16-byte copies into shared memory, ldmatrix, the
// m16n8k16 bf16 product with fp32 accumulators, packing of fp32 pairs into
// bf16x2, and the XOR swizzle of 64 x D bf16 tiles that makes ldmatrix
// free of bank conflicts; for fp32, the split into TF32 pairs, the
// three-pass m16n8k8 product and the fragments of padded fp32 tiles.
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
//
// The fp32 routes take the tensor cores through mma.sync.m16n8k8 with TF32
// operands, three passes a product (mma_tf32x3): x = hi + lo, hi x
// rounded to TF32 and lo the rest (split_tf32), holds x to 2^-21 of |x|,
// and a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b, within 2^-19 of |a b| (the
// dropped lo_a lo_b is below 2^-22). Each TF32 x TF32 product is exact in
// fp32. Fragments of
// m16n8k8 (32-bit elements):
//   A (16 x 8): a[0] = (g, t), a[1] = (g + 8, t), a[2] = (g, t + 4),
//     a[3] = (g + 8, t + 4);
//   B (8 x 8, k x n): b[0] = (k t, n g), b[1] = (k t + 4, n g);
//   C: as m16n8k16's.
// ldmatrix moves 32-bit words whole, so a non-transposed ldmatrix of an
// fp32 tile gives A, and B with n along the tile's rows (load_a_f32,
// load_b_f32). An accumulator's columns 2t, 2t + 1 are not A's t, t + 4;
// but the k index of a product may be permuted when both operands take the
// same permutation, so column 2t goes to slot t and 2t + 1 to slot t + 4
// (acc_to_a_tf32), and B with k along the tile's rows is read at rows 2t
// and 2t + 1 (load_bt_f32). fp32 tiles have row pitch D + 4: every row
// starts on 16 bytes (cp.async), the 8 rows an ldmatrix matrix reads fall
// in 8 distinct 16-byte bank groups, and the scalar loads of load_bt_f32
// (rows 2t, cols g) in 32 distinct banks.

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

// x = hi + lo as the tensor cores read them, to 2^-21 of |x|, the error of
// either sign: hi is x rounded to TF32 (to nearest, ties away from 0: half
// of the unit of the 13 dropped bits added, then those bits cleared), lo =
// x - hi exactly (at most half of hi's unit), and an m16n8k8 TF32 product
// reads lo's top 19 bits. Three instructions; a NaN reaches the products
// through lo. cvt.rna.tf32 rounds hi the same way in 4-5 instructions
// (FSETP, VIADD, LOP3, SEL); rounding lo with it too took ~10 an element,
// and the issue-bound kernels 1.6-1.8x these times. Clearing hi's bits
// without rounding (two instructions) ran 7-9% faster, but its error
// always shrinks |x| (PERF.md).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(__uint_as_float(x[i]), hi[i], lo[i]);
}

// c += a * b: one 16 x 8 x 8 product of TF32, summed in fp32.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b of fp32 operands split into TF32 (hi, lo), in three passes:
// lo_a hi_b, then hi_a lo_b, then hi_a hi_b.
__device__ __forceinline__ void mma_tf32x3(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// Rows [row0, row0 + ROWS) of a D-wide fp32 slice (row stride `stride`
// elements) into a tile of row pitch D + 4, 16 bytes per thread and copy;
// rows at or past `limit` are zero. Every one of the block's NT threads
// takes part. The caller commits.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile_f32_async(float* dst, const float* src,
                                                    int row0, int limit,
                                                    long long stride) {
  constexpr int CH = D / 4;
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH;
    const int g = row0 + r;
    const bool ok = g < limit;
    cp_async_16(dst + r * (D + 4) + c * 4, ok ? src + g * stride + c * 4 : src, ok);
  }
}

// A operand (raw fp32 bits) of k-step kk of an fp32 tile of pitch D + 4:
// rows row0..row0+15, cols 8kk..8kk+7.
template <int D>
__device__ __forceinline__ void load_a_f32(uint32_t (&a)[4], const float* tile,
                                           int row0, int kk, int lane) {
  const int m = lane >> 3;
  ldmatrix_x4(a, tile + (row0 + (lane & 7) + ((m & 1) << 3)) * (D + 4) + 8 * kk +
                     ((m >> 1) << 2));
}

// B operands (raw fp32 bits) of k-step kk for two n8 tiles whose n runs
// along the tile's rows n0..n0+15 (q k^T): b[0], b[1] for rows n0..n0+7,
// b[2], b[3] for rows n0+8..n0+15.
template <int D>
__device__ __forceinline__ void load_b_f32(uint32_t (&b)[4], const float* tile,
                                           int n0, int kk, int lane) {
  const int m = lane >> 3;
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((m >> 1) << 3)) * (D + 4) + 8 * kk +
                     ((m & 1) << 2));
}

// B operand of a k8 step whose k runs along the tile's rows k0..k0+7 and n
// along its cols n0..n0+7 (p v), split into TF32, with the k permutation of
// acc_to_a_tf32: b[0] from row k0 + 2t, b[1] from row k0 + 2t + 1, col
// n0 + g.
template <int D>
__device__ __forceinline__ void load_bt_f32(uint32_t (&bh)[2], uint32_t (&bl)[2],
                                            const float* tile, int k0, int n0,
                                            int lane) {
  const float* p = tile + (k0 + 2 * (lane & 3)) * (D + 4) + n0 + (lane >> 2);
  split_tf32(p[0], bh[0], bl[0]);
  split_tf32(p[D + 4], bh[1], bl[1]);
}

// The fp32 accumulator of one n8 tile as the A operand of a k8 step over
// its 8 columns, split into TF32: column 2t to slot t, 2t + 1 to slot
// t + 4 (the B operand takes the same rows, load_bt_f32).
__device__ __forceinline__ void acc_to_a_tf32(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                              const float (&c)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// acc += a b for one step of a walk: a, 16 x 8 NJ, split into TF32 (hi,
// lo) as it stands in the accumulators, times rows 0 .. 8 NJ - 1 of
// `tile` (fp32, pitch D + 4, k along its rows, read by load_bt_f32). Each
// n8 tile is summed in a fresh accumulator and then added to acc on the
// CUDA cores, rounded to nearest. The tensor cores' fp32 accumulation does
// not round to nearest: chained across every step of a walk (the 4-D
// backward's dk and dv sum over up to S queries, its dq and the forward's
// o over up to S keys), its error grew with the walk's length in one
// direction (PERF.md).
template <int D, int NJ>
__device__ __forceinline__ void mma_step_tf32x3(float (&acc)[D / 8][4],
                                                const uint32_t (&hi)[NJ][4],
                                                const uint32_t (&lo)[NJ][4],
                                                const float* tile, int lane) {
#pragma unroll
  for (int np = 0; np < D / 8; ++np) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
      uint32_t bh[2], bl[2];
      load_bt_f32<D>(bh, bl, tile, 8 * kk, 8 * np, lane);
      mma_tf32x3(part, hi[kk], lo[kk], bh[0], bh[1], bl[0], bl[1]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[np][e] += part[e];
  }
}

// A warp's 16 x D fp32 accumulator, rows scaled by s0 (row g) and s1 (row
// g + 8), to global rows r0 and r0 + 8 of dst (row stride `stride`
// elements) in 8-byte stores; rows at or past `limit` are not written.
template <int D>
__device__ __forceinline__ void store_rows_f32(float* dst, long long stride,
                                               const float (&acc)[D / 8][4],
                                               int r0, int limit, float s0,
                                               float s1, int lane) {
  const int t = lane & 3;
  float* const row0 = dst + r0 * stride + 2 * t;
  float* const row1 = row0 + 8 * stride;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < limit)
      *reinterpret_cast<float2*>(row0 + 8 * j) = make_float2(acc[j][0] * s0, acc[j][1] * s0);
    if (r0 + 8 < limit)
      *reinterpret_cast<float2*>(row1 + 8 * j) = make_float2(acc[j][2] * s1, acc[j][3] * s1);
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
