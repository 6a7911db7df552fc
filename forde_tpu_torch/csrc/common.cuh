// Pieces shared by the hand-written kernels under csrc/: conversions
// between the storage types and fp32, the staging of a 64-row fp32 tile in
// shared memory, the mask contracts of the flash and the small-KV kernels,
// the key-tile walk of the 4-D flash kernels, the tile products of the
// attention backward kernels, and the error-string export every kernel
// library has.
//
// Each csrc/<name>.cu is compiled on its own into lib<name>.so, so the
// definitions here land once in each library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace forde {

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// An fp32 value rounded through T and widened back: the TPU kernels'
// `.astype(dtype)` of an fp32 intermediate.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float<T>(from_float<T>(x));
}

// Rows [0, 64) of a tile from a strided (row stride `stride`) D-wide slice
// into fp32 shared memory with row pitch D + 1; rows at or past `limit`
// are zero. Every one of the block's NT threads takes part (NT a
// compile-time constant, so the loop's trip count is known).
template <typename T, int D, int NT>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int limit, long long stride) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int g = row0 + r;
    dst[r * (D + 1) + d] = g < limit ? to_float(src[g * stride + d]) : 0.f;
  }
}

// a / b rounded towards -inf (b > 0), as jnp.floor_divide: the interior
// bounds of a tile walk divide quantities that may be negative.
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

// The attention mask of the flash kernels: key `kc` is visible to query row
// `qr` iff kc < kv_len (per-sample length and static bound, both folded
// into kv_len <= S), qr >= kc when causal, and qr - kc < window when
// window >= 0.
__device__ __forceinline__ bool visible(int qr, int kc, int kv_len,
                                        int causal, int window) {
  bool v = kc < kv_len;
  if (causal) v = v && qr >= kc;
  if (window >= 0) v = v && (qr - kc) < window;
  return v;
}

// Keys per tile of the 4-D flash kernels (flash_fwd.cu, flash_bwd.cu).
constexpr int FLASH_BK = 64;

// Key tiles [j_begin, j_end) hold every key some row of the block of `rows`
// query rows at q0 may see (`_loop_bounds` of
// forde_tpu/ops/flash_attention.py); at least one, as on the TPU. The
// forward and the dq kernel walk them.
__device__ __forceinline__ void key_tiles(int q0, int rows, int S, int causal,
                                          int window, int kv_len,
                                          int& j_begin, int& j_end) {
  j_end = kv_len >= 0 ? (kv_len + FLASH_BK - 1) / FLASH_BK : S / FLASH_BK;
  if (causal) j_end = min(j_end, (q0 + rows - 1) / FLASH_BK + 1);
  j_begin = window >= 0 ? max(0, q0 - window + 1) / FLASH_BK : 0;
  if (j_end <= j_begin) j_end = j_begin + 1;
}

// `_loop_bounds`' interior split: of the walked tiles [j_begin, j_end),
// those in [fs, fe) have every (row, key) pair of rows [r0, r0 + rows)
// visible, so they need no mask.
__device__ __forceinline__ void interior_tiles(int r0, int rows, int j_begin,
                                               int j_end, int causal,
                                               int window, int kv_len,
                                               int& fs, int& fe) {
  fs = j_begin;
  fe = j_end;
  if (window >= 0) fs = max(fs, -floor_div(window - r0 - rows, FLASH_BK));
  if (causal) fe = min(fe, floor_div(r0 - FLASH_BK + 1, FLASH_BK) + 1);
  if (kv_len >= 0) fe = min(fe, kv_len / FLASH_BK);
  fs = min(max(fs, j_begin), j_end);
  fe = min(max(fe, fs), j_end);
}

// The mask contract of the small-KV kernels (TPU kernels of
// forde_tpu/ops/nsa_attention.py): key c (threshold kpos) is visible to
// query position p iff p >= kpos; a threshold >= 2^30, or a column c past
// the K real keys, marks a padding key.
constexpr int SKV_INVALID_KEY_POS = 1 << 30;
constexpr float SKV_NEG_BIG = -1e9f;

__device__ __forceinline__ bool skv_visible(int p, int c, int K, int kpos) {
  return c < K && kpos < SKV_INVALID_KEY_POS && p >= kpos;
}

// A score x where the key is visible; SKV_NEG_BIG, NOT -inf, where it is
// masked (a query with no visible key gets the uniform distribution over
// the real keys: its max is SKV_NEG_BIG and every masked key weighs
// 2^0 = 1); -inf for a padding key, outside even that. The kernels keep x
// in log2 units and the constants as they are, so the quirk survives.
__device__ __forceinline__ float skv_score(float x, int p, int c, int K, int kpos) {
  if (c >= K || kpos >= SKV_INVALID_KEY_POS) return -INFINITY;
  return p >= kpos ? x : SKV_NEG_BIG;
}

// The backward kernels' tile arithmetic, on a 16 x 16 thread grid (tx, ty)
// over 64 x 64 tiles held as fp32 in shared memory with row pitch D + 1.

// out[i][j] = sum_d a[row ty + 16i][d] * b[row tx + 16j][d].
template <int D>
__device__ __forceinline__ void tile_dot(float out[4][4], const float* a,
                                         const float* b, int tx, int ty) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(av[i], bv[j], out[i][j]);
  }
}

// acc[i][j] += sum_c p(ty + 16i, c) * m[row c][col tx + 16j] for c < 64,
// where p(r, c) = p_s[r * RS + c * CS]: (RS, CS) = (65, 1) reads a 64 x 64
// tile of pitch 65 as it is, (1, 65) reads its transpose.
template <int D, int RS, int CS>
__device__ __forceinline__ void tile_mac(float acc[4][D / 16], const float* p_s,
                                         const float* m, int tx, int ty) {
  constexpr int LD = D + 1;
#pragma unroll 4
  for (int c = 0; c < 64; ++c) {
    float pv[4], mv[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * RS + c * CS];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) mv[j] = m[c * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(pv[i], mv[j], acc[i][j]);
  }
}

// p of rows q0 + ty + 16i, keys k0 + tx + 16j from the scores of q_s and
// k_s: exp(s * scale - lse) where visible, else SELECTED to 0 (a row with
// no visible key has lse = -1e30, and exp() is inf on its masked keys).
template <int D>
__device__ __forceinline__ void probs(float p[4][4], const float* q_s,
                                      const float* k_s, const float* lse_s,
                                      int q0, int k0, int S, int kv_len,
                                      int causal, int window, float scale,
                                      int tx, int ty) {
  tile_dot<D>(p, q_s, k_s, tx, ty);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qr = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kc = k0 + tx + 16 * j;
      const bool vis = qr < S && visible(qr, kc, kv_len, causal, window);
      p[i][j] = vis ? expf(p[i][j] * scale - lse_s[r]) : 0.f;
    }
  }
}

}  // namespace forde

extern "C" const char* forde_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
