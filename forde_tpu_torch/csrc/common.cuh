// Pieces shared by the hand-written kernels under csrc/: conversions
// between the storage types and fp32, the mask contracts of the flash and
// the small-KV kernels, the key-tile walk of the 4-D flash kernels, and
// the error-string export every kernel library has.
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

}  // namespace forde

extern "C" const char* forde_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
