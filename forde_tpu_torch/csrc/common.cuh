// Pieces shared by the hand-written kernels under csrc/: conversions
// between the storage types and fp32, the staging of a 64-row fp32 tile in
// shared memory, the mask contract of the fused-qkv attention kernels, and
// the error-string export every kernel library has.
//
// Each csrc/<name>.cu is compiled on its own into lib<name>.so, so the
// definitions here land once in each library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// The fused-qkv attention mask: key `kc` is visible to query row `qr` iff
// kc < kv_len (per-sample length and static bound, both folded into
// kv_len <= S), qr >= kc when causal, and qr - kc < window when window >= 0.
__device__ __forceinline__ bool visible(int qr, int kc, int kv_len,
                                        int causal, int window) {
  bool v = kc < kv_len;
  if (causal) v = v && qr >= kc;
  if (window >= 0) v = v && (qr - kc) < window;
  return v;
}

}  // namespace forde

extern "C" const char* forde_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
