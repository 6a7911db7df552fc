// One-pass per-column moment sums for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of forde_tpu/ops/stat_sums.py (launched
// by `moment_sums` through `pl.pallas_call`). FORDE's sensing reduces every
// StatefulLayer's pre-activation z (N = B*S rows, F neurons) in the forward
// and its gradient dL/dz in the backward of a sensed step to these sums.
//
// What it computes: out (3, F) fp32 = (sum_n |x[n, f]|, sum_n x[n, f]^2,
// sum_n x[n, f]), each value widened to fp32 before the abs and the square
// and summed in fp32, as the TPU kernel does.
//
// Bound on the H100: three adds per element against the 2 or 4 bytes read,
// so bytes bound it. The vision z of ViT-B at batch 128 (25,600 x 3,072
// bf16) is 157 MB: ~47 us at 3.35 TB/s; the text z (8,192 x 2,048 bf16)
// 34 MB: ~10 us.
//
// Design: x is read once. Pass 1: a block of 256 threads owns 256 adjacent
// columns of one chunk of rows; each thread walks its column down the chunk
// (a warp reads 32 adjacent values of a row, whole 32-byte sectors) and
// writes its three partial sums to an fp32 scratch (chunks, 3, F). The
// wrapper picks the chunk count so that the grid holds several blocks per
// SM. Pass 2 sums the chunks of each of the 3F outputs in a fixed order: no
// atomics, the result is deterministic. Any N works: the last chunk is
// short.

#include "common.cuh"

namespace {

using forde::to_float;

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
moment_partial_kernel(const T* __restrict__ x, float* __restrict__ part,
                      long long n, int f, long long rows_per_chunk) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= f) return;
  const long long r0 = blockIdx.y * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);
  float l1 = 0.f, sq = 0.f, sm = 0.f;
  const T* p = x + r0 * f + col;
#pragma unroll 8
  for (long long r = r0; r < r1; ++r, p += f) {
    const float v = to_float(*p);
    l1 += fabsf(v);
    sq = fmaf(v, v, sq);
    sm += v;
  }
  float* out = part + (long long)blockIdx.y * 3 * f + col;
  out[0] = l1;
  out[f] = sq;
  out[2 * f] = sm;
}

__global__ void __launch_bounds__(THREADS)
moment_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                     int chunks, int f) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= 3 * f) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += part[(long long)c * 3 * f + idx];
  out[idx] = s;
}

template <typename T>
cudaError_t launch(const void* x, void* part, void* out, long long n, int f,
                   int chunks, long long rows_per_chunk, cudaStream_t stream) {
  const dim3 grid((f + THREADS - 1) / THREADS, chunks);
  moment_partial_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(part), n, f,
      rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moment_reduce_kernel<<<(3 * f + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), chunks, f);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, f) row-major, dtype 0 = float32, 1 = bfloat16; part an fp32 scratch
// of (chunks, 3, f) with chunks * rows_per_chunk >= n; out (3, f) fp32.
// Returns the CUDA error code of the launches (0 on success).
int forde_moment_sums(const void* x, void* part, void* out, long long n, int f,
                      int dtype, int chunks, long long rows_per_chunk,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, part, out, n, f, chunks, rows_per_chunk, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, part, out, n, f, chunks, rows_per_chunk,
                                 st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
