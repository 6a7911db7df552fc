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
// Design: x is read once, 16 bytes a load. Pass 1: a block of 8 warps owns
// one column group (the 512 bytes of a row that one warp reads: 8 bf16 or
// 4 fp32 columns a thread) of one chunk of rows. Its warps walk interleaved
// rows of the chunk (warp w takes rows w, w + 8, ...), each thread with 4
// independent 16-byte loads in flight, and sum in row order. The 8 warps'
// sums then meet in shared memory (padded by one float in 32, so neither
// the writes nor the reads conflict) and are added in warp order, and the
// block writes its three partial sums to an fp32 scratch (chunks, 3, F).
// The wrapper sizes the grid for about two blocks on each of the 132 SMs
// (`chunking`, in ops/stat_sums.py), with chunks a multiple of the 32 rows
// a block loads at once: 32 chunks of the text z, 22 of the vision z,
// 0.8 MB of partials. Pass 2
// sums the chunks of each of the 3F outputs in chunk order. No atomics:
// the result is the same bit for bit from call to call. Any N works (the
// last chunk is short). An F that is not a multiple of the vector width
// leaves rows off a 16-byte boundary: that F takes the same walk with
// scalar loads, and the columns past F of the last group are not read.
// The wrapper refuses an x whose base is off a 16-byte boundary.
//
// Registers (ptxas): 60 (bf16) and 38 (fp32) with 16-byte loads, 63 and 31
// with scalar loads; no spills (a batch of 8 rows a load spilled in the
// fp32 route and was no faster in bf16). What bounds it now (chip_smoke.py,
// NVIDIA H100 80GB HBM3, 700.00 W, device time): the vision z 0.059 ms
// (0.073 with the earlier 2-byte loads), 1.26x its bound, 80% of the HBM
// rate; the text z 0.018 ms (0.023 before), 1.8x its bound. The text z is
// a short call: what holds it from its bound (the second launch, the ramp
// of its 256 blocks) is not measured yet.

#include <stdint.h>

#include "common.cuh"

namespace {

using forde::to_float;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;  // rows a warp loads at once

// 16 bytes of x widened to fp32: 8 bf16 (exact: a bf16 is the high half of
// an fp32) or 4 fp32.
__device__ __forceinline__ void widen(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void widen(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// VECTOR: F is a multiple of the vector width, so every row of a thread's
// columns starts on a 16-byte boundary; else each value is loaded alone.
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
moment_partial_kernel(const T* __restrict__ x, float* __restrict__ part,
                      long long n, int f, long long rows_per_chunk) {
  constexpr int V = 16 / sizeof(T);  // columns a thread
  constexpr int CB = 32 * V;         // columns a block
  constexpr int PITCH = CB + CB / 32;
  __shared__ float red[WARPS][3][PITCH];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cb0 = blockIdx.x * CB;
  const int c0 = cb0 + lane * V;  // this thread's first column
  const long long r0 = blockIdx.y * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);

  float l1[V], sq[V], sm[V];
#pragma unroll
  for (int v = 0; v < V; ++v) l1[v] = sq[v] = sm[v] = 0.f;
  auto add = [&](const float (&a)[V]) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      l1[v] += fabsf(a[v]);
      sq[v] = fmaf(a[v], a[v], sq[v]);
      sm[v] += a[v];
    }
  };

  if (c0 < f) {
    for (long long r = r0 + warp; r < r1; r += WARPS * UNROLL) {
      // UNROLL rows r, r + 8, ... of this warp; rows at or past r1 read as
      // zeros, which leave the sums as they are.
      if constexpr (VECTOR) {
        uint4 raw[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const long long row = r + u * WARPS;
          raw[u] = row < r1
                       ? *reinterpret_cast<const uint4*>(x + row * f + c0)
                       : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          float a[V];
          widen(raw[u], a);
          add(a);
        }
      } else {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const long long row = r + u * WARPS;
          float a[V];
#pragma unroll
          for (int v = 0; v < V; ++v)
            a[v] = row < r1 && c0 + v < f ? to_float(x[row * f + c0 + v]) : 0.f;
          add(a);
        }
      }
    }
  }

  // Column c of the group sits at c + c / 32 of a warp's row of red.
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = lane * V + v;
    red[warp][0][c + c / 32] = l1[v];
    red[warp][1][c + c / 32] = sq[v];
    red[warp][2][c + c / 32] = sm[v];
  }
  __syncthreads();
  float* out = part + (long long)blockIdx.y * 3 * f;
  for (int idx = threadIdx.x; idx < 3 * CB; idx += THREADS) {
    const int m = idx / CB, c = idx % CB;
    if (cb0 + c >= f) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][m][c + c / 32];
    out[(long long)m * f + cb0 + c] = s;
  }
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
  constexpr int V = 16 / sizeof(T);
  const dim3 grid((f + 32 * V - 1) / (32 * V), chunks);
  if (f % V == 0)
    moment_partial_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<float*>(part), n, f,
        rows_per_chunk);
  else
    moment_partial_kernel<T, false><<<grid, THREADS, 0, stream>>>(
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

// x (n, f) row-major with a 16-byte aligned base, dtype 0 = float32,
// 1 = bfloat16; part an fp32 scratch of (chunks, 3, f) with chunks *
// rows_per_chunk >= n; out (3, f) fp32. Returns the CUDA error code of
// the launches (0 on success).
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
