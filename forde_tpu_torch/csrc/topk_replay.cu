// The NSA prefill's running top-k replay for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it ports the `lax.scan` over `topk_insert` in
// `nsa_prefill` (forde_tpu/models/generate.py:566-577), which the JAX
// package runs on the device. The port's earlier replay copied the scores
// to the host and looped there.
//
// What it computes: for each of N rows (layers x batch rows) of fp32
// importance scores (N, P), the running top-k set that inserting score t
// at position t, t = 0 .. P-1, into an empty set leaves: a new score
// replaces the set's first minimum (the lowest slot among equal minima)
// iff it is strictly greater. Empty slots hold -inf and `empty_idx`; pad
// positions arrive as -inf and so are never accepted, nor is a NaN. Out:
// kept scores (N, K) fp32 and their positions (N, K) int32, slot order
// included. The result is a selection: it equals the plain version
// (ops/topk_replay.py) exactly.
//
// Bound on the H100: the bytes are few (N * P * 4 read, N * K * 8
// written: 0.8 MB at the serving prefill, ~0.24 us at 3.35 TB/s). The
// insertion order makes each row a chain: every accepted insertion needs
// the new first minimum before the next score can be compared, a
// reduction over K slots of log2(K) dependent steps at least. So a row
// takes at least (accepted insertions) x log2(K) dependent steps, and
// the longest row bounds the call (chip_smoke.py counts the accepted
// insertions of its inputs and states that bound at one cycle a step).
//
// Design: one warp per row, four rows a block. The K slots are spread
// over the lanes' registers (slot j * 32 + lane in register j, K / 32 a
// lane), and the warp keeps the current first minimum (value, slot) in
// registers. The scores stream through 128 at a time (four 128-byte
// coalesced loads a lane, the next group loaded while this one is
// processed); per 32 positions one ballot finds those above the current
// minimum, and only those are visited, in position order. An accepted
// score is broadcast by a shuffle, written into its slot by the lane that
// owns it, and the new first minimum found by a butterfly of shuffles over
// (value, slot) pairs, ties to the lower slot, which every lane ends with;
// the positions of the 32 that are no longer above the new minimum drop
// out of the ballot. fp32 comparisons only; no shared memory, no atomics.

#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int GROUP = 4;  // 32-position chunks a lane loads at once
constexpr unsigned FULL = 0xffffffffu;

// (v, s) comes before (ov, os) as a minimum: a smaller value, or the same
// value at a lower slot.
__device__ __forceinline__ bool earlier(float v, int s, float ov, int os) {
  return v < ov || (v == ov && s < os);
}

template <int PER_LANE>
__global__ void __launch_bounds__(THREADS)
topk_replay_kernel(const float* __restrict__ scores, float* __restrict__ kept,
                   int* __restrict__ idx, int n, int p, int k, int empty_idx) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp: row is uniform across it
  const float* s = scores + (long long)row * p;

  float val[PER_LANE];
  int pos[PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    val[j] = -INFINITY;
    pos[j] = empty_idx;
  }
  float min_val = -INFINITY;  // the set's first minimum: every slot is
  int min_slot = 0;           // -inf at the start, slot 0 the first

  float cur[GROUP], next[GROUP];
#pragma unroll
  for (int u = 0; u < GROUP; ++u) {
    const int t = u * 32 + lane;
    cur[u] = t < p ? s[t] : -INFINITY;
  }
  for (int base = 0; base < p; base += GROUP * 32) {
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const int t = base + (GROUP + u) * 32 + lane;
      next[u] = t < p ? s[t] : -INFINITY;
    }
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const float x = cur[u];
      unsigned above = __ballot_sync(FULL, x > min_val);
      while (above) {
        const int i = __ffs(above) - 1;
        const float xi = __shfl_sync(FULL, x, i);
        const int t = base + u * 32 + i;
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
          if (j * 32 + lane == min_slot) {
            val[j] = xi;
            pos[j] = t;
          }
        }
        // The new first minimum: this lane's own slots in slot order,
        // then a butterfly over the lanes.
        float v = INFINITY;
        int sl = INT_MAX;
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
          const int slot = j * 32 + lane;
          if (slot < k && earlier(val[j], slot, v, sl)) {
            v = val[j];
            sl = slot;
          }
        }
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) {
          const float ov = __shfl_xor_sync(FULL, v, m);
          const int os = __shfl_xor_sync(FULL, sl, m);
          if (earlier(ov, os, v, sl)) {
            v = ov;
            sl = os;
          }
        }
        min_val = v;
        min_slot = sl;
        // Positions up to i are done; the minimum only rises, so no
        // position that was not above the old one is above the new one.
        above = __ballot_sync(FULL, x > min_val) & ~((2u << i) - 1u);
      }
    }
#pragma unroll
    for (int u = 0; u < GROUP; ++u) cur[u] = next[u];
  }

  float* kept_row = kept + (long long)row * k;
  int* idx_row = idx + (long long)row * k;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int slot = j * 32 + lane;
    if (slot < k) {
      kept_row[slot] = val[j];
      idx_row[slot] = pos[j];
    }
  }
}

template <int PER_LANE>
cudaError_t launch(const float* scores, float* kept, int* idx, int n, int p,
                   int k, int empty_idx, cudaStream_t stream) {
  const int blocks = (n + WARPS - 1) / WARPS;
  topk_replay_kernel<PER_LANE><<<blocks, THREADS, 0, stream>>>(
      scores, kept, idx, n, p, k, empty_idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// scores (n, p) fp32 row-major; kept (n, k) fp32 and idx (n, k) int32 out;
// 1 <= k <= 256. Returns the CUDA error code of the launch (0 on success).
int forde_topk_replay(const void* scores, void* kept, void* idx, int n, int p,
                      int k, int empty_idx, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scores);
  float* kv = static_cast<float*>(kept);
  int* iv = static_cast<int*>(idx);
  if (n <= 0 || p < 0 || k < 1 || k > 256) return (int)cudaErrorInvalidValue;
  if (k <= 32) return launch<1>(s, kv, iv, n, p, k, empty_idx, st);
  if (k <= 64) return launch<2>(s, kv, iv, n, p, k, empty_idx, st);
  if (k <= 128) return launch<4>(s, kv, iv, n, p, k, empty_idx, st);
  return launch<8>(s, kv, iv, n, p, k, empty_idx, st);
}

}  // extern "C"
