// NSA small-KV attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of forde_tpu/ops/nsa_attention.py
// (launched by `_fwd_pallas` through `pl.pallas_call`). The decoder LM's
// NSA runs it twice per layer: for the compressed branch (queries against
// the pool summaries) and for the top-k branch (queries against the
// selected tokens), in every prefill (S queries) and every decode step
// (one query).
//
// What it computes, on contiguous q (B, H, S, D), k and v (B, H, K, D) and
// key_pos (B, K) int32:
//   * key j is visible to query position p (its row index) iff
//     p >= key_pos[b, j]; a masked score is -1e9, NOT -inf, so a query
//     with no visible key gets the uniform distribution over the real keys
//     (the reference's quirk);
//   * key_pos[b, j] >= 2^30 marks a padding key: its score is -inf, outside
//     even that uniform distribution;
//   * scores are fp32 products of the input values summed in fp32, times
//     scale; a straight (not online) softmax over all K keys, w = p /
//     sum(p) in fp32, rounded to the input type before the product with v
//     (`w.astype(v.dtype)`); out in the input type.
//
// Bound on the H100: K is small (64 top-k rows, 192-256 pools at the
// serving shapes), so q is read once, k and v once per q tile (from L2
// after the first), out written once. Prefill (B=8, H=8, S=2048, K=192,
// D=64, bf16): ~34 MB moved, ~10 us; at most 4*D*S*K per head, ~6.4
// GFLOP, ~6.5 us at 989 TFLOP/s: bytes and products are close. A decode
// step (S=1) moves the whole K/V set for one query: ~4 MB at K=256, ~1.3
// us, bound by bytes (and in practice by the launch). This simple kernel
// runs the products in fp32 on the CUDA cores, so at prefill it is bound
// by them; at S=1 its 32-row q tile holds one real row.
//
// Design (right and simple first): one block per (q tile of 32 rows,
// sample * head). The TPU kernel holds the whole key set in VMEM and
// computes the (rows, K) scores in one pass; here the scores of the 32
// rows against every key stay in shared memory (K <= 1024: at most 131 KB
// of fp32), the keys stream through one 64-row tile buffer (K, then V),
// and the softmax is the TPU kernel's straight one, not an online one.

#include <math.h>

#include "common.cuh"

namespace {

using forde::from_float;
using forde::round_to;
using forde::to_float;

constexpr int BQ = 32;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 thread grid
constexpr int MAX_KEYS = 1024;
constexpr int INVALID_KEY_POS = 1 << 30;
constexpr float NEG_BIG = -1e9f;

template <int D>
size_t smem_bytes(int kp) {
  return ((BQ + BK) * (D + 1) + BQ * (kp + 1)) * sizeof(float) +
         kp * sizeof(int);
}

// Rows [0, ROWS) of a (rows, D) slice into fp32 shared memory with pitch
// D + 1; rows at or past `limit` are zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0,
                                          int limit) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int g = row0 + r;
    dst[r * (D + 1) + d] = g < limit ? to_float(src[(long long)g * D + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
small_kv_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ key_pos,
                    T* __restrict__ out, int H, int S, int K, float scale) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;  // output columns per thread
  const int kp = (K + BK - 1) / BK * BK;
  const int LS = kp + 1;      // pitch of score rows

  extern __shared__ float smem[];
  float* q_s = smem;             // BQ x LD
  float* kv_s = q_s + BQ * LD;   // BK x LD: a K tile, then a V tile
  float* s_s = kv_s + BK * LD;   // BQ x LS: scores, then weights
  int* pos_s = reinterpret_cast<int*>(s_s + BQ * LS);  // kp thresholds

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;     // b * H + h
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;

  const T* q_g = q + (long long)bh * S * D;
  const T* k_g = k + (long long)bh * K * D;
  const T* v_g = v + (long long)bh * K * D;

  load_rows<T, D, BQ>(q_s, q_g, q0, S);
  for (int j = tid; j < kp; j += THREADS)
    pos_s[j] = j < K ? key_pos[(long long)b * K + j] : INVALID_KEY_POS;

  // Scores of rows ty + 16i against keys k0 + tx + 16j, every key tile.
  for (int k0 = 0; k0 < kp; k0 += BK) {
    __syncthreads();  // q_s and pos_s written; the previous tile consumed
    load_rows<T, D, BK>(kv_s, k_g, k0, K);
    __syncthreads();
    float sc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[2], kv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) qv[i] = q_s[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kv_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty + 16 * i;
      const int p = q0 + r;  // the query's position
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const int kpos = pos_s[c];
        float s;
        if (c >= K || kpos >= INVALID_KEY_POS) {
          s = -INFINITY;  // padding key: excluded absolutely
        } else {
          s = p >= kpos ? sc[i][j] * scale : NEG_BIG;
        }
        s_s[r * LS + c] = s;
      }
    }
  }
  __syncthreads();

  // Straight softmax over the K keys: each warp owns 4 rows.
  for (int rr = 0; rr < BQ / 8; ++rr) {
    const int r = warp * (BQ / 8) + rr;
    float* row = s_s + r * LS;
    float mx = -INFINITY;
    for (int c = lane; c < kp; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int c = lane; c < kp; c += 32) {
      const float p = expf(row[c] - mx);
      row[c] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int c = lane; c < kp; c += 32) row[c] = round_to<T>(row[c] / sum);
  }

  // out = w V for rows ty + 16i, columns tx + 16j.
  float acc[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < kp; k0 += BK) {
    __syncthreads();  // weights written; the previous tile consumed
    load_rows<T, D, BK>(kv_s, v_g, k0, K);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float wv[2], vv[DJ];
#pragma unroll
      for (int i = 0; i < 2; ++i) wv[i] = s_s[(ty + 16 * i) * LS + k0 + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = kv_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(wv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = q0 + ty + 16 * i;
    if (p >= S) continue;
    T* orow = out + ((long long)bh * S + p) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = from_float<T>(acc[i][j]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* key_pos, void* out, int batch, int heads,
                   int seq, int keys, float scale, cudaStream_t stream) {
  const int kp = (keys + BK - 1) / BK * BK;
  const size_t smem = smem_bytes<D>(kp);
  cudaError_t err = cudaFuncSetAttribute(
      small_kv_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<D>(MAX_KEYS));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + BQ - 1) / BQ, batch * heads);
  small_kv_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(key_pos),
      static_cast<T*>(out), heads, seq, keys, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; 0 < keys <= 1024. Returns the CUDA
// error code of the launch (0 on success).
int forde_small_kv_fwd(const void* q, const void* k, const void* v,
                       const void* key_pos, void* out, int batch, int heads,
                       int seq, int keys, int head_dim, int dtype, float scale,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (keys <= 0 || keys > MAX_KEYS || seq <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k, v, key_pos, out, batch, heads, seq, keys,
                             scale, st);
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k, v, key_pos, out, batch, heads, seq, keys,
                              scale, st);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, key_pos, out, batch, heads, seq,
                                     keys, scale, st);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, key_pos, out, batch, heads, seq,
                                      keys, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
