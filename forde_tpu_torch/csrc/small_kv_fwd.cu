// NSA small-KV attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of forde_tpu/ops/nsa_attention.py
// (launched by `_fwd_pallas` through `pl.pallas_call`). The decoder LM's
// NSA runs it twice per layer: for the compressed branch (queries against
// the pool summaries) and for the top-k branch (queries against the
// selected tokens), in every prefill (S queries), every decode step (one
// query) and every training step.
//
// What it computes, on contiguous q (B, H, S, D), k and v (B, H, K, D) and
// key_pos (B, K) int32, with the TPU kernel's arithmetic:
//   * key j is visible to query position p (its row index) iff
//     p >= key_pos[b, j]; a masked score is -1e9, NOT -inf, so a query
//     with no visible key gets the uniform distribution over the real keys
//     (the reference's quirk);
//   * key_pos[b, j] >= 2^30 marks a padding key: its score is -inf,
//     outside even that uniform distribution (common.cuh `skv_score`);
//   * scores are exact products of the input values summed in fp32, times
//     scale; a straight (not online) softmax over all K keys,
//     w = exp(s - m) / sum(exp(s - m)) with the row's final max m, in fp32;
//   * w rounded to the input type before the product with v
//     (`w.astype(v.dtype)`), sums in fp32, out in the input type.
//
// Bound on the H100. q is read once, k and v once (the later q tiles of a
// (sample, head) read them again from L2), out written once. At the
// serving prefill (B=8, H=8, S=2048, D=64, bf16; K = 192 pools or 64
// top-k) that is ~37 MB, ~11 us at 3.35 TB/s; the products are at most
// 4 * D per (query, key) pair, 6.4 GFLOP at K = 192, ~6.5 us at 989
// TFLOP/s. So bytes bound it, with the products close behind. A decode step
// (S = 1) moves the K/V set for one query: ~4 MB at K = 256, ~1.3 us, and
// in practice its time is the launch.
//
// bf16 route (small_kv_fwd_tc_kernel): the tensor cores
// (mma.sync.m16n8k16, fp32 accumulators: exact bf16 products, another
// order of summation). One block of 4 warps per (64 query rows, sample *
// head); each warp owns 16 rows, whose q fragments stay in registers. K
// and V stream as 64-row XOR-swizzled bf16 tiles through a two-stage
// cp.async ring (16 bytes a thread, zero-filled past K; mma.cuh), and the
// block's key thresholds sit in shared memory. Two walks over the key tiles:
//   1. s = q k^T, masked on the fragments, keeps only each row's running
//      max m and sum l (quad reductions; 2^x in log2 units);
//   2. recomputes s, forms w = 2^(s - m) / l, rounds it to bf16 in pairs
//      and uses it, as it stands in the accumulator registers, as the A
//      operand of w v (V read with ldmatrix.trans; the C -> A identity of
//      mma.cuh).
// The second walk costs one more q k^T (3 products where an online softmax
// needs 2). It buys the TPU's rounding point: w is normalised before it is
// rounded, as `w.astype(v.dtype)` does, where an online softmax rounds
// exp(s - m) against a running max and divides at the end. bf16 step
// readings move with where that rounding sits (PERF.md), so the point is
// kept. out leaves through shared memory in 16-byte stores. A decode step
// (S = 1) fills one row of a 64-row tile, yet this route took a quarter of
// the CUDA-core kernel's device time there on the H100 (PERF.md), so bf16
// takes it at every S.
//
// fp32 route (small_kv_fwd_kernel): the CUDA cores, since the tensor cores
// would round fp32 to TF32. One block per (32 query rows, sample * head);
// the scores of its rows against every key stay in shared memory (K <= 1024:
// at most 131 KB), the keys stream through one 64-row tile buffer (K, then
// V), and the softmax is the straight one. It runs in checks, parity runs
// and fp32 serving. Past 1,024 keys (the decode pools of a long
// max_seq_len: 4,096 at 16,384 positions and ratio 4) the scores no longer
// fit, and small_kv_fwd_long_kernel takes the same blocks through three
// walks over the key tiles instead: the row max, the sum of exp(s - m),
// then w = exp(s - m) / sum into a 32 x 64 tile and w v. Each walk
// recomputes the same fp32 scores, so the softmax stays the straight one;
// only the order of the sum differs. Both routes take up to 8,192 keys
// (FWD_MAX_KEYS; the bf16 route keeps only the thresholds per key).

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using forde::skv_score;
using forde::SKV_INVALID_KEY_POS;

constexpr int BQ = 32;        // query rows per block (fp32 route)
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 thread grid (fp32 route)
constexpr int MAX_KEYS = 1024;       // the fp32 route's scores in shared memory
constexpr int FWD_MAX_KEYS = 8192;  // the long fp32 route and the bf16 route
constexpr int TC_BQ = 64;        // query rows per block (bf16 route)
constexpr int TC_THREADS = 128;  // 4 warps of 16 query rows

template <int D>
size_t smem_bytes(int kp) {
  return ((BQ + BK) * (D + 1) + BQ * (kp + 1)) * sizeof(float) +
         kp * sizeof(int);
}

// The long fp32 route: the q tile, one K or V tile and a 32 x 64 w tile.
template <int D>
size_t long_smem_bytes() {
  return ((BQ + BK) * (D + 1) + BQ * (BK + 1)) * sizeof(float);
}

// The q tile (then out on its way out), two stages of a K and a V tile,
// 64 x D bf16 each, and kp key thresholds.
template <int D>
size_t tc_smem_bytes(int kp) {
  return (TC_BQ * D + 4 * BK * D) * sizeof(__nv_bfloat16) + kp * sizeof(int);
}

// Rows [0, ROWS) of a (rows, D) slice into shared memory with pitch D + 1;
// rows at or past `limit` are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0,
                                          int limit) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int g = row0 + r;
    dst[r * (D + 1) + d] = g < limit ? src[(long long)g * D + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
small_kv_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ key_pos,
                    float* __restrict__ out, int H, int S, int K, float scale) {
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

  const float* q_g = q + (long long)bh * S * D;
  const float* k_g = k + (long long)bh * K * D;
  const float* v_g = v + (long long)bh * K * D;

  load_rows<D, BQ>(q_s, q_g, q0, S);
  for (int j = tid; j < kp; j += THREADS)
    pos_s[j] = j < K ? key_pos[(long long)b * K + j] : SKV_INVALID_KEY_POS;

  // Scores of rows ty + 16i against keys k0 + tx + 16j, every key tile.
  for (int k0 = 0; k0 < kp; k0 += BK) {
    __syncthreads();  // q_s and pos_s written; the previous tile consumed
    load_rows<D, BK>(kv_s, k_g, k0, K);
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
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        s_s[r * LS + c] = skv_score(sc[i][j] * scale, q0 + r, c, K, pos_s[c]);
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
    for (int c = lane; c < kp; c += 32) row[c] /= sum;
  }

  // out = w V for rows ty + 16i, columns tx + 16j.
  float acc[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < kp; k0 += BK) {
    __syncthreads();  // weights written; the previous tile consumed
    load_rows<D, BK>(kv_s, v_g, k0, K);
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
    float* orow = out + ((long long)bh * S + p) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = acc[i][j];
  }
}

// The scores of rows ty + 16i against keys k0 + tx + 16j of one tile, in
// the order small_kv_fwd_kernel sums them: the same fp32 values.
template <int D>
__device__ __forceinline__ void long_scores(float sc[2][4], const float* q_s,
                                            const float* kv_s, const int* pos_b,
                                            int q0, int k0, int K, float scale,
                                            int tx, int ty) {
  constexpr int LD = D + 1;
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
  for (int j = 0; j < 4; ++j) {
    const int c = k0 + tx + 16 * j;
    const int kpos = c < K ? pos_b[c] : SKV_INVALID_KEY_POS;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      sc[i][j] = skv_score(sc[i][j] * scale, q0 + ty + 16 * i, c, K, kpos);
  }
}

// The 16 threads tx = 0..15 of a row ty are lanes 0-15 or 16-31 of one warp.
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
small_kv_fwd_long_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ key_pos,
                         float* __restrict__ out, int H, int S, int K, float scale) {
  constexpr int LD = D + 1;
  constexpr int LW = BK + 1;  // pitch of the w tile
  constexpr int DJ = D / 16;  // output columns per thread
  const int kp = (K + BK - 1) / BK * BK;

  extern __shared__ float smem[];
  float* q_s = smem;             // BQ x LD
  float* kv_s = q_s + BQ * LD;   // BK x LD: a K tile, then a V tile
  float* w_s = kv_s + BK * LD;   // BQ x LW: one tile's weights

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;     // b * H + h
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  const float* q_g = q + (long long)bh * S * D;
  const float* k_g = k + (long long)bh * K * D;
  const float* v_g = v + (long long)bh * K * D;
  const int* pos_b = key_pos + (long long)b * K;

  load_rows<D, BQ>(q_s, q_g, q0, S);
  float sc[2][4];
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};

  // Walk 1: each row's max; walk 2: its sum of exp(s - m).
  for (int walk = 0; walk < 2; ++walk) {
    for (int k0 = 0; k0 < kp; k0 += BK) {
      __syncthreads();  // q_s written; the previous tile consumed
      load_rows<D, BK>(kv_s, k_g, k0, K);
      __syncthreads();
      long_scores<D>(sc, q_s, kv_s, pos_b, q0, k0, K, scale, tx, ty);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (walk == 0)
            mx[i] = fmaxf(mx[i], sc[i][j]);
          else
            sum[i] += expf(sc[i][j] - mx[i]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (walk == 0)
        mx[i] = row_max16(mx[i]);
      else
        sum[i] = row_sum16(sum[i]);
    }
  }

  // Walk 3: w = exp(s - m) / sum of one tile, then out += w V.
  float acc[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < kp; k0 += BK) {
    __syncthreads();  // the previous V tile consumed
    load_rows<D, BK>(kv_s, k_g, k0, K);
    __syncthreads();
    long_scores<D>(sc, q_s, kv_s, pos_b, q0, k0, K, scale, tx, ty);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w_s[(ty + 16 * i) * LW + tx + 16 * j] = expf(sc[i][j] - mx[i]) / sum[i];
    __syncthreads();  // the K tile consumed, the weights written
    load_rows<D, BK>(kv_s, v_g, k0, K);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float wv[2], vv[DJ];
#pragma unroll
      for (int i = 0; i < 2; ++i) wv[i] = w_s[(ty + 16 * i) * LW + c];
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
    float* orow = out + ((long long)bh * S + p) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = acc[i][j];
  }
}

// The bf16 route. Warp w owns query rows q0 + 16w .. q0 + 16w + 15; lane
// (g, t) holds rows r0 = q0 + 16w + g and r1 = r0 + 8 and, of each n8 tile
// j of a product, cols 8j + 2t and 8j + 2t + 1. Step i of the 2n steps
// takes key tile i % n: walk 1 for i < n, walk 2 after.
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
small_kv_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const int* __restrict__ key_pos,
                       __nv_bfloat16* __restrict__ out, int H, int S, int K,
                       float scale) {
  using namespace forde::mma;
  constexpr int KD = D / 16;  // k-steps over the head dim
  constexpr int ND = D / 8;   // n8 tiles of out
  constexpr int NJ = BK / 8;  // n8 tiles of s
  constexpr int STAGE = 2 * BK * D;  // a K tile, then a V tile

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* const q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* const ring = q_s + TC_BQ * D;
  int* const pos_s = reinterpret_cast<int*>(ring + 2 * STAGE);

  const int q0 = blockIdx.x * TC_BQ;
  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n = (K + BK - 1) / BK;
  const int steps = 2 * n;

  const bf16* q_g = q + (long long)bh * S * D;
  const bf16* k_g = k + (long long)bh * K * D;
  const bf16* v_g = v + (long long)bh * K * D;

  // Step i's tiles into stage i % 2, as one commit group: walk 1 reads K
  // only, walk 2 K and V.
  auto fetch = [&](int i) {
    bf16* const dst = ring + (i & 1) * STAGE;
    const int k0 = (i % n) * BK;
    load_tile_async<D, TC_THREADS>(dst, k_g, k0, K, D);
    if (i >= n) load_tile_async<D, TC_THREADS>(dst + BK * D, v_g, k0, K, D);
    cp_async_commit();
  };
  // The q tile and the thresholds join step 0's group (columns past K are
  // zero-filled; skv_score tells them by c >= K).
  load_tile_async<D, TC_THREADS>(q_s, q_g, q0, S, D);
  for (int j = threadIdx.x; j < n * BK; j += TC_THREADS) {
    const bool ok = j < K;
    cp_async_4(pos_s + j, ok ? key_pos + (long long)b * K + j : key_pos, ok);
  }
  fetch(0);

  const int wrow = 16 * warp;
  // A warp whose rows all lie at or past S does no products; it still
  // takes part in the copies and barriers.
  const bool active = q0 + wrow < S;
  const int r0 = q0 + wrow + g, r1 = r0 + 8;
  // Scores in log2 units: exp(s * scale - m) = 2^(s * scale * log2(e) - m').
  const float scale_log2 = scale * LOG2E;
  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0, r1
  float l0 = 0.f, l1 = 0.f;  // this lane's part of the running sums, then 1 / l

  for (int i = 0; i < steps; ++i) {
    // Step i + 1's tiles go into the stage that step i - 1 freed; step i's
    // have landed once at most that later group is in flight.
    if (i + 1 < steps) {
      fetch(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (i == 0 && active) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) load_a<D>(qf[kk], q_s, wrow, kk, lane);
    }
    if (i == n) {  // walk 1 is done: w = 2^(s - m) * (1 / l)
      l0 = 1.f / quad_sum(l0);
      l1 = 1.f / quad_sum(l1);
    }

    if (active) {
      const int k0 = (i % n) * BK;
      const bf16* const k_t = ring + (i & 1) * STAGE;
      const bf16* const v_t = k_t + BK * D;
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int np = 0; np < NJ / 2; ++np) {
          uint32_t bk[4];
          load_b<D>(bk, k_t, 16 * np, kk, lane);
          mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = k0 + 8 * j + 2 * t + e;
          const int kpos = pos_s[c];
          s[j][e] = skv_score(s[j][e] * scale_log2, r0, c, K, kpos);
          s[j][2 + e] = skv_score(s[j][2 + e] * scale_log2, r1, c, K, kpos);
          mx0 = fmaxf(mx0, s[j][e]);
          mx1 = fmaxf(mx1, s[j][2 + e]);
        }
      }
      if (i < n) {
        // Walk 1: the running max and sum. A row whose keys so far are all
        // padding keeps m = -inf and subtracts 0 instead (no -inf - -inf).
        const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
        const float ms0 = mn0 == -INFINITY ? 0.f : mn0;
        const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
        l0 *= exp2_approx(m0 - ms0);
        l1 *= exp2_approx(m1 - ms1);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          l0 += exp2_approx(s[j][0] - ms0) + exp2_approx(s[j][1] - ms0);
          l1 += exp2_approx(s[j][2] - ms1) + exp2_approx(s[j][3] - ms1);
        }
        m0 = mn0;
        m1 = mn1;
      } else {
        // Walk 2: w = 2^(s - m) / l, rounded to bf16 into the A operand of
        // w v (n8 tiles 2kk, 2kk + 1 -> k-step kk).
        uint32_t wf[NJ / 2][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          wf[j >> 1][(j & 1) * 2] = pack_bf16x2(exp2_approx(s[j][0] - m0) * l0,
                                                exp2_approx(s[j][1] - m0) * l0);
          wf[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(exp2_approx(s[j][2] - m1) * l1,
                                                    exp2_approx(s[j][3] - m1) * l1);
        }
#pragma unroll
        for (int kk = 0; kk < NJ / 2; ++kk) {
#pragma unroll
          for (int np = 0; np < KD; ++np) {
            uint32_t bv[4];
            load_bt<D>(bv, v_t, 16 * kk, np, lane);
            mma_bf16(acc[2 * np], wf[kk], bv[0], bv[1]);
            mma_bf16(acc[2 * np + 1], wf[kk], bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // stage i % 2 is free for step i + 2
  }

  if (!active) return;
  // This warp's rows of the q tile, read into its fragments at step 0,
  // take its rows of out.
  stage_rows<D>(q_s, acc, wrow, 1.f, 1.f, lane);
  __syncwarp();
  store_rows<D>(out + (long long)bh * S * D, D, q_s, wrow, q0 + wrow, S, lane);
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* key_pos, void* out, int batch, int heads,
                      int seq, int keys, float scale, cudaStream_t stream) {
  const int kp = (keys + BK - 1) / BK * BK;
  cudaError_t err = cudaFuncSetAttribute(
      small_kv_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)tc_smem_bytes<D>(FWD_MAX_KEYS));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + TC_BQ - 1) / TC_BQ, batch * heads);
  small_kv_fwd_tc_kernel<D><<<grid, TC_THREADS, tc_smem_bytes<D>(kp), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(key_pos),
      static_cast<__nv_bfloat16*>(out), heads, seq, keys, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* key_pos, void* out, int batch, int heads,
                   int seq, int keys, float scale, cudaStream_t stream) {
  const int kp = (keys + BK - 1) / BK * BK;
  const dim3 grid((seq + BQ - 1) / BQ, batch * heads);
  if (keys > MAX_KEYS) {
    cudaError_t err = cudaFuncSetAttribute(
        small_kv_fwd_long_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)long_smem_bytes<D>());
    if (err != cudaSuccess) return err;
    small_kv_fwd_long_kernel<D><<<grid, THREADS, long_smem_bytes<D>(), stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(key_pos),
        static_cast<float*>(out), heads, seq, keys, scale);
    return cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      small_kv_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<D>(MAX_KEYS));
  if (err != cudaSuccess) return err;
  small_kv_fwd_kernel<D><<<grid, THREADS, smem_bytes<D>(kp), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(key_pos),
      static_cast<float*>(out), heads, seq, keys, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA-core route), 1 = bfloat16 (tensor-core route;
// q, k, v and out 16-byte aligned); 0 < keys <= 8192. Returns the CUDA
// error code of the launch (0 on success).
int forde_small_kv_fwd(const void* q, const void* k, const void* v,
                       const void* key_pos, void* out, int batch, int heads,
                       int seq, int keys, int head_dim, int dtype, float scale,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (keys <= 0 || keys > FWD_MAX_KEYS || seq <= 0) return (int)cudaErrorInvalidValue;
#define FORDE_SKV_FWD(LAUNCH, DIM) \
  return LAUNCH<DIM>(q, k, v, key_pos, out, batch, heads, seq, keys, scale, st)
  if (dtype == 0 && head_dim == 64) FORDE_SKV_FWD(launch, 64);
  if (dtype == 0 && head_dim == 128) FORDE_SKV_FWD(launch, 128);
  if (dtype == 1 && head_dim == 64) FORDE_SKV_FWD(launch_tc, 64);
  if (dtype == 1 && head_dim == 128) FORDE_SKV_FWD(launch_tc, 128);
#undef FORDE_SKV_FWD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
