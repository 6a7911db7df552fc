// NSA small-KV attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` of forde_tpu/ops/nsa_attention.py
// (launched by `_bwd_pallas` through `pl.pallas_call`), the gradient of
// small_kv_fwd.cu. The decoder LM's training step runs it twice per layer:
// for the compressed branch (queries against the pool summaries) and for
// the top-k branch (queries against the selected tokens).
//
// What it computes, with the TPU kernel's arithmetic, on contiguous q and
// do (B, H, S, D), k and v (B, H, K, D) and key_pos (B, K) int32. Like the
// forward it recomputes the straight softmax of each query row over all K
// keys (masked scores -1e9, padding keys -inf; common.cuh `skv_score`),
// w = exp(s - m) / l in fp32, unrounded; then
//   dv = round(w)^T do, w rounded to the input type;
//   dw = do v^T;  ds = w * (dw - sum_keys(dw * w)), ZEROED where the mask
//        was false (the -1e9 entries too: in a row with no visible key they
//        carry the uniform weight, so such a row adds to dv but not to dq
//        or dk; padding keys get nothing), times scale, rounded to the
//        input type;
//   dq = ds k;  dk = ds^T q;  all three written in the input type.
// The row sum sum_keys(dw * w) is taken in fp32 from the unrounded w and
// dw, as the TPU does, not from the forward's rounded out. Products are
// exact multiplies of the (rounded) values summed in fp32.
//
// Bound on the H100 at the training shapes (B=8, H=8, S=2048, D=64, bf16;
// K = 192 pools or 64 top-k): q and do read once, k, v, key_pos once, dq,
// dk, dv written once: ~34 MB, ~10 us at 3.35 TB/s; the products are
// 10 * D operations per visible (query, key) pair (q k^T, do v^T, w^T do,
// ds k, ds^T q): at most ~16 GFLOP at K = 192, ~17 us at 989 TFLOP/s. So
// the two bounds are close; at K = 960 (S = 8192) the products bound it.
//
// Design: FA-2's split into two kernels, as flash_mha_bwd.cu runs it, and
// a fixed-order sum across blocks, so the result is bit-identical from run
// to run (the TPU sums dk and dv in grid order, `:151-157`):
//   * dq kernel, one block per 64 query rows of a (sample, head). Walk 1
//     over the key tiles computes s and dw and keeps the online max m, the
//     sum l and the rescaled sum of exp(s - m) dw, so that
//     delta = sum_keys(dw * w) = that / l; it writes m, l and delta per row
//     (fp32, B * H * S each) for the second kernel. Walk 2 recomputes s and
//     dw, forms ds and accumulates dq = ds k. 5 products per key tile.
//   * dk/dv kernel, one block per 64 keys of a (sample, head) and per chunk
//     of the query tiles. It computes s^T = k q^T and dw^T = v do^T, so
//     that round(w^T) and ds^T are A operands for dv += round(w^T) do and
//     dk += ds^T q (4 products); each query's m, l and delta come from the
//     dq kernel. K is small (one key tile at top-k), so the query tiles are
//     cut into chunks (the count, a function of the shapes, comes from the
//     wrapper) until about two blocks an SM are in flight. With one chunk
//     the kernel writes dk and dv; with more, each chunk writes fp32
//     partials and a last small kernel sums them in chunk order and casts
//     them to the input type.
// Each output element has one writer and each sum a fixed order: no
// atomics. The wrapper allocates the scratch (the row statistics and the
// partials); the C code allocates nothing and never synchronises.
//
// bf16 route (the *_tc kernels): the tensor cores (mma.sync.m16n8k16, fp32
// accumulators), 4 warps of 16 rows (dq) or 16 keys (dk/dv). Tiles stream
// through a two-stage cp.async ring into XOR-swizzled bf16 shared memory
// (zero-filled past S and K) and are read with ldmatrix both ways round
// (mma.cuh). dq: q and do fragments stay in registers; a key tile is taken
// in chunks of 32 keys (16 at D = 64), so the s and dw accumulators stay
// small; ds in registers is the A operand of ds k. dk/dv: K and V stay in
// shared memory as A operands (at D = 128 the two accumulators take 128
// registers a thread), and a 64-query tile is taken as two 32-query chunks
// one after the other; the queries' statistics are broadcast per column
// from shared memory. -1e9 (masked) and -inf (padding) stay apart on the
// fragments, and a row past S is selected to 0, never multiplied by 0.
//
// fp32 route (skv_bwd_dq_tf32_tc_kernel, skv_bwd_dkdv_tf32_tc_kernel, then
// with more than one chunk the same chunk sum): the tensor cores too, every
// product three TF32 passes (mma.sync.m16n8k8; mma.cuh), as
// flash_mha_bwd.cu's fp32 route. It is the route of every LM training run
// without --bf16 (DTypePolicy's compute type defaults to fp32) and of every
// checkpoint trained that way. It replaces the same TPU kernel in fp32,
// whose products the TPU takes at full precision. Bound on the H100 (D 64;
// products at 67 TFLOP/s on the CUDA cores, or a third of TF32's 495 on
// the tensor cores; bytes at 3.35 TB/s):
//   pools B 8, H 8, S 2,048, K 192: 10.05 GFLOP, 0.150 / 0.061 ms; 0.034 ms
//   top-k K 64:                      2.79 GFLOP, 0.042 / 0.017 ms; 0.031 ms
//   pools B 1, S 8,192, K 960:       21.4 GFLOP, 0.319 / 0.130 ms; 0.017 ms
// The CUDA-core pair it replaced (16 x 16 thread grids, w and ds through
// shared memory) took 1.400 / 0.534-0.535 / 3.403-3.405 ms of device time
// there, 1.6x SDPA's fp32 backward at the pools. The kernels are the bf16 route's
// two, walk for walk: dq (4 warps of 16 query rows; key tiles of 32, 16 at
// D = 128) with its online m, l and delta, dk/dv (4 warps of 16 keys;
// query tiles of 16) with the queries' m, l and delta through the ring.
// ds, and w^T and ds^T, are split in registers and used, as they stand in
// the accumulators, as the A operands of ds k, w^T do and ds^T q
// (accumulator column 2t to k slot t, 2t + 1 to slot t + 4; the B operand
// read at rows 2t, 2t + 1): they never touch shared memory. Every tile
// stays fp32 in shared memory with row pitch D + 4, filled by a cp.async
// ring (zero past S and K), and every operand is split as its fragment is
// loaded. Splitting each shared tile once per block into hi and lo planes
// in shared memory instead (K and V for dq; K, V, Q and dO for dk/dv) ran
// 1.24-1.26x these times: its planes and its second barrier a step held
// the blocks to 2 an SM, where this form's 156-158 registers and 53-74 KB
// at D = 64 fit 3 (chip_smoke.small_kv_bwd_timing of both forms in one
// call; PERF.md). At D = 128 (158 and 233 registers, 2 blocks an SM) the
// dk and dv accumulators take 128 registers a thread, so their updates go
// in two passes. 0 spill bytes at D = 64 and 128. Each output is summed in
// a fixed order with no atomics: two calls give the same bits. Measured on
// an NVIDIA H100 80GB HBM3 at 700 W: 0.585-0.587 / 0.227 / 1.450-1.451 ms
// of device time at the three shapes, 0.67x SDPA's fp32 backward at the
// pools; the dq kernel takes 53-54% of a call. What bounds it is issue
// slots, as in flash_mha_bwd.cu: at D = 64 the dq kernel's SASS holds 3,312
// instructions for its 288 TF32 HMMA, the dk/dv kernel's 2,544 for 192
// (PERF.md).

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using forde::from_float;
using forde::skv_score;
using forde::skv_visible;
using forde::SKV_INVALID_KEY_POS;
using forde::mma::exp2_approx;
using forde::mma::LOG2E;

constexpr int BQ = 64;           // query rows per block (dq) and bf16 tile
constexpr int BK = 64;           // keys per block (dk/dv) and bf16 tile
constexpr int TC_THREADS = 128;  // 4 warps of 16 rows or keys
constexpr int MAX_KEYS = 1024;

// The row statistics the dq kernel leaves for the dk/dv kernel: m (log2
// units), l and delta, each B * H * S fp32, one after the other.
struct RowStats {
  float* m;
  float* l;
  float* delta;
  __device__ RowStats(float* base, long long bhs)
      : m(base), l(base + bhs), delta(base + 2 * bhs) {}
};

// Query tiles [i_begin, i_end) of chunk z of `chunks` (empty past the end).
__device__ __forceinline__ void chunk_tiles(int S, int z, int chunks,
                                            int& i_begin, int& i_end) {
  const int tiles = (S + BQ - 1) / BQ;
  const int per = (tiles + chunks - 1) / chunks;
  i_begin = min(tiles, z * per);
  i_end = min(tiles, i_begin + per);
}

// ---------------------------------------------------------------------------
// fp32 route: three TF32 passes a product on the tensor cores
// ---------------------------------------------------------------------------

// Keys per tile of the dq kernel's ring; queries per tile of the dk/dv
// kernel's ring.
template <int D>
__host__ __device__ constexpr int tf32_dq_keys() {
  return D == 128 ? 16 : 32;
}
constexpr int TF32_DKDV_QUERIES = 16;

template <int D>
constexpr int tf32_blocks_per_sm() {
  return D == 128 ? 2 : 3;
}

// q and do, two ring stages of a K and a V tile (fp32, pitch D + 4) and
// the key thresholds.
template <int D>
size_t tf32_dq_smem_bytes(int kp) {
  return (2 * BQ + 2 * 2 * tf32_dq_keys<D>()) * (D + 4) * sizeof(float) + kp * sizeof(int);
}

// The block's K and V, two ring stages of a Q and a dO tile (fp32, pitch
// D + 4) and the stages' query statistics (m, l, delta).
template <int D>
constexpr size_t tf32_dkdv_smem_bytes() {
  return (2 * BK + 2 * 2 * TF32_DKDV_QUERIES) * (D + 4) * sizeof(float) +
         2 * 3 * TF32_DKDV_QUERIES * sizeof(float);
}

// The dq kernel of the fp32 route: the bf16 dq kernel's two walks, every
// product three TF32 passes (mma.cuh). Warp w owns query rows q0 + 16w ..
// q0 + 16w + 15; lane (g, t) holds rows r0 = q0 + 16w + g and r1 = r0 + 8
// and, of each n8 tile j of a product, cols 8j + 2t and 8j + 2t + 1. Every
// tile stays fp32 in shared memory and is split as its fragments are
// loaded; step i of the 2n steps takes key tile i % n: walk 1 for i < n,
// walk 2 after.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, tf32_blocks_per_sm<D>())
skv_bwd_dq_tf32_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const int* __restrict__ key_pos,
                          const float* __restrict__ dout, float* __restrict__ dq,
                          float* __restrict__ stats, int H, int S, int K, float scale) {
  using namespace forde::mma;
  constexpr int LD = D + 4;
  constexpr int KD = D / 8;  // k8 steps over the head dim
  constexpr int ND = D / 8;  // n8 tiles of dq
  constexpr int KT = tf32_dq_keys<D>();
  constexpr int NJ = KT / 8;  // n8 tiles of s and dw
  constexpr int STAGE = 2 * KT * LD;  // a K tile, then a V tile

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* const q_s = reinterpret_cast<float*>(smem_raw);
  float* const do_s = q_s + BQ * LD;
  float* const ring = do_s + BQ * LD;
  int* const pos_s = reinterpret_cast<int*>(ring + 2 * STAGE);

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n = (K + KT - 1) / KT;
  const int steps = 2 * n;  // walk 1, then walk 2, over the same tiles

  const float* k_g = k + (long long)bh * K * D;
  const float* v_g = v + (long long)bh * K * D;
  // Step i's K and V tiles into stage i % 2, as one commit group.
  auto fetch = [&](int i) {
    float* const dst = ring + (i & 1) * STAGE;
    const int k0 = (i % n) * KT;
    load_tile_f32_async<KT, D, TC_THREADS>(dst, k_g, k0, K, D);
    load_tile_f32_async<KT, D, TC_THREADS>(dst + KT * LD, v_g, k0, K, D);
    cp_async_commit();
  };
  load_tile_f32_async<BQ, D, TC_THREADS>(q_s, q + (long long)bh * S * D, q0, S, D);
  load_tile_f32_async<BQ, D, TC_THREADS>(do_s, dout + (long long)bh * S * D, q0, S, D);
  // Columns past K are zero-filled; skv_score tells them by c >= K.
  for (int j = threadIdx.x; j < n * KT; j += TC_THREADS) {
    const bool ok = j < K;
    cp_async_4(pos_s + j, ok ? key_pos + (long long)b * K + j : key_pos, ok);
  }
  fetch(0);  // with q, do and the thresholds

  const int wrow = 16 * warp;
  // A warp whose rows all lie at or past S does no products.
  const bool active = q0 + wrow < S;
  const int r0 = q0 + wrow + g, r1 = r0 + 8;
  const float scale_log2 = scale * LOG2E;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 units)
  float l0 = 0.f, l1 = 0.f;  // this lane's part of the sums of 2^(s - m), then 1 / l
  float u0 = 0.f, u1 = 0.f;  // ... of 2^(s - m) dw, then delta
  float lt0 = 0.f, lt1 = 0.f;  // l of the rows
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < steps; ++i) {
    // Step i's tiles have landed; after the barrier every warp is done
    // with step i - 1, whose stage takes step i + 1.
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < steps) fetch(i + 1);
    if (i == n) {  // walk 1 is done: l, 1 / l and delta = u / l of rows r0, r1
      lt0 = quad_sum(l0);
      lt1 = quad_sum(l1);
      u0 = quad_sum(u0) / lt0;
      u1 = quad_sum(u1) / lt1;
      l0 = 1.f / lt0;
      l1 = 1.f / lt1;
    }
    if (!active) continue;

    const int k0 = (i % n) * KT;
    const float* const k_t = ring + (i & 1) * STAGE;
    const float* const v_t = k_t + KT * LD;
    float s[NJ][4], dw[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dw[j][0] = dw[j][1] = dw[j][2] = dw[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t fa[4], ah[4], al[4];
      load_a_f32<D>(fa, q_s, wrow, kk, lane);
      split_tf32(fa, ah, al);
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np) {
        uint32_t fb[4], fh[4], fl[4];
        load_b_f32<D>(fb, k_t, 16 * np, kk, lane);
        split_tf32(fb, fh, fl);
        mma_tf32x3(s[2 * np], ah, al, fh[0], fh[1], fl[0], fl[1]);
        mma_tf32x3(s[2 * np + 1], ah, al, fh[2], fh[3], fl[2], fl[3]);
      }
      load_a_f32<D>(fa, do_s, wrow, kk, lane);
      split_tf32(fa, ah, al);
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np) {
        uint32_t fb[4], fh[4], fl[4];
        load_b_f32<D>(fb, v_t, 16 * np, kk, lane);
        split_tf32(fb, fh, fl);
        mma_tf32x3(dw[2 * np], ah, al, fh[0], fh[1], fl[0], fl[1]);
        mma_tf32x3(dw[2 * np + 1], ah, al, fh[2], fh[3], fl[2], fl[3]);
      }
    }
    if (i < n) {
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * t + e;
          const int kpos = pos_s[col];
          s[j][e] = skv_score(s[j][e] * scale_log2, r0, col, K, kpos);
          s[j][2 + e] = skv_score(s[j][2 + e] * scale_log2, r1, col, K, kpos);
          mx0 = fmaxf(mx0, s[j][e]);
          mx1 = fmaxf(mx1, s[j][2 + e]);
        }
      }
      // A row whose keys so far are all padding keeps m = -inf and
      // subtracts 0 instead (no -inf - -inf).
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      const float ms0 = mn0 == -INFINITY ? 0.f : mn0;
      const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
      const float a0 = exp2_approx(m0 - ms0), a1 = exp2_approx(m1 - ms1);
      l0 *= a0;
      u0 *= a0;
      l1 *= a1;
      u1 *= a1;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 = exp2_approx(s[j][e] - ms0);
          const float p1 = exp2_approx(s[j][2 + e] - ms1);
          l0 += p0;
          l1 += p1;
          u0 = fmaf(p0, dw[j][e], u0);
          u1 = fmaf(p1, dw[j][2 + e], u1);
        }
      }
      m0 = mn0;
      m1 = mn1;
    } else {
      // ds = w (dw - delta) scale, zero where not visible; n8 tile kk,
      // split into TF32, is the A operand of k8 step kk of ds k, k read at
      // rows 2t, 2t + 1.
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * kk + 2 * t + e;
          const int kpos = pos_s[col];
          const float w0 =
              exp2_approx(skv_score(s[kk][e] * scale_log2, r0, col, K, kpos) - m0) * l0;
          const float w1 =
              exp2_approx(skv_score(s[kk][2 + e] * scale_log2, r1, col, K, kpos) - m1) * l1;
          ds[e] = skv_visible(r0, col, K, kpos) ? w0 * (dw[kk][e] - u0) * scale : 0.f;
          ds[2 + e] = skv_visible(r1, col, K, kpos) ? w1 * (dw[kk][2 + e] - u1) * scale : 0.f;
        }
        uint32_t dh[4], dl[4];
        acc_to_a_tf32(dh, dl, ds);
#pragma unroll
        for (int np = 0; np < ND; ++np) {
          uint32_t fh[2], fl[2];
          load_bt_f32<D>(fh, fl, k_t, 8 * kk, 8 * np, lane);
          mma_tf32x3(acc[np], dh, dl, fh[0], fh[1], fl[0], fl[1]);
        }
      }
    }
  }

  if (!active) return;
  if (t == 0) {
    const RowStats rs(stats, (long long)gridDim.y * S);
    const long long row = (long long)bh * S;
    if (r0 < S) {
      rs.m[row + r0] = m0;
      rs.l[row + r0] = lt0;
      rs.delta[row + r0] = u0;
    }
    if (r1 < S) {
      rs.m[row + r1] = m1;
      rs.l[row + r1] = lt1;
      rs.delta[row + r1] = u1;
    }
  }
  store_rows_f32<D>(dq + (long long)bh * S * D, D, acc, r0, S, 1.f, 1.f, lane);
}

// Q and dO of the QT queries at q0, with their m, l and delta, into stage
// st of the fp32 dk/dv kernel's ring (rows at or past S zero).
template <int D>
__device__ __forceinline__ void load_query_stage_tf32(float* ring, float* stat, int st,
                                                      const float* q_g, const float* do_g,
                                                      const RowStats& rs, long long row_bh,
                                                      int q0, int S) {
  using namespace forde::mma;
  constexpr int QT = TF32_DKDV_QUERIES;
  float* const q_t = ring + st * 2 * QT * (D + 4);
  load_tile_f32_async<QT, D, TC_THREADS>(q_t, q_g, q0, S, D);
  load_tile_f32_async<QT, D, TC_THREADS>(q_t + QT * (D + 4), do_g, q0, S, D);
  float* const stat_t = stat + st * 3 * QT;
  const int r = threadIdx.x;
  if (r < QT) {
    const bool ok = q0 + r < S;
    const long long row = row_bh + (ok ? q0 + r : 0);
    cp_async_4(stat_t + r, rs.m + row, ok);
    cp_async_4(stat_t + QT + r, rs.l + row, ok);
    cp_async_4(stat_t + 2 * QT + r, rs.delta + row, ok);
  }
}

// The dk/dv kernel of the fp32 route: the bf16 dk/dv kernel's walk over
// the queries of chunk blockIdx.z, in tiles of QT queries, every product
// three TF32 passes. Warp w owns keys k0 + 16w .. k0 + 16w + 15; lane
// (g, t) holds keys kr0 = k0 + 16w + g and kr1 = kr0 + 8 and, of each n8
// tile j of a transposed product, query cols 8j + 2t, 8j + 2t + 1. Writes
// dk and dv when `part` is null, else the chunk's fp32 partials part[0][z]
// and part[1][z] (each B * H * K * D).
template <int D>
__global__ void __launch_bounds__(TC_THREADS, tf32_blocks_per_sm<D>())
skv_bwd_dkdv_tf32_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const int* __restrict__ key_pos,
                            const float* __restrict__ dout, const float* __restrict__ stats,
                            float* __restrict__ dk, float* __restrict__ dv,
                            float* __restrict__ part, int H, int S, int K, float scale) {
  using namespace forde::mma;
  constexpr int LD = D + 4;
  constexpr int KD = D / 8;  // k8 steps over the head dim
  constexpr int ND = D / 8;  // n8 tiles of dk and dv
  constexpr int QT = TF32_DKDV_QUERIES;
  constexpr int NJ = QT / 8;  // n8 tiles of s^T and dw^T
  constexpr int STAGE = 2 * QT * LD;  // a Q tile, then a dO tile

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* const k_s = reinterpret_cast<float*>(smem_raw);
  float* const v_s = k_s + BK * LD;
  float* const ring = v_s + BK * LD;
  float* const stat = ring + 2 * STAGE;  // per stage: m, l, delta

  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int i_begin, i_end;
  chunk_tiles(S, blockIdx.z, gridDim.z, i_begin, i_end);
  // The chunk's queries [qa, qb), in tiles of QT.
  const int qa = i_begin * BQ, qb = min(S, i_end * BQ);
  const int n = qb > qa ? (qb - qa + QT - 1) / QT : 0;

  const float* q_g = q + (long long)bh * S * D;
  const float* do_g = dout + (long long)bh * S * D;
  const RowStats rs(const_cast<float*>(stats), (long long)gridDim.y * S);
  const long long row_bh = (long long)bh * S;

  load_tile_f32_async<BK, D, TC_THREADS>(k_s, k + (long long)bh * K * D, k0, K, D);
  load_tile_f32_async<BK, D, TC_THREADS>(v_s, v + (long long)bh * K * D, k0, K, D);
  if (n > 0) load_query_stage_tf32<D>(ring, stat, 0, q_g, do_g, rs, row_bh, qa, S);
  cp_async_commit();

  const int wrow = 16 * warp;
  // A warp whose keys all lie at or past K does no products.
  const bool active = k0 + wrow < K;
  const int kr0 = k0 + wrow + g, kr1 = kr0 + 8;
  const int kp0 = kr0 < K ? key_pos[(long long)b * K + kr0] : SKV_INVALID_KEY_POS;
  const int kp1 = kr1 < K ? key_pos[(long long)b * K + kr1] : SKV_INVALID_KEY_POS;
  const float scale_log2 = scale * LOG2E;
  float dkacc[ND][4], dvacc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    dkacc[j][0] = dkacc[j][1] = dkacc[j][2] = dkacc[j][3] = 0.f;
    dvacc[j][0] = dvacc[j][1] = dvacc[j][2] = dvacc[j][3] = 0.f;
  }

  for (int i = 0; i < n; ++i) {
    const int st = i & 1;
    // Tile i has landed; after the barrier every warp is done with tile
    // i - 1, whose stage takes tile i + 1.
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < n) {
      load_query_stage_tf32<D>(ring, stat, st ^ 1, q_g, do_g, rs, row_bh, qa + (i + 1) * QT, S);
      cp_async_commit();
    }
    if (!active) continue;

    const int qt0 = qa + i * QT;
    const float* const q_t = ring + st * STAGE;
    const float* const do_t = q_t + QT * LD;
    const float* const m_t = stat + st * 3 * QT;
    const float* const l_t = m_t + QT;
    const float* const d_t = l_t + QT;
    float s[NJ][4], dw[NJ][4];  // s^T and dw^T: keys x queries
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dw[j][0] = dw[j][1] = dw[j][2] = dw[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t fa[4], ah[4], al[4];
      load_a_f32<D>(fa, k_s, wrow, kk, lane);
      split_tf32(fa, ah, al);
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np) {
        uint32_t fb[4], fh[4], fl[4];
        load_b_f32<D>(fb, q_t, 16 * np, kk, lane);
        split_tf32(fb, fh, fl);
        mma_tf32x3(s[2 * np], ah, al, fh[0], fh[1], fl[0], fl[1]);
        mma_tf32x3(s[2 * np + 1], ah, al, fh[2], fh[3], fl[2], fl[3]);
      }
      load_a_f32<D>(fa, v_s, wrow, kk, lane);
      split_tf32(fa, ah, al);
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np) {
        uint32_t fb[4], fh[4], fl[4];
        load_b_f32<D>(fb, do_t, 16 * np, kk, lane);
        split_tf32(fb, fh, fl);
        mma_tf32x3(dw[2 * np], ah, al, fh[0], fh[1], fl[0], fl[1]);
        mma_tf32x3(dw[2 * np + 1], ah, al, fh[2], fh[3], fl[2], fl[3]);
      }
    }
    // w^T = 2^(s^T - m) / l, SELECTED to 0 on a query past S, and ds^T =
    // w^T (dw^T - delta) scale where visible; n8 tile kk of each, split
    // into TF32, is the A operand of k8 step kk of w^T do and ds^T q. The
    // dv and dk updates go in two passes, so that only one B operand is
    // live beside the two accumulators.
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
      float w[4], ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = 8 * kk + 2 * t + e;  // query within the tile
        const int qr = qt0 + cl;
        const bool in = qr < S;
        const float mq = m_t[cl], il = 1.f / l_t[cl], dl = d_t[cl];
        const float e0 = exp2_approx(skv_score(s[kk][e] * scale_log2, qr, kr0, K, kp0) - mq) * il;
        const float e1 =
            exp2_approx(skv_score(s[kk][2 + e] * scale_log2, qr, kr1, K, kp1) - mq) * il;
        w[e] = in ? e0 : 0.f;
        w[2 + e] = in ? e1 : 0.f;
        ds[e] = in && skv_visible(qr, kr0, K, kp0) ? e0 * (dw[kk][e] - dl) * scale : 0.f;
        ds[2 + e] = in && skv_visible(qr, kr1, K, kp1) ? e1 * (dw[kk][2 + e] - dl) * scale : 0.f;
      }
      uint32_t wh[4], wl[4], sh[4], sl[4];
      acc_to_a_tf32(wh, wl, w);
      acc_to_a_tf32(sh, sl, ds);
#pragma unroll
      for (int np = 0; np < ND; ++np) {
        uint32_t fh[2], fl[2];
        load_bt_f32<D>(fh, fl, do_t, 8 * kk, 8 * np, lane);
        mma_tf32x3(dvacc[np], wh, wl, fh[0], fh[1], fl[0], fl[1]);
      }
#pragma unroll
      for (int np = 0; np < ND; ++np) {
        uint32_t fh[2], fl[2];
        load_bt_f32<D>(fh, fl, q_t, 8 * kk, 8 * np, lane);
        mma_tf32x3(dkacc[np], sh, sl, fh[0], fh[1], fl[0], fl[1]);
      }
    }
  }
  cp_async_wait<0>();  // K and V when the chunk has no query tile

  if (!active) return;
  float* out_k = dk + (long long)bh * K * D;
  float* out_v = dv + (long long)bh * K * D;
  if (part != nullptr) {
    const long long n_out = (long long)gridDim.y * K * D;
    out_k = part + (long long)blockIdx.z * n_out + (long long)bh * K * D;
    out_v = part + (long long)(gridDim.z + blockIdx.z) * n_out + (long long)bh * K * D;
  }
  store_rows_f32<D>(out_k, D, dkacc, kr0, K, 1.f, 1.f, lane);
  store_rows_f32<D>(out_v, D, dvacc, kr0, K, 1.f, 1.f, lane);
}

// ---------------------------------------------------------------------------
// bf16 route
// ---------------------------------------------------------------------------

// Two stages of two 64 x D bf16 tiles (K and V) and the key thresholds.
template <int D>
size_t tc_dq_smem_bytes(int kp) {
  return 4 * BK * D * sizeof(__nv_bfloat16) + kp * sizeof(int);
}

// K and V of the block, two stages of a Q and a dO tile, and the stages'
// query statistics (m, l, delta).
template <int D>
constexpr size_t tc_dkdv_smem_bytes() {
  return 6 * BK * D * sizeof(__nv_bfloat16) + 2 * 3 * BQ * sizeof(float);
}

// Warp w owns query rows q0 + 16w .. q0 + 16w + 15; lane (g, t) holds rows
// r0 = q0 + 16w + g and r1 = r0 + 8 and, of each n8 tile j of a product,
// cols 8j + 2t and 8j + 2t + 1. Step i of the 2n steps takes key tile
// i % n: walk 1 for i < n, walk 2 after.
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
skv_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ key_pos,
                     const __nv_bfloat16* __restrict__ dout,
                     __nv_bfloat16* __restrict__ dq, float* __restrict__ stats,
                     int H, int S, int K, float scale) {
  using namespace forde::mma;
  constexpr int KD = D / 16;  // k-steps over the head dim
  constexpr int ND = D / 8;   // n8 tiles of dq
  // Keys per chunk of a tile, as flash_mha_bwd's dq kernel takes them.
  constexpr int KC = D == 128 ? 32 : 16;
  constexpr int NJ = KC / 8;  // n8 tiles of a chunk's s and dw
  // Stage st of the ring: its K tile at smem + st * STAGE, its V tile
  // BK * D after it. Until their fragments are loaded, q and do sit in
  // stage 1.
  constexpr int STAGE = 2 * BK * D;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* const smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* const q_s = smem + STAGE;
  bf16* const do_s = q_s + BK * D;
  int* const pos_s = reinterpret_cast<int*>(smem + 2 * STAGE);

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n = (K + BK - 1) / BK;
  const int steps = 2 * n;  // walk 1, then walk 2, over the same tiles

  const bf16* q_g = q + (long long)bh * S * D;
  const bf16* do_g = dout + (long long)bh * S * D;
  const bf16* k_g = k + (long long)bh * K * D;
  const bf16* v_g = v + (long long)bh * K * D;

  load_tile_async<D, TC_THREADS>(q_s, q_g, q0, S, D);
  load_tile_async<D, TC_THREADS>(do_s, do_g, q0, S, D);
  load_tile_async<D, TC_THREADS>(smem, k_g, 0, K, D);
  load_tile_async<D, TC_THREADS>(smem + BK * D, v_g, 0, K, D);
  // Columns past K are zero-filled; skv_score tells them by c >= K.
  for (int j = threadIdx.x; j < n * BK; j += TC_THREADS) {
    const bool ok = j < K;
    cp_async_4(pos_s + j, ok ? key_pos + (long long)b * K + j : key_pos, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int wrow = 16 * warp;
  // A warp whose rows all lie at or past S does no products.
  const bool active = q0 + wrow < S;
  const int r0 = q0 + wrow + g, r1 = r0 + 8;
  const float scale_log2 = scale * LOG2E;
  uint32_t qf[KD][4], df[KD][4];
  if (active) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      load_a<D>(qf[kk], q_s, wrow, kk, lane);
      load_a<D>(df[kk], do_s, wrow, kk, lane);
    }
  }
  __syncthreads();  // stage 1 is free for the ring

  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 units)
  float l0 = 0.f, l1 = 0.f;  // this lane's part of the sums of 2^(s - m), then 1 / l
  float u0 = 0.f, u1 = 0.f;  // ... of 2^(s - m) dw, then delta
  float lt0 = 0.f, lt1 = 0.f;  // l of the rows
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < steps; ++i) {
    const int st = i & 1;
    if (i + 1 < steps) {
      const int kn = ((i + 1) % n) * BK;
      bf16* const next = smem + (st ^ 1) * STAGE;
      load_tile_async<D, TC_THREADS>(next, k_g, kn, K, D);
      load_tile_async<D, TC_THREADS>(next + BK * D, v_g, kn, K, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (i == n) {  // walk 1 is done: l, 1 / l and delta = u / l of rows r0, r1
      lt0 = quad_sum(l0);
      lt1 = quad_sum(l1);
      u0 = quad_sum(u0) / lt0;
      u1 = quad_sum(u1) / lt1;
      l0 = 1.f / lt0;
      l1 = 1.f / lt1;
    }

    if (active) {
      const int k0 = (i % n) * BK;
      const bool walk2 = i >= n;
      const bf16* const k_t = smem + st * STAGE;
      const bf16* const v_t = k_t + BK * D;
#pragma unroll
      for (int c = 0; c < BK / KC; ++c) {  // chunks of KC keys
        const int kc0 = KC * c;
        float s[NJ][4], dw[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
          dw[j][0] = dw[j][1] = dw[j][2] = dw[j][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
          for (int np = 0; np < NJ / 2; ++np) {
            uint32_t bb[4];
            load_b<D>(bb, k_t, kc0 + 16 * np, kk, lane);
            mma_bf16(s[2 * np], qf[kk], bb[0], bb[1]);
            mma_bf16(s[2 * np + 1], qf[kk], bb[2], bb[3]);
            load_b<D>(bb, v_t, kc0 + 16 * np, kk, lane);
            mma_bf16(dw[2 * np], df[kk], bb[0], bb[1]);
            mma_bf16(dw[2 * np + 1], df[kk], bb[2], bb[3]);
          }
        }
        if (!walk2) {
          float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = k0 + kc0 + 8 * j + 2 * t + e;
              const int kpos = pos_s[col];
              s[j][e] = skv_score(s[j][e] * scale_log2, r0, col, K, kpos);
              s[j][2 + e] = skv_score(s[j][2 + e] * scale_log2, r1, col, K, kpos);
              mx0 = fmaxf(mx0, s[j][e]);
              mx1 = fmaxf(mx1, s[j][2 + e]);
            }
          }
          // A row whose keys so far are all padding keeps m = -inf and
          // subtracts 0 instead (no -inf - -inf).
          const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
          const float ms0 = mn0 == -INFINITY ? 0.f : mn0;
          const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
          const float a0 = exp2_approx(m0 - ms0), a1 = exp2_approx(m1 - ms1);
          l0 *= a0;
          u0 *= a0;
          l1 *= a1;
          u1 *= a1;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p0 = exp2_approx(s[j][e] - ms0);
              const float p1 = exp2_approx(s[j][2 + e] - ms1);
              l0 += p0;
              l1 += p1;
              u0 = fmaf(p0, dw[j][e], u0);
              u1 = fmaf(p1, dw[j][2 + e], u1);
            }
          }
          m0 = mn0;
          m1 = mn1;
        } else {
          // ds = round(w (dw - delta) scale), zero where not visible: the A
          // operand of ds k.
          float ds[NJ][4];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = k0 + kc0 + 8 * j + 2 * t + e;
              const int kpos = pos_s[col];
              const float w0 =
                  exp2_approx(skv_score(s[j][e] * scale_log2, r0, col, K, kpos) - m0) * l0;
              const float w1 =
                  exp2_approx(skv_score(s[j][2 + e] * scale_log2, r1, col, K, kpos) - m1) * l1;
              ds[j][e] = skv_visible(r0, col, K, kpos) ? w0 * (dw[j][e] - u0) * scale : 0.f;
              ds[j][2 + e] =
                  skv_visible(r1, col, K, kpos) ? w1 * (dw[j][2 + e] - u1) * scale : 0.f;
            }
          }
          uint32_t dsf[NJ / 2][4];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dsf[j >> 1][(j & 1) * 2] = pack_bf16x2(ds[j][0], ds[j][1]);
            dsf[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(ds[j][2], ds[j][3]);
          }
#pragma unroll
          for (int kk = 0; kk < NJ / 2; ++kk) {
#pragma unroll
            for (int np = 0; np < KD; ++np) {
              uint32_t bb[4];
              load_bt<D>(bb, k_t, kc0 + 16 * kk, np, lane);
              mma_bf16(acc[2 * np], dsf[kk], bb[0], bb[1]);
              mma_bf16(acc[2 * np + 1], dsf[kk], bb[2], bb[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // stage st is free for step i + 2
  }

  if (!active) return;
  if (t == 0) {
    const RowStats rs(stats, (long long)gridDim.y * S);
    const long long row = (long long)bh * S;
    if (r0 < S) {
      rs.m[row + r0] = m0;
      rs.l[row + r0] = lt0;
      rs.delta[row + r0] = u0;
    }
    if (r1 < S) {
      rs.m[row + r1] = m1;
      rs.l[row + r1] = lt1;
      rs.delta[row + r1] = u1;
    }
  }
  // The ring is idle: stage 0's K tile takes this warp's rows of dq.
  stage_rows<D>(smem, acc, wrow, 1.f, 1.f, lane);
  __syncwarp();
  store_rows<D>(dq + (long long)bh * S * D, D, smem, wrow, q0 + wrow, S, lane);
}

// Q and dO of the query tile at q0, with the queries' m, l and delta, into
// stage st of the dk/dv kernel's ring (rows at or past S zero).
template <int D>
__device__ __forceinline__ void load_query_stage(
    __nv_bfloat16* ring, float* stat, int st, const __nv_bfloat16* q_g,
    const __nv_bfloat16* do_g, const RowStats& rs, long long row_bh, int q0,
    int S) {
  using namespace forde::mma;
  bf16* const q_t = ring + st * 2 * BQ * D;
  load_tile_async<D, TC_THREADS>(q_t, q_g, q0, S, D);
  load_tile_async<D, TC_THREADS>(q_t + BQ * D, do_g, q0, S, D);
  float* const stat_t = stat + st * 3 * BQ;
  const int r = threadIdx.x;
  if (r < BQ) {
    const bool ok = q0 + r < S;
    const long long row = row_bh + (ok ? q0 + r : 0);
    cp_async_4(stat_t + r, rs.m + row, ok);
    cp_async_4(stat_t + BQ + r, rs.l + row, ok);
    cp_async_4(stat_t + 2 * BQ + r, rs.delta + row, ok);
  }
}

// Warp w owns keys k0 + 16w .. k0 + 16w + 15; lane (g, t) holds keys
// kr0 = k0 + 16w + g and kr1 = kr0 + 8 and, of each n8 tile j of a
// transposed product, query cols 8j + 2t, 8j + 2t + 1. Writes dk and dv
// when `part` is null, else the chunk's fp32 partials (as the fp32 route).
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
skv_bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const int* __restrict__ key_pos,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ stats,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv,
                       float* __restrict__ part, int H, int S, int K,
                       float scale) {
  using namespace forde::mma;
  constexpr int KD = D / 16;  // k-steps over the head dim
  constexpr int ND = D / 8;   // n8 tiles of dk and dv
  constexpr int QC = 32;      // queries per chunk of a tile
  constexpr int NJ = QC / 8;  // n8 tiles of a chunk's s^T and dw^T
  // Stage st of the ring: its Q tile at ring + st * STAGE, its dO tile
  // BQ * D after it; their m, l, delta at stat + st * 3 * BQ.
  constexpr int STAGE = 2 * BQ * D;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* const k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* const v_s = k_s + BK * D;
  bf16* const ring = v_s + BK * D;
  float* const stat = reinterpret_cast<float*>(ring + 2 * STAGE);

  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int i_begin, i_end;
  chunk_tiles(S, blockIdx.z, gridDim.z, i_begin, i_end);
  const int n = i_end - i_begin;

  const bf16* q_g = q + (long long)bh * S * D;
  const bf16* do_g = dout + (long long)bh * S * D;
  const RowStats rs(const_cast<float*>(stats), (long long)gridDim.y * S);
  const long long row_bh = (long long)bh * S;

  load_tile_async<D, TC_THREADS>(k_s, k + (long long)bh * K * D, k0, K, D);
  load_tile_async<D, TC_THREADS>(v_s, v + (long long)bh * K * D, k0, K, D);
  if (n > 0) load_query_stage<D>(ring, stat, 0, q_g, do_g, rs, row_bh, i_begin * BQ, S);
  cp_async_commit();

  const int wrow = 16 * warp;
  // A warp whose keys all lie at or past K does no products.
  const bool active = k0 + wrow < K;
  const int kr0 = k0 + wrow + g, kr1 = kr0 + 8;
  const int kp0 = kr0 < K ? key_pos[(long long)b * K + kr0] : SKV_INVALID_KEY_POS;
  const int kp1 = kr1 < K ? key_pos[(long long)b * K + kr1] : SKV_INVALID_KEY_POS;
  const float scale_log2 = scale * LOG2E;
  float dkacc[ND][4], dvacc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    dkacc[j][0] = dkacc[j][1] = dkacc[j][2] = dkacc[j][3] = 0.f;
    dvacc[j][0] = dvacc[j][1] = dvacc[j][2] = dvacc[j][3] = 0.f;
  }

  for (int i = 0; i < n; ++i) {
    const int st = i & 1;
    if (i + 1 < n) {
      load_query_stage<D>(ring, stat, st ^ 1, q_g, do_g, rs, row_bh,
                          (i_begin + i + 1) * BQ, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      const int q0 = (i_begin + i) * BQ;
      const bf16* const q_t = ring + st * STAGE;
      const bf16* const do_t = q_t + BQ * D;
      const float* const m_t = stat + st * 3 * BQ;
      const float* const l_t = m_t + BQ;
      const float* const d_t = l_t + BQ;
      // Not unrolled: two chunks in flight at once would take more than
      // 255 registers beside the dk and dv accumulators.
#pragma unroll 1
      for (int c = 0; c < BQ / QC; ++c) {  // chunks of QC queries
        const int qc0 = QC * c;
        float s[NJ][4], dw[NJ][4];  // s^T and dw^T: keys x queries
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
          dw[j][0] = dw[j][1] = dw[j][2] = dw[j][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t a[4];
          load_a<D>(a, k_s, wrow, kk, lane);
#pragma unroll
          for (int np = 0; np < NJ / 2; ++np) {
            uint32_t bb[4];
            load_b<D>(bb, q_t, qc0 + 16 * np, kk, lane);
            mma_bf16(s[2 * np], a, bb[0], bb[1]);
            mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
          }
          load_a<D>(a, v_s, wrow, kk, lane);
#pragma unroll
          for (int np = 0; np < NJ / 2; ++np) {
            uint32_t bb[4];
            load_b<D>(bb, do_t, qc0 + 16 * np, kk, lane);
            mma_bf16(dw[2 * np], a, bb[0], bb[1]);
            mma_bf16(dw[2 * np + 1], a, bb[2], bb[3]);
          }
        }
        // w^T = 2^(s^T - m) / l, SELECTED to 0 on a query past S, and
        // ds^T = w^T (dw^T - delta) scale where visible; both rounded to
        // bf16 as the A operands of w^T do and ds^T q.
        uint32_t wf[NJ / 2][4], dsf[NJ / 2][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float w[4], ds[4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = qc0 + 8 * j + 2 * t + e;  // query within the tile
            const int qr = q0 + cl;
            const bool in = qr < S;
            const float mq = m_t[cl], il = 1.f / l_t[cl], dl = d_t[cl];
            const float e0 = exp2_approx(skv_score(s[j][e] * scale_log2, qr, kr0, K, kp0) - mq) * il;
            const float e1 =
                exp2_approx(skv_score(s[j][2 + e] * scale_log2, qr, kr1, K, kp1) - mq) * il;
            w[e] = in ? e0 : 0.f;
            w[2 + e] = in ? e1 : 0.f;
            ds[e] = in && skv_visible(qr, kr0, K, kp0) ? e0 * (dw[j][e] - dl) * scale : 0.f;
            ds[2 + e] =
                in && skv_visible(qr, kr1, K, kp1) ? e1 * (dw[j][2 + e] - dl) * scale : 0.f;
          }
          wf[j >> 1][(j & 1) * 2] = pack_bf16x2(w[0], w[1]);
          wf[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(w[2], w[3]);
          dsf[j >> 1][(j & 1) * 2] = pack_bf16x2(ds[0], ds[1]);
          dsf[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
        }
#pragma unroll
        for (int kk = 0; kk < NJ / 2; ++kk) {
#pragma unroll
          for (int np = 0; np < KD; ++np) {
            uint32_t bb[4];
            load_bt<D>(bb, do_t, qc0 + 16 * kk, np, lane);
            mma_bf16(dvacc[2 * np], wf[kk], bb[0], bb[1]);
            mma_bf16(dvacc[2 * np + 1], wf[kk], bb[2], bb[3]);
            load_bt<D>(bb, q_t, qc0 + 16 * kk, np, lane);
            mma_bf16(dkacc[2 * np], dsf[kk], bb[0], bb[1]);
            mma_bf16(dkacc[2 * np + 1], dsf[kk], bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();  // stage st is free for tile i + 2
  }

  cp_async_wait<0>();  // K and V when the chunk has no query tile
  __syncthreads();
  if (!active) return;
  if (part == nullptr) {
    // The ring is idle: stage 0 takes this warp's rows of dk and dv.
    stage_rows<D>(ring, dkacc, wrow, 1.f, 1.f, lane);
    stage_rows<D>(ring + BQ * D, dvacc, wrow, 1.f, 1.f, lane);
    __syncwarp();
    store_rows<D>(dk + (long long)bh * K * D, D, ring, wrow, k0 + wrow, K, lane);
    store_rows<D>(dv + (long long)bh * K * D, D, ring + BQ * D, wrow, k0 + wrow, K, lane);
    return;
  }
  const long long n_out = (long long)gridDim.y * K * D;
  float* const pk = part + (long long)blockIdx.z * n_out + (long long)bh * K * D;
  float* const pv = part + (long long)(gridDim.z + blockIdx.z) * n_out + (long long)bh * K * D;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int col = 8 * j + 2 * t;
    if (kr0 < K) {
      *reinterpret_cast<float2*>(pk + (long long)kr0 * D + col) = make_float2(dkacc[j][0], dkacc[j][1]);
      *reinterpret_cast<float2*>(pv + (long long)kr0 * D + col) = make_float2(dvacc[j][0], dvacc[j][1]);
    }
    if (kr1 < K) {
      *reinterpret_cast<float2*>(pk + (long long)kr1 * D + col) = make_float2(dkacc[j][2], dkacc[j][3]);
      *reinterpret_cast<float2*>(pv + (long long)kr1 * D + col) = make_float2(dvacc[j][2], dvacc[j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// The chunks' partials, summed in chunk order
// ---------------------------------------------------------------------------

// dk (blockIdx.y 0) or dv (1): out[i] = sum over c = 0, 1, ... of
// part[y][c][i], four elements a thread (n is a multiple of 64).
template <typename T>
__global__ void skv_bwd_reduce_kernel(const float* __restrict__ part,
                                      T* __restrict__ dk, T* __restrict__ dv,
                                      long long n, int chunks) {
  const float* src = part + (long long)blockIdx.y * chunks * n;
  T* dst = blockIdx.y == 0 ? dk : dv;
  for (long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x); i < n;
       i += 4LL * gridDim.x * blockDim.x) {
    float4 acc = *reinterpret_cast<const float4*>(src + i);
    for (int c = 1; c < chunks; ++c) {
      const float4 x = *reinterpret_cast<const float4*>(src + c * n + i);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    dst[i] = from_float<T>(acc.x);
    dst[i + 1] = from_float<T>(acc.y);
    dst[i + 2] = from_float<T>(acc.z);
    dst[i + 3] = from_float<T>(acc.w);
  }
}

template <typename T>
cudaError_t launch_reduce(const void* part, void* dk, void* dv, long long n,
                          int chunks, cudaStream_t stream) {
  constexpr int RT = 256;
  const long long want = (n / 4 + RT - 1) / RT;
  const dim3 grid((unsigned)(want < 1056 ? want : 1056), 2);
  skv_bwd_reduce_kernel<T><<<grid, RT, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(dk), static_cast<T*>(dv), n, chunks);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* key_pos, const void* dout, void* dq, void* dk,
                      void* dv, void* stats, void* part, int batch, int heads,
                      int seq, int keys, int chunks, float scale,
                      cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int kp = (keys + BK - 1) / BK * BK;
  cudaError_t err = cudaFuncSetAttribute(
      skv_bwd_dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)tc_dq_smem_bytes<D>(MAX_KEYS));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(skv_bwd_dkdv_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)tc_dkdv_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  const int bh = batch * heads;
  skv_bwd_dq_tc_kernel<D><<<dim3((seq + BQ - 1) / BQ, bh), TC_THREADS,
                            tc_dq_smem_bytes<D>(kp), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(key_pos),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
      static_cast<float*>(stats), heads, seq, keys, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* const p = chunks > 1 ? static_cast<float*>(part) : nullptr;
  skv_bwd_dkdv_tc_kernel<D><<<dim3(kp / BK, bh, chunks), TC_THREADS,
                              tc_dkdv_smem_bytes<D>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(key_pos),
      static_cast<const bf16*>(dout), static_cast<const float*>(stats),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), p, heads, seq, keys,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  return launch_reduce<bf16>(part, dk, dv, (long long)bh * keys * D, chunks, stream);
}

template <int D>
cudaError_t launch_tf32(const void* q, const void* k, const void* v,
                        const void* key_pos, const void* dout, void* dq, void* dk,
                        void* dv, void* stats, void* part, int batch, int heads,
                        int seq, int keys, int chunks, float scale,
                        cudaStream_t stream) {
  constexpr int KT = tf32_dq_keys<D>();
  const int kp = (keys + KT - 1) / KT * KT;
  cudaError_t err = cudaFuncSetAttribute(
      skv_bwd_dq_tf32_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)tf32_dq_smem_bytes<D>(MAX_KEYS));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(skv_bwd_dkdv_tf32_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)tf32_dkdv_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  const int bh = batch * heads;
  skv_bwd_dq_tf32_tc_kernel<D><<<dim3((seq + BQ - 1) / BQ, bh), TC_THREADS,
                                 tf32_dq_smem_bytes<D>(kp), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(key_pos),
      static_cast<const float*>(dout), static_cast<float*>(dq),
      static_cast<float*>(stats), heads, seq, keys, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* const p = chunks > 1 ? static_cast<float*>(part) : nullptr;
  skv_bwd_dkdv_tf32_tc_kernel<D><<<dim3((keys + BK - 1) / BK, bh, chunks), TC_THREADS,
                                   tf32_dkdv_smem_bytes<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(key_pos),
      static_cast<const float*>(dout), static_cast<const float*>(stats),
      static_cast<float*>(dk), static_cast<float*>(dv), p, heads, seq, keys, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  return launch_reduce<float>(part, dk, dv, (long long)bh * keys * D, chunks, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (three-pass TF32 route), 1 = bfloat16 (both on the
// tensor cores; q, k, v, do, dq, dk and dv 16-byte aligned). q, k, v, do, dq, dk and dv
// are in that type; stats is scratch of 3 * B * H * S fp32; with chunks > 1,
// part is scratch of 2 * chunks * B * H * K * D fp32 (else unused);
// 0 < keys <= 1024, chunks >= 1. Returns the CUDA error code of the
// launches (0 on success).
int forde_small_kv_bwd(const void* q, const void* k, const void* v,
                       const void* key_pos, const void* dout, void* dq,
                       void* dk, void* dv, void* stats, void* part, int batch,
                       int heads, int seq, int keys, int head_dim, int dtype,
                       int chunks, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (keys <= 0 || keys > MAX_KEYS || seq <= 0 || chunks <= 0 ||
      (chunks > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
#define FORDE_SKV_BWD(LAUNCH, DIM)                                                 \
  return LAUNCH<DIM>(q, k, v, key_pos, dout, dq, dk, dv, stats, part, batch, heads, \
                     seq, keys, chunks, scale, st)
  if (dtype == 0 && head_dim == 64) FORDE_SKV_BWD(launch_tf32, 64);
  if (dtype == 0 && head_dim == 128) FORDE_SKV_BWD(launch_tf32, 128);
  if (dtype == 1 && head_dim == 64) FORDE_SKV_BWD(launch_tc, 64);
  if (dtype == 1 && head_dim == 128) FORDE_SKV_BWD(launch_tc, 128);
#undef FORDE_SKV_BWD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
