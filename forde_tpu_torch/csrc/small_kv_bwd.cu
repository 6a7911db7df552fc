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
// fp32 route: the same split and order on the CUDA cores, with the tile
// products of common.cuh on a 16 x 16 thread grid and fp32 tiles of pitch
// D + 1. It is the route of every LM training run without --bf16
// (DTypePolicy's compute type defaults to fp32) and of every checkpoint
// trained that way, besides checks and parity runs. flash_mha_bwd.cu's
// three-pass TF32 route is the pattern for taking it to the tensor cores.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using forde::from_float;
using forde::load_tile;
using forde::skv_score;
using forde::skv_visible;
using forde::SKV_INVALID_KEY_POS;
using forde::tile_dot;
using forde::tile_mac;
using forde::mma::exp2_approx;
using forde::mma::LOG2E;

constexpr int BQ = 64;           // query rows per tile
constexpr int BK = 64;           // keys per tile
constexpr int THREADS = 256;     // 16 x 16 thread grid (fp32 route)
constexpr int TC_THREADS = 128;  // 4 warps of 16 rows (bf16 route)
constexpr int MAX_KEYS = 1024;
constexpr int LP = BK + 1;       // pitch of a 64 x 64 tile of w or ds

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

// Max and sum over the 16 threads (tx = 0..15, one half-warp) of a row of
// the fp32 route's thread grid.
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// fp32 route
// ---------------------------------------------------------------------------

template <int D>
size_t dq_smem_bytes(int kp) {
  return (4 * BQ * (D + 1) + BQ * LP) * sizeof(float) + kp * sizeof(int);
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return (4 * BQ * (D + 1) + BQ * LP + 3 * BQ) * sizeof(float) + BK * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
skv_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ key_pos,
                  const float* __restrict__ dout, float* __restrict__ dq,
                  float* __restrict__ stats, int H, int S, int K, float scale) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  const int n = (K + BK - 1) / BK;

  extern __shared__ float smem[];
  float* q_s = smem;              // BQ x LD
  float* do_s = q_s + BQ * LD;    // BQ x LD
  float* k_s = do_s + BQ * LD;    // BK x LD
  float* v_s = k_s + BK * LD;     // BK x LD
  float* ds_s = v_s + BK * LD;    // BQ x LP
  int* pos_s = reinterpret_cast<int*>(ds_s + BQ * LP);  // n * BK thresholds

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float scale_log2 = scale * LOG2E;

  const float* k_g = k + (long long)bh * K * D;
  const float* v_g = v + (long long)bh * K * D;
  load_tile<float, D, THREADS>(q_s, q + (long long)bh * S * D, q0, S, D);
  load_tile<float, D, THREADS>(do_s, dout + (long long)bh * S * D, q0, S, D);
  for (int j = tid; j < n * BK; j += THREADS)
    pos_s[j] = j < K ? key_pos[(long long)b * K + j] : SKV_INVALID_KEY_POS;

  // Rows ty + 16i (positions p[i]) against keys k0 + tx + 16j.
  int p[4];
  float m[4], l[4], u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p[i] = q0 + ty + 16 * i;
    m[i] = -INFINITY;
    l[i] = u[i] = 0.f;
  }
  float x[4][4], dw[4][4];

  // Walk 1: the online max m, sum l and sum u of 2^(s - m) dw.
  for (int k0 = 0; k0 < n * BK; k0 += BK) {
    __syncthreads();
    load_tile<float, D, THREADS>(k_s, k_g, k0, K, D);
    load_tile<float, D, THREADS>(v_s, v_g, k0, K, D);
    __syncthreads();
    tile_dot<D>(x, q_s, k_s, tx, ty);
    tile_dot<D>(dw, do_s, v_s, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        x[i][j] = skv_score(x[i][j] * scale_log2, p[i], c, K, pos_s[c]);
        mx = fmaxf(mx, x[i][j]);
      }
      const float mn = fmaxf(m[i], half_max(mx));
      const float ms = mn == -INFINITY ? 0.f : mn;  // no -inf - -inf
      const float alpha = exp2_approx(m[i] - ms);
      l[i] *= alpha;
      u[i] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = exp2_approx(x[i][j] - ms);
        l[i] += e;
        u[i] = fmaf(e, dw[i][j], u[i]);
      }
      m[i] = mn;
    }
  }
  // l becomes 1 / l, u becomes delta = u / l; written for rows < S.
  const RowStats st(stats, (long long)gridDim.y * S);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lt = half_sum(l[i]);
    u[i] = half_sum(u[i]) / lt;
    l[i] = 1.f / lt;
    if (tx == 0 && p[i] < S) {
      const long long row = (long long)bh * S + p[i];
      st.m[row] = m[i];
      st.l[row] = lt;
      st.delta[row] = u[i];
    }
  }

  // Walk 2: ds, and dq = ds k for rows ty + 16i, columns tx + 16j.
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < n * BK; k0 += BK) {
    __syncthreads();  // the last tile is done with k_s, v_s and ds_s
    load_tile<float, D, THREADS>(k_s, k_g, k0, K, D);
    load_tile<float, D, THREADS>(v_s, v_g, k0, K, D);
    __syncthreads();
    tile_dot<D>(x, q_s, k_s, tx, ty);
    tile_dot<D>(dw, do_s, v_s, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const int kpos = pos_s[c];
        const float w = exp2_approx(skv_score(x[i][j] * scale_log2, p[i], c, K, kpos) - m[i]) * l[i];
        ds_s[(ty + 16 * i) * LP + tx + 16 * j] =
            skv_visible(p[i], c, K, kpos) ? w * (dw[i][j] - u[i]) * scale : 0.f;
      }
    }
    __syncthreads();
    tile_mac<D, LP, 1>(acc, ds_s, k_s, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (p[i] >= S) continue;
    float* row = dq + ((long long)bh * S + p[i]) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = acc[i][j];
  }
}

// dk and dv of keys k0 + ty + 16i, columns tx + 16j, over the query tiles of
// chunk blockIdx.z: into dk and dv when `part` is null, else into the
// chunk's fp32 partials part[0][z] and part[1][z] (each B * H * K * D).
template <int D>
__global__ void __launch_bounds__(THREADS)
skv_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ key_pos,
                    const float* __restrict__ dout, const float* __restrict__ stats,
                    float* __restrict__ dk, float* __restrict__ dv,
                    float* __restrict__ part, int H, int S, int K, float scale) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;

  extern __shared__ float smem[];
  float* k_s = smem;               // BK x LD
  float* v_s = k_s + BK * LD;      // BK x LD
  float* q_s = v_s + BK * LD;      // BQ x LD
  float* do_s = q_s + BQ * LD;     // BQ x LD
  float* p_s = do_s + BQ * LD;     // BQ x LP: round(w), then ds
  float* m_s = p_s + BQ * LP;      // BQ: m of the tile's queries
  float* il_s = m_s + BQ;          // BQ: 1 / l
  float* dl_s = il_s + BQ;         // BQ: delta
  int* kpos_s = reinterpret_cast<int*>(dl_s + BQ);  // BK thresholds

  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float scale_log2 = scale * LOG2E;
  int i_begin, i_end;
  chunk_tiles(S, blockIdx.z, gridDim.z, i_begin, i_end);

  const float* q_g = q + (long long)bh * S * D;
  const float* do_g = dout + (long long)bh * S * D;
  const RowStats st(const_cast<float*>(stats), (long long)gridDim.y * S);
  load_tile<float, D, THREADS>(k_s, k + (long long)bh * K * D, k0, K, D);
  load_tile<float, D, THREADS>(v_s, v + (long long)bh * K * D, k0, K, D);
  if (tid < BK)
    kpos_s[tid] = k0 + tid < K ? key_pos[(long long)b * K + k0 + tid] : SKV_INVALID_KEY_POS;

  float acc_dk[4][DJ], acc_dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  float x[4][4], dw[4][4];
  for (int it = i_begin; it < i_end; ++it) {
    const int q0 = it * BQ;
    __syncthreads();  // the last tile is done with q_s, do_s and p_s
    load_tile<float, D, THREADS>(q_s, q_g, q0, S, D);
    load_tile<float, D, THREADS>(do_s, do_g, q0, S, D);
    if (tid < BQ) {
      const bool in = q0 + tid < S;
      const long long row = (long long)bh * S + q0 + tid;
      m_s[tid] = in ? st.m[row] : 0.f;
      il_s[tid] = in ? 1.f / st.l[row] : 0.f;
      dl_s[tid] = in ? st.delta[row] : 0.f;
    }
    __syncthreads();
    // Rows (queries) q0 + ty + 16i, keys k0 + tx + 16j; a row past S gets
    // w = ds = 0.
    tile_dot<D>(x, q_s, k_s, tx, ty);
    tile_dot<D>(dw, do_s, v_s, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qr = q0 + r;
      const bool in = qr < S;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = kpos_s[c];
        const float w =
            in ? exp2_approx(skv_score(x[i][j] * scale_log2, qr, k0 + c, K, kpos) - m_s[r]) *
                     il_s[r]
               : 0.f;
        x[i][j] = in && skv_visible(qr, k0 + c, K, kpos) ? w * (dw[i][j] - dl_s[r]) * scale : 0.f;
        p_s[r * LP + c] = w;
      }
    }
    __syncthreads();
    tile_mac<D, 1, LP>(acc_dv, p_s, do_s, tx, ty);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p_s[(ty + 16 * i) * LP + tx + 16 * j] = x[i][j];
    __syncthreads();
    tile_mac<D, 1, LP>(acc_dk, p_s, q_s, tx, ty);
  }

  const long long n_out = (long long)gridDim.y * K * D;
  float* out_k = part == nullptr ? dk : part + (long long)blockIdx.z * n_out;
  float* out_v = part == nullptr ? dv : part + (long long)(gridDim.z + blockIdx.z) * n_out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= K) continue;
    const long long row = ((long long)bh * K + kr) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      out_k[row + tx + 16 * j] = acc_dk[i][j];
      out_v[row + tx + 16 * j] = acc_dv[i][j];
    }
  }
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
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* key_pos, const void* dout, void* dq, void* dk,
                   void* dv, void* stats, void* part, int batch, int heads,
                   int seq, int keys, int chunks, float scale,
                   cudaStream_t stream) {
  const int kp = (keys + BK - 1) / BK * BK;
  cudaError_t err = cudaFuncSetAttribute(
      skv_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_smem_bytes<D>(MAX_KEYS));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(skv_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkdv_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  const int bh = batch * heads;
  skv_bwd_dq_kernel<D><<<dim3((seq + BQ - 1) / BQ, bh), THREADS, dq_smem_bytes<D>(kp),
                         stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(key_pos),
      static_cast<const float*>(dout), static_cast<float*>(dq),
      static_cast<float*>(stats), heads, seq, keys, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* const p = chunks > 1 ? static_cast<float*>(part) : nullptr;
  skv_bwd_dkdv_kernel<D><<<dim3(kp / BK, bh, chunks), THREADS, dkdv_smem_bytes<D>(),
                           stream>>>(
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

// dtype: 0 = float32 (CUDA-core route), 1 = bfloat16 (tensor-core route;
// q, k, v, do, dq, dk and dv 16-byte aligned). q, k, v, do, dq, dk and dv
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
  if (dtype == 0 && head_dim == 64) FORDE_SKV_BWD(launch, 64);
  if (dtype == 0 && head_dim == 128) FORDE_SKV_BWD(launch, 128);
  if (dtype == 1 && head_dim == 64) FORDE_SKV_BWD(launch_tc, 64);
  if (dtype == 1 && head_dim == 128) FORDE_SKV_BWD(launch_tc, 128);
#undef FORDE_SKV_BWD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
