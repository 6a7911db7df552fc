// Fused-qkv multi-head attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_mha_bwd_kernel` of forde_tpu/ops/flash_attention.py
// (launched by `_mha_bwd_pallas` through `pl.pallas_call`): the gradient of
// flash_mha_fwd.cu, run by both encoder towers in every block of a training
// step.
//
// What it computes, with the TPU kernel's arithmetic. From qkv (B, S, 3*H*D),
// the output gradient do (B, S, H*D) and the forward's row log-sum-exp lse
// (B, H, S) fp32, for each (sample, head):
//   p     = exp(q k^T * scale - lse), SELECTED to 0 where the key is masked.
//           A row with no visible key has lse = -1e30, so exp() is inf on
//           its masked keys: a select keeps it out, a product with 0 would
//           give NaN. Such rows get zero dq and add nothing to dk or dv;
//   dp    = do v^T, and delta = sum over keys of p * dp per row, in fp32
//           (the TPU kernel's form, not FA-2's rowsum(do * o): o is rounded
//           to the input type, p and dp are not);
//   ds    = p * (dp - delta) * scale, rounded to the input type;
//   dq = ds k, dk = ds^T q, dv = round(p)^T do, p rounded to the input type;
// and writes dq, dk, dv into one dqkv (B, S, 3*H*D) at the columns of q, k
// and v. Products are exact multiplies of the (rounded) input values summed
// in fp32, as the TPU kernel's `_dot` accumulates in fp32. The mask is the
// forward's (common.cuh `visible`).
//
// Bound on the H100 at the training shapes (batch 128, bf16): vision
// (S=200, H=6, D=128) moves about 276 MB (qkv and do read, dqkv written):
// ~82 us at 3.35 TB/s, against ~39 GFLOP of products, ~40 us at 989
// TFLOP/s. Text (S=64, H=4, D=128) moves about 59 MB: ~18 us. So memory
// bounds it.
//
// Both routes keep FA-2's split into two kernels, one block per (tile of
// 64 rows, head, sample):
//   * dq: the block owns 64 query rows. A first walk over the key tiles sums
//     delta for its rows and writes it for the second kernel; a second walk
//     recomputes p and dp, forms ds and accumulates dq = ds k in registers.
//   * dk/dv: the block owns 64 keys, walks the query tiles that can see
//     them, and accumulates dv = p^T do and dk = ds^T q in registers.
// Each output element has one owner and is summed in a fixed order: no
// atomics, the result is deterministic. Tiles that no row can see are
// skipped. delta stays the TPU kernel's sum of p * dp: FA-2's rowsum(do * o)
// would read o rounded to bf16 and carry that rounding into every ds.
//
// bf16 route (the *_tc kernels): the tensor cores (mma.sync.m16n8k16, fp32
// accumulators: exact bf16 products, only the order of summation changes).
// 4 warps, each owning 16 rows of the block's tile. Tiles stream through a
// two-stage cp.async ring into XOR-swizzled bf16 shared memory and are read
// with ldmatrix, both ways round (mma.cuh), so one copy of a tile serves
// as the B operand of q k^T and of ds k.
//   * dq: q and do fragments and the rows' lse stay in registers. Walk 1:
//     s = q k^T, p = exp(s * scale - lse) SELECTED to 0 where masked,
//     dp = do v^T, delta += p * dp (quad reduction at the end). Walk 2:
//     the same, then ds = round(p (dp - delta) scale) in registers is the
//     A operand of ds k, k read transposed. 5 products per tile pair.
//   * dk/dv: K and V stay in shared memory (at D = 128 two 64-wide fp32
//     accumulators already take 128 registers a thread) and give their A
//     fragments by ldmatrix. s^T = k q^T puts p^T in the accumulator layout
//     that is the A operand of dv += round(p^T) do; dp^T = v do^T, ds^T =
//     round(p^T (dp^T - delta) scale), dk += ds^T q. Q and dO tiles come
//     through the ring with their lse and delta, which are broadcast per
//     column from shared memory. 4 products per tile pair; p and ds never
//     touch shared memory.
// The dq kernel takes a 64-key tile in chunks of 32 keys (16 at D = 64),
// the dk/dv kernel a 64-query tile in two chunks of 32 queries, one after
// the other: the s and dp accumulators stay at 16 registers each, and
// ptxas fits both kernels in 255 registers without spilling. exp() runs
// as 2^x on the special-function unit. Outputs leave through shared
// memory in 16-byte stores. What bounds the route on the H100 is latency,
// not bytes: at ~250 registers a thread two blocks (8 warps) fit an SM,
// and the dq kernel, whose first walk only sums delta, takes more than
// half of the backward's time (PERF.md).
//
// fp32 route: the CUDA cores, since the tensor cores would round fp32 to
// TF32. Tiles sit in shared memory as fp32 with row pitch D + 1
// (conflict-free column reads), p and ds go through shared memory, and the
// walks do 9 tile products per (query tile, key tile). It runs only in
// checks and parity runs; shared-memory bandwidth bounds it.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using forde::from_float;
using forde::load_tile;
using forde::probs;
using forde::round_to;
using forde::tile_dot;
using forde::tile_mac;
using forde::visible;

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 thread grid (fp32 route)
constexpr int TC_THREADS = 128;  // 4 warps of 16 rows (bf16 route)
constexpr int LP = BK + 1;    // pitch of a 64 x 64 tile of p or ds

template <int D>
constexpr size_t dq_smem_bytes() {
  return (2 * BQ * (D + 1) + BK * (D + 1) + BQ * LP + 2 * BQ) * sizeof(float);
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * LP + 2 * BQ) *
         sizeof(float);
}

// Two stages of two 64 x D bf16 tiles: K and V (dq), or Q and dO plus
// their lse and delta (dk/dv, which also holds its own K and V tiles).
template <int D>
constexpr size_t tc_dq_smem_bytes() {
  return 4 * BK * D * sizeof(__nv_bfloat16);
}

template <int D>
constexpr size_t tc_dkdv_smem_bytes() {
  return 6 * BK * D * sizeof(__nv_bfloat16) + 4 * BQ * sizeof(float);
}

__device__ __forceinline__ int key_count(const int* lens, int b, int S,
                                         int kv_bound) {
  int kv_len = S;
  if (lens != nullptr) kv_len = min(kv_len, lens[b]);
  if (kv_bound >= 0) kv_len = min(kv_len, kv_bound);
  return kv_len;
}

// Key tiles [j_begin, j_end) hold every key some row of the q tile at q0
// sees; with none, dq is 0 and so is delta.
__device__ __forceinline__ void key_tiles(int q0, int S, int kv_len,
                                          int causal, int window,
                                          int& j_begin, int& j_end) {
  const int q_last = min(q0 + BQ, S) - 1;
  int end_col = kv_len;
  if (causal) end_col = min(end_col, q_last + 1);
  j_begin = window >= 0 ? max(0, q0 - window + 1) / BK : 0;
  j_end = (end_col + BK - 1) / BK;
}

// Query tiles [i_begin, i_end) hold every row that sees some key of the
// key tile at k0; with none (all keys past kv_len), dk and dv are 0.
__device__ __forceinline__ void query_tiles(int k0, int S, int kv_len,
                                            int causal, int window,
                                            int& i_begin, int& i_end) {
  i_begin = causal ? k0 / BQ : 0;
  i_end = k0 < kv_len ? (S + BQ - 1) / BQ : 0;
  if (window >= 0)
    i_end = min(i_end, (min(S, k0 + BK - 1 + window) + BQ - 1) / BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
mha_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                  const float* __restrict__ lse, const int* __restrict__ lens,
                  T* __restrict__ dqkv, float* __restrict__ delta, int S,
                  int H, float scale, int causal, int window, int kv_bound) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;

  extern __shared__ float smem[];
  float* q_s = smem;               // BQ x LD
  float* do_s = q_s + BQ * LD;     // BQ x LD
  float* kv_s = do_s + BQ * LD;    // BK x LD: K, then V, then K of a tile
  float* ds_s = kv_s + BK * LD;    // BQ x LP
  float* lse_s = ds_s + BQ * LP;   // BQ
  float* delta_s = lse_s + BQ;     // BQ

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  const long long stride = 3LL * H * D;
  const long long hd = (long long)H * D;
  const T* base = qkv + (long long)b * S * stride;
  const T* q_g = base + (long long)h * D;
  const T* k_g = base + (long long)(H + h) * D;
  const T* v_g = base + (long long)(2 * H + h) * D;
  const T* do_g = dout + (long long)b * S * hd + (long long)h * D;
  const long long row_bh = ((long long)b * H + h) * S;

  const int kv_len = key_count(lens, b, S, kv_bound);
  int j_begin, j_end;
  key_tiles(q0, S, kv_len, causal, window, j_begin, j_end);

  load_tile<T, D, THREADS>(q_s, q_g, q0, S, stride);
  load_tile<T, D, THREADS>(do_s, do_g, q0, S, hd);
  if (tid < BQ) lse_s[tid] = q0 + tid < S ? lse[row_bh + q0 + tid] : 0.f;

  // Walk 1: delta = sum_c p * dp of rows ty + 16i.
  float dsum[4] = {0.f, 0.f, 0.f, 0.f};
  float p[4][4], dp[4][4];
  for (int jt = j_begin; jt < j_end; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();
    load_tile<T, D, THREADS>(kv_s, k_g, k0, S, stride);
    __syncthreads();
    probs<D>(p, q_s, kv_s, lse_s, q0, k0, S, kv_len, causal, window, scale,
             tx, ty);
    __syncthreads();
    load_tile<T, D, THREADS>(kv_s, v_g, k0, S, stride);
    __syncthreads();
    tile_dot<D>(dp, do_s, kv_s, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dsum[i] = fmaf(p[i][j], dp[i][j], dsum[i]);
  }
  // The 16 threads of a row are lanes tx = 0..15 of one half-warp.
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], off);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      delta_s[r] = dsum[i];
      if (q0 + r < S) delta[row_bh + q0 + r] = dsum[i];
    }
  }

  // Walk 2: ds, and dq = ds k for rows ty + 16i, columns tx + 16j.
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  for (int jt = j_begin; jt < j_end; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();  // delta_s is written; the last tile is done with kv_s
    load_tile<T, D, THREADS>(kv_s, k_g, k0, S, stride);
    __syncthreads();
    probs<D>(p, q_s, kv_s, lse_s, q0, k0, S, kv_len, causal, window, scale,
             tx, ty);
    __syncthreads();
    load_tile<T, D, THREADS>(kv_s, v_g, k0, S, stride);
    __syncthreads();
    tile_dot<D>(dp, do_s, kv_s, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ds_s[r * LP + tx + 16 * j] =
            round_to<T>(p[i][j] * (dp[i][j] - delta_s[r]) * scale);
    }
    __syncthreads();
    load_tile<T, D, THREADS>(kv_s, k_g, k0, S, stride);
    __syncthreads();
    tile_mac<D, LP, 1>(acc, ds_s, kv_s, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= S) continue;
    T* row = dqkv + ((long long)b * S + qr) * stride + (long long)h * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = from_float<T>(acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
mha_bwd_dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ lens, T* __restrict__ dqkv, int S,
                    int H, float scale, int causal, int window, int kv_bound) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;

  extern __shared__ float smem[];
  float* k_s = smem;                // BK x LD
  float* v_s = k_s + BK * LD;       // BK x LD
  float* q_s = v_s + BK * LD;       // BQ x LD
  float* do_s = q_s + BQ * LD;      // BQ x LD
  float* p_s = do_s + BQ * LD;      // BQ x LP: round(p), then ds
  float* lse_s = p_s + BQ * LP;     // BQ
  float* delta_s = lse_s + BQ;      // BQ

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  const long long stride = 3LL * H * D;
  const long long hd = (long long)H * D;
  const T* base = qkv + (long long)b * S * stride;
  const T* q_g = base + (long long)h * D;
  const T* k_g = base + (long long)(H + h) * D;
  const T* v_g = base + (long long)(2 * H + h) * D;
  const T* do_g = dout + (long long)b * S * hd + (long long)h * D;
  const long long row_bh = ((long long)b * H + h) * S;

  const int kv_len = key_count(lens, b, S, kv_bound);
  int i_begin, i_end;
  query_tiles(k0, S, kv_len, causal, window, i_begin, i_end);

  load_tile<T, D, THREADS>(k_s, k_g, k0, S, stride);
  load_tile<T, D, THREADS>(v_s, v_g, k0, S, stride);

  // dk and dv of keys ty + 16i, columns tx + 16j.
  float acc_dk[4][DJ], acc_dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  float p[4][4], ds[4][4];
  for (int it = i_begin; it < i_end; ++it) {
    const int q0 = it * BQ;
    __syncthreads();  // the last tile is done with q_s, do_s and p_s
    load_tile<T, D, THREADS>(q_s, q_g, q0, S, stride);
    load_tile<T, D, THREADS>(do_s, do_g, q0, S, hd);
    if (tid < BQ) {
      const bool in = q0 + tid < S;
      lse_s[tid] = in ? lse[row_bh + q0 + tid] : 0.f;
      delta_s[tid] = in ? delta[row_bh + q0 + tid] : 0.f;
    }
    __syncthreads();
    // Rows q0 + ty + 16i, keys k0 + tx + 16j.
    probs<D>(p, q_s, k_s, lse_s, q0, k0, S, kv_len, causal, window, scale,
             tx, ty);
    tile_dot<D>(ds, do_s, v_s, tx, ty);  // dp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ds[i][j] = round_to<T>(p[i][j] * (ds[i][j] - delta_s[r]) * scale);
        p_s[r * LP + tx + 16 * j] = round_to<T>(p[i][j]);
      }
    }
    __syncthreads();
    tile_mac<D, 1, LP>(acc_dv, p_s, do_s, tx, ty);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p_s[(ty + 16 * i) * LP + tx + 16 * j] = ds[i][j];
    __syncthreads();
    tile_mac<D, 1, LP>(acc_dk, p_s, q_s, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= S) continue;
    T* row = dqkv + ((long long)b * S + kr) * stride;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      row[(long long)(H + h) * D + tx + 16 * j] = from_float<T>(acc_dk[i][j]);
      row[(long long)(2 * H + h) * D + tx + 16 * j] = from_float<T>(acc_dv[i][j]);
    }
  }
}

// The bf16 route's dq kernel. Warp w owns query rows q0 + 16w ..
// q0 + 16w + 15; lane (g, t) holds rows r0 = q0 + 16w + g and r1 = r0 + 8
// and, of each n8 tile j of a product, cols 8j + 2t and 8j + 2t + 1.
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
mha_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const int* __restrict__ lens,
                     __nv_bfloat16* __restrict__ dqkv,
                     float* __restrict__ delta, int S, int H, float scale,
                     int causal, int window, int kv_bound) {
  using namespace forde::mma;
  constexpr int KD = D / 16;  // k-steps over the head dim
  constexpr int ND = D / 8;   // n8 tiles of dq
  // Keys per chunk of a tile: at D = 64 chunks of 16 ran faster than
  // chunks of 32 on the H100; at D = 128 the reverse.
  constexpr int KC = D == 128 ? 32 : 16;
  constexpr int NJ = KC / 8;  // n8 tiles of a chunk's s and dp
  // Stage st of the ring: its K tile at smem + st * STAGE, its V tile
  // BK * D after it. Until their fragments are loaded, q and do sit in
  // stage 1.
  constexpr int STAGE = 2 * BK * D;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* const smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* const q_s = smem + STAGE;
  bf16* const do_s = q_s + BK * D;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const long long stride = 3LL * H * D;
  const long long hd = (long long)H * D;
  const bf16* base = qkv + (long long)b * S * stride;
  const bf16* q_g = base + (long long)h * D;
  const bf16* k_g = base + (long long)(H + h) * D;
  const bf16* v_g = base + (long long)(2 * H + h) * D;
  const bf16* do_g = dout + (long long)b * S * hd + (long long)h * D;
  const long long row_bh = ((long long)b * H + h) * S;

  const int kv_len = key_count(lens, b, S, kv_bound);
  int j_begin, j_end;
  key_tiles(q0, S, kv_len, causal, window, j_begin, j_end);
  const int n = max(0, j_end - j_begin);
  const int steps = 2 * n;  // walk 1, then walk 2, over the same tiles

  load_tile_async<D, TC_THREADS>(q_s, q_g, q0, S, stride);
  load_tile_async<D, TC_THREADS>(do_s, do_g, q0, S, hd);
  if (n > 0) {
    load_tile_async<D, TC_THREADS>(smem, k_g, j_begin * BK, S, stride);
    load_tile_async<D, TC_THREADS>(smem + BK * D, v_g, j_begin * BK, S, stride);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int wrow = 16 * warp;
  // A warp whose rows all lie at or past S does no products.
  const bool active = q0 + wrow < S;
  const int r0 = q0 + wrow + g, r1 = r0 + 8;
  uint32_t qf[KD][4], df[KD][4];
  // p = exp(s * scale - lse) = 2^(s * scale * log2(e) - lse * log2(e)).
  const float scale_log2 = scale * LOG2E;
  float lse0 = 0.f, lse1 = 0.f;  // log2 units
  if (active) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      load_a<D>(qf[kk], q_s, wrow, kk, lane);
      load_a<D>(df[kk], do_s, wrow, kk, lane);
    }
    if (r0 < S) lse0 = lse[row_bh + r0] * LOG2E;
    if (r1 < S) lse1 = lse[row_bh + r1] * LOG2E;
  }
  __syncthreads();  // stage 1 is free for the ring

  float dsum0 = 0.f, dsum1 = 0.f;  // walk 1: this lane's part of delta
  float delta0 = 0.f, delta1 = 0.f;
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < steps; ++i) {
    const int st = i & 1;
    if (i + 1 < steps) {
      const int kn = (j_begin + (i + 1) % n) * BK;
      bf16* const next = smem + (st ^ 1) * STAGE;
      load_tile_async<D, TC_THREADS>(next, k_g, kn, S, stride);
      load_tile_async<D, TC_THREADS>(next + BK * D, v_g, kn, S, stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (i == n) {  // walk 1 is done: delta of rows r0, r1
      delta0 = quad_sum(dsum0);
      delta1 = quad_sum(dsum1);
    }

    if (active) {
      const int k0 = (j_begin + i % n) * BK;
      const bool walk2 = i >= n;
      const bf16* const k_t = smem + st * STAGE;
      const bf16* const v_t = k_t + BK * D;
      // Every key of the tile visible to every row: no select needed
      // (rows at or past S are never written).
      const bool full = !causal && window < 0 && k0 + BK <= kv_len;
#pragma unroll
      for (int c = 0; c < BK / KC; ++c) {  // chunks of KC keys
        const int kc0 = KC * c;
        float s[NJ][4], dp[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
          dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
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
            mma_bf16(dp[2 * np], df[kk], bb[0], bb[1]);
            mma_bf16(dp[2 * np + 1], df[kk], bb[2], bb[3]);
          }
        }
        // p = exp(s * scale - lse), SELECTED to 0 where masked (lse is
        // -1e30 on a row with no visible key: exp() is inf there).
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kc = k0 + kc0 + 8 * j + 2 * t + e;
            const float p0 = exp2_approx(fmaf(s[j][e], scale_log2, -lse0));
            const float p1 = exp2_approx(fmaf(s[j][2 + e], scale_log2, -lse1));
            s[j][e] = full || (r0 < S && visible(r0, kc, kv_len, causal, window)) ? p0 : 0.f;
            s[j][2 + e] = full || (r1 < S && visible(r1, kc, kv_len, causal, window)) ? p1 : 0.f;
          }
        }
        if (!walk2) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dsum0 += s[j][0] * dp[j][0] + s[j][1] * dp[j][1];
            dsum1 += s[j][2] * dp[j][2] + s[j][3] * dp[j][3];
          }
        } else {
          // ds = round(p (dp - delta) scale): the A operand of ds k.
          uint32_t dsf[NJ / 2][4];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dsf[j >> 1][(j & 1) * 2] =
                pack_bf16x2(s[j][0] * (dp[j][0] - delta0) * scale,
                            s[j][1] * (dp[j][1] - delta0) * scale);
            dsf[j >> 1][(j & 1) * 2 + 1] =
                pack_bf16x2(s[j][2] * (dp[j][2] - delta1) * scale,
                            s[j][3] * (dp[j][3] - delta1) * scale);
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
    if (r0 < S) delta[row_bh + r0] = delta0;
    if (r1 < S) delta[row_bh + r1] = delta1;
  }
  // The ring is idle: stage 0's K tile takes this warp's rows of dq.
  stage_rows<D>(smem, acc, wrow, 1.f, 1.f, lane);
  __syncwarp();
  store_rows<D>(dqkv + (long long)b * S * stride + (long long)h * D, stride,
                smem, wrow, q0 + wrow, S, lane);
}

// Q and dO of the query tile at q0, with its lse and delta, into stage st
// of the dk/dv kernel's ring (rows at or past S zero).
template <int D>
__device__ __forceinline__ void load_query_stage(
    __nv_bfloat16* ring, float* stat, int st, const __nv_bfloat16* q_g,
    const __nv_bfloat16* do_g, const float* lse_bh, const float* delta_bh,
    int q0, int S, long long stride, long long hd) {
  using namespace forde::mma;
  bf16* const q_t = ring + st * 2 * BQ * D;
  load_tile_async<D, TC_THREADS>(q_t, q_g, q0, S, stride);
  load_tile_async<D, TC_THREADS>(q_t + BQ * D, do_g, q0, S, hd);
  float* const stat_t = stat + st * 2 * BQ;
  const int r = threadIdx.x;
  if (r < BQ) {
    const bool ok = q0 + r < S;
    cp_async_4(stat_t + r, ok ? lse_bh + q0 + r : lse_bh, ok);
    cp_async_4(stat_t + BQ + r, ok ? delta_bh + q0 + r : delta_bh, ok);
  }
}

// The bf16 route's dk/dv kernel. Warp w owns keys k0 + 16w .. k0 + 16w +
// 15; lane (g, t) holds keys kr0 = k0 + 16w + g and kr1 = kr0 + 8 and, of
// each n8 tile j of a transposed product, query cols 8j + 2t, 8j + 2t + 1.
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
mha_bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int* __restrict__ lens,
                       __nv_bfloat16* __restrict__ dqkv, int S, int H,
                       float scale, int causal, int window, int kv_bound) {
  using namespace forde::mma;
  constexpr int KD = D / 16;  // k-steps over the head dim
  constexpr int ND = D / 8;   // n8 tiles of dk and dv
  constexpr int QC = 32;      // queries per chunk of a tile
  constexpr int NJ = QC / 8;  // n8 tiles of a chunk's s^T and dp^T
  // Stage st of the ring: its Q tile at ring + st * STAGE, its dO tile
  // BQ * D after it; their lse at stat + st * 2 * BQ, delta BQ after it.
  constexpr int STAGE = 2 * BQ * D;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* const k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* const v_s = k_s + BK * D;
  bf16* const ring = v_s + BK * D;
  float* const stat = reinterpret_cast<float*>(ring + 2 * STAGE);

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const long long stride = 3LL * H * D;
  const long long hd = (long long)H * D;
  const bf16* base = qkv + (long long)b * S * stride;
  const bf16* q_g = base + (long long)h * D;
  const bf16* k_g = base + (long long)(H + h) * D;
  const bf16* v_g = base + (long long)(2 * H + h) * D;
  const bf16* do_g = dout + (long long)b * S * hd + (long long)h * D;
  const long long row_bh = ((long long)b * H + h) * S;
  const float* lse_bh = lse + row_bh;
  const float* delta_bh = delta + row_bh;

  const int kv_len = key_count(lens, b, S, kv_bound);
  int i_begin, i_end;
  query_tiles(k0, S, kv_len, causal, window, i_begin, i_end);
  const int n = max(0, i_end - i_begin);

  load_tile_async<D, TC_THREADS>(k_s, k_g, k0, S, stride);
  load_tile_async<D, TC_THREADS>(v_s, v_g, k0, S, stride);
  if (n > 0)
    load_query_stage<D>(ring, stat, 0, q_g, do_g, lse_bh, delta_bh,
                        i_begin * BQ, S, stride, hd);
  cp_async_commit();

  const int wrow = 16 * warp;
  // A warp whose keys all lie at or past S does no products.
  const bool active = k0 + wrow < S;
  const int kr0 = k0 + wrow + g, kr1 = kr0 + 8;
  const float scale_log2 = scale * LOG2E;
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }

  for (int i = 0; i < n; ++i) {
    const int st = i & 1;
    if (i + 1 < n) {
      load_query_stage<D>(ring, stat, st ^ 1, q_g, do_g, lse_bh, delta_bh,
                          (i_begin + i + 1) * BQ, S, stride, hd);
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
      const float* const lse_t = stat + st * 2 * BQ;
      const float* const dl_t = lse_t + BQ;
      // Every row of the tile sees every key of this block: no select.
      const bool full = !causal && window < 0 && k0 + BK <= kv_len && q0 + BQ <= S;
      // Not unrolled: two chunks in flight at once would take more than
      // 255 registers beside the dk and dv accumulators.
#pragma unroll 1
      for (int c = 0; c < BQ / QC; ++c) {  // chunks of QC queries
        const int qc0 = QC * c;
        float s[NJ][4], dp[NJ][4];  // s^T and dp^T: keys x queries
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
          dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
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
            mma_bf16(dp[2 * np], a, bb[0], bb[1]);
            mma_bf16(dp[2 * np + 1], a, bb[2], bb[3]);
          }
        }
        // p^T = exp(s^T * scale - lse), SELECTED to 0 where masked, and
        // ds^T = p^T (dp^T - delta) scale; both rounded to bf16 as the A
        // operands of p^T do and ds^T q.
        uint32_t pf[NJ / 2][4], dsf[NJ / 2][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = qc0 + 8 * j + 2 * t + e;  // query within the tile
            const int qr = q0 + cl;
            const float lq = lse_t[cl] * LOG2E, dq = dl_t[cl];
            const bool in = qr < S;
            const float e0 = exp2_approx(fmaf(s[j][e], scale_log2, -lq));
            const float e1 = exp2_approx(fmaf(s[j][2 + e], scale_log2, -lq));
            p[e] = full || (in && visible(qr, kr0, kv_len, causal, window)) ? e0 : 0.f;
            p[2 + e] = full || (in && visible(qr, kr1, kv_len, causal, window)) ? e1 : 0.f;
            ds[e] = p[e] * (dp[j][e] - dq) * scale;
            ds[2 + e] = p[2 + e] * (dp[j][2 + e] - dq) * scale;
          }
          pf[j >> 1][(j & 1) * 2] = pack_bf16x2(p[0], p[1]);
          pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(p[2], p[3]);
          dsf[j >> 1][(j & 1) * 2] = pack_bf16x2(ds[0], ds[1]);
          dsf[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
        }
#pragma unroll
        for (int kk = 0; kk < NJ / 2; ++kk) {
#pragma unroll
          for (int np = 0; np < KD; ++np) {
            uint32_t bb[4];
            load_bt<D>(bb, do_t, qc0 + 16 * kk, np, lane);
            mma_bf16(dv[2 * np], pf[kk], bb[0], bb[1]);
            mma_bf16(dv[2 * np + 1], pf[kk], bb[2], bb[3]);
            load_bt<D>(bb, q_t, qc0 + 16 * kk, np, lane);
            mma_bf16(dk[2 * np], dsf[kk], bb[0], bb[1]);
            mma_bf16(dk[2 * np + 1], dsf[kk], bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();  // stage st is free for tile i + 2
  }

  cp_async_wait<0>();  // K and V when no query tile sees this block
  __syncthreads();
  if (!active) return;
  // The ring is idle: stage 0 takes this warp's rows of dk and dv.
  stage_rows<D>(ring, dk, wrow, 1.f, 1.f, lane);
  stage_rows<D>(ring + BQ * D, dv, wrow, 1.f, 1.f, lane);
  __syncwarp();
  bf16* const out = dqkv + (long long)b * S * stride;
  store_rows<D>(out + (long long)(H + h) * D, stride, ring, wrow, k0 + wrow, S,
                lane);
  store_rows<D>(out + (long long)(2 * H + h) * D, stride, ring + BQ * D, wrow,
                k0 + wrow, S, lane);
}

template <int D>
cudaError_t launch_tc(const void* qkv, const void* dout, const void* lse,
                      const void* lens, void* dqkv, void* delta, int batch,
                      int seq, int heads, float scale, int causal, int window,
                      int kv_bound, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr size_t smem_dq = tc_dq_smem_bytes<D>();
  constexpr size_t smem_dkdv = tc_dkdv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mha_bwd_dkdv_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + 63) / 64, heads, batch);
  mha_bwd_dq_tc_kernel<D><<<grid, TC_THREADS, smem_dq, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const int*>(lens),
      static_cast<bf16*>(dqkv), static_cast<float*>(delta), seq, heads, scale,
      causal, window, kv_bound);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mha_bwd_dkdv_tc_kernel<D><<<grid, TC_THREADS, smem_dkdv, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(lens), static_cast<bf16*>(dqkv), seq, heads,
      scale, causal, window, kv_bound);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* qkv, const void* dout, const void* lse,
                   const void* lens, void* dqkv, void* delta, int batch,
                   int seq, int heads, float scale, int causal, int window,
                   int kv_bound, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_smem_bytes<D>();
  constexpr size_t smem_dkdv = dkdv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mha_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + 63) / 64, heads, batch);
  mha_bwd_dq_kernel<T, D><<<grid, THREADS, smem_dq, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const int*>(lens),
      static_cast<T*>(dqkv), static_cast<float*>(delta), seq, heads, scale,
      causal, window, kv_bound);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mha_bwd_dkdv_kernel<T, D><<<grid, THREADS, smem_dkdv, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(lens), static_cast<T*>(dqkv), seq, heads, scale,
      causal, window, kv_bound);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA-core route), 1 = bfloat16 (tensor-core route;
// qkv, do and dqkv 16-byte aligned). qkv, do and dqkv are in that type;
// lse and the delta scratch are (B, H, S) fp32. lens may be null (no
// per-sample lengths); window < 0 and kv_bound < 0 mean none. Returns the
// CUDA error code of the launches (0 on success).
int forde_flash_mha_bwd(const void* qkv, const void* dout, const void* lse,
                        const void* lens, void* dqkv, void* delta, int batch,
                        int seq, int heads, int head_dim, int dtype,
                        float scale, int causal, int window, int kv_bound,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FORDE_BWD_LAUNCH(T, D)                                             \
  return launch<T, D>(qkv, dout, lse, lens, dqkv, delta, batch, seq, heads, \
                      scale, causal, window, kv_bound, st)
#define FORDE_BWD_LAUNCH_TC(D)                                            \
  return launch_tc<D>(qkv, dout, lse, lens, dqkv, delta, batch, seq, heads, \
                      scale, causal, window, kv_bound, st)
  if (dtype == 0 && head_dim == 64) FORDE_BWD_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) FORDE_BWD_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) FORDE_BWD_LAUNCH_TC(64);
  if (dtype == 1 && head_dim == 128) FORDE_BWD_LAUNCH_TC(128);
#undef FORDE_BWD_LAUNCH
#undef FORDE_BWD_LAUNCH_TC
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
