// 4-D flash-attention backward for Hopper (sm_90a): two kernels, dq and
// dk/dv.
//
// Replaces four TPU kernels of forde_tpu/ops/flash_attention.py, the
// gradient of flash_fwd.cu: the resident `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (S <= 4096, full-S arrays held in VMEM, launched by
// `_bwd_pallas`) and the streaming `_bwd_dq_stream_kernel` and
// `_bwd_dkv_stream_kernel` (S > 4096, causal, launched by
// `_bwd_stream_pallas`). The split came from VMEM size; these kernels read
// tiles from device memory at any S, so one pair serves both routes. The
// decoder LM's training step runs them once per layer: the NSA local
// (sliding-window) branch, or the dense causal attention with --no_nsa.
//
// What they compute, with the TPU kernels' arithmetic, on contiguous
// (B, H, S, D) q, k, v and do (S a multiple of 64; the wrapper pads S and
// D), the forward's row log-sum-exp lse (B, H, S) fp32 and delta (B, H, S)
// fp32, which the wrapper computes outside the kernels as the TPU code
// does: rowsum(do * o) in fp32 from the saved o, minus the lse cotangent
// when one is given. For each (sample, head):
//   p  = exp(q k^T * scale - lse), SELECTED to 0 where the key is masked
//        (the forward's mask, common.cuh `visible`: causal q >= k, window
//        q - k < window, static kv_len);
//   dp = do v^T;  ds = p * (dp - delta) * scale, rounded to the input type;
//   dq = ds k,  dk = ds^T q,  dv = round(p)^T do with p rounded to the
//   input type; products are fp32 multiplies of the (rounded) values
//   summed in fp32, and dq, dk, dv are written in the input type.
//
// Bound on the H100 at the training shape (B=8, H=8, S=2048, D=64, bf16,
// causal, window 512): the dk/dv kernel reads q, k, v, do, lse and delta
// once and writes dk and dv once: ~101 MB, ~30 us at 3.35 TB/s; its four
// products are 8 * D operations per visible (query, key) pair over ~0.92M
// pairs per head: ~30 GFLOP, ~30 us at 989 TFLOP/s. So bytes and products
// are close. The dq kernel moves ~85 MB (~25 us) and does three products
// (~23 GFLOP, ~23 us).
//
// FA-2's split, each kernel with one block per (tile of 64, head, sample):
//   * dq: the block owns 64 query rows and walks the key tiles inside the
//     causal / window / kv_len span (as `_loop_bounds` bounds them);
//   * dk/dv: the block owns 64 keys and walks the query tiles from the
//     diagonal (causal) to the one holding k_start + 63 + window - 1, as
//     `_bwd_dkv_kernel` bounds them.
// Each output tile has one owner, so no sum crosses blocks: no atomics, and
// the result is deterministic.
//
// dq, bf16 route (flash_bwd_dq_tc_kernel): the tensor cores
// (mma.sync.m16n8k16, fp32 accumulators), flash_fwd.cu's walk with the
// dk/dv kernel's arithmetic. 4 warps, each owning 16 of the block's 64
// query rows, whose q and do A fragments stay in registers for the whole
// walk, and each lane its two rows' lse (log2 units) and delta. K and V
// tiles come through a cp.async ring (three stages at D = 64, two at
// D = 128) into XOR-swizzled shared memory. Per key tile, s = q k^T and
// dp = do v^T (K and V by ldmatrix as B operands) land in accumulator
// fragments; p = 2^(s scale log2(e) - lse log2(e)) on the special-function
// unit, selected to 0 where masked; ds = round(p (dp - delta) scale) is
// formed and packed to bf16 in registers (the accumulator layout of s is
// the A operand layout of ds), and dq += ds k with K read transposed.
// 3 products per tile, and p and ds never touch shared memory. The walk
// is the forward's: `key_tiles` and the per-warp interior split
// `interior_tiles` of common.cuh (`_loop_bounds`,
// forde_tpu/ops/flash_attention.py:212-214,244-246), so the select runs
// only on a warp's edge tiles. At D = 64 a key tile goes in one piece; at
// D = 128, where dq's accumulator (64 registers) and the q and do
// fragments (64) leave little room, in two halves of 32 keys. dq leaves
// through the q tile's shared memory in 16-byte stores.
//   Registers (ptxas): 168 at D = 64 (3 blocks an SM, 64 KB of shared
// memory each), 242 at D = 128 (2 blocks an SM, 96 KB); no spills. What
// bounds it now (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): 0.120 ms
// of device time at the training shape (1.16 ms on the CUDA cores before),
// 4.7x its bound; 0.16x SDPA's whole backward; useful products at ~188
// TFLOP/s (22.6 GFLOP), bytes at ~21% of the HBM rate. Like the dk/dv
// kernel and the forward, mma.sync from 12 warps an SM is latency-bound.
//
// dk/dv, bf16 route (flash_bwd_dkv_tc_kernel): the tensor cores
// (mma.sync.m16n8k16 with fp32 accumulators: exact bf16 products, only
// the order of summation changes), flash_mha_bwd.cu's dk/dv design on this
// layout. 4 warps, each owning 16 of the block's keys. s^T = k q^T puts
// p^T in the accumulator layout that is the A operand of dv += round(p^T)
// do; dp^T = v do^T, ds^T = round(p^T (dp^T - delta) scale) is formed in
// registers and is the A operand of dk += ds^T q: 4 products per tile pair,
// and p and ds never touch shared memory. Q and dO tiles, with their lse
// and delta, come through a cp.async ring (three stages at D = 64, two at
// D = 128) into XOR-swizzled shared memory, read with ldmatrix both ways
// round; lse and delta are broadcast per column from shared memory. At
// D = 64 the K and V A fragments stay in registers for the whole walk (32
// registers); at D = 128, where the dk and dv accumulators alone take 128
// registers a thread, they come from shared memory by ldmatrix. A 64-query
// tile goes in two chunks of 32 queries, one after the other. p = exp()
// runs as 2^x on the special-function unit, in log2 units. The select runs
// only on the edge tiles: the interior split of `_bwd_dkv_kernel`
// (forde_tpu/ops/flash_attention.py:272-287), taken per warp (16 keys),
// gives the query tiles in which every (query, key) pair of the warp is
// visible. dk and dv leave through shared memory in 16-byte stores.
//   Registers (ptxas): 167 at D = 64 (3 blocks an SM, 66 KB of shared
// memory each), 242 at D = 128 (2 blocks an SM, 97 KB); no spills. What
// bounds it now (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): 0.159 ms of
// device time at the training shape, 5.2x its bound; 0.22x SDPA's whole
// backward; useful products at ~189 TFLOP/s, bytes at ~19% of the HBM
// rate. As in the forward, mma.sync from 12 warps an SM is latency-bound.
//
// fp32 (both kernels): the CUDA cores, with one block of 16 x 16
// threads; tiles sit in shared memory as fp32 with row pitch D + 1
// (conflict-free column reads), and p and ds go through shared memory
// (`probs`, `tile_dot`, `tile_mac` of common.cuh). fp32 stays there since
// the tensor cores would round it to TF32; it runs only in checks and
// parity runs.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using forde::floor_div;
using forde::interior_tiles;
using forde::key_tiles;
using forde::load_tile;
using forde::probs;
using forde::tile_dot;
using forde::tile_mac;
using forde::visible;

constexpr int BQ = 64;               // query rows per tile
constexpr int BK = forde::FLASH_BK;  // keys per tile
constexpr int THREADS = 256;  // 16 x 16 thread grid (CUDA-core kernels)
constexpr int TC_THREADS = 128;  // 4 warps of 16 keys or query rows (bf16)
constexpr int LP = BK + 1;    // pitch of a 64 x 64 tile of p or ds

// Both CUDA-core kernels: four 64 x (D + 1) tiles, one 64 x 65 tile, lse
// and delta.
template <int D>
constexpr size_t smem_bytes() {
  return (4 * 64 * (D + 1) + 64 * LP + 2 * 64) * sizeof(float);
}

// The bf16 kernels: stages of their rings; the dk/dv kernel's shared
// memory (the K and V tiles, then per stage a Q and a dO tile and their
// lse and delta), the dq kernel's (the Q and dO tiles, then per stage a K
// and a V tile), and the keys the dq kernel takes at a time (a whole tile
// at D = 64; at D = 128, where dq's accumulator and the q and do fragments
// take 128 registers a thread, two halves in turn).
template <int D>
__host__ __device__ constexpr int tc_stages() {
  return D == 128 ? 2 : 3;
}

template <int D>
__host__ __device__ constexpr int tc_dq_keys() {
  return D == 128 ? 32 : 64;
}

template <int D>
constexpr size_t tc_dq_smem_bytes() {
  return (2 + 2 * tc_stages<D>()) * BK * D * sizeof(__nv_bfloat16);
}

template <int D>
constexpr size_t tc_dkv_smem_bytes() {
  return (2 + 2 * tc_stages<D>()) * BK * D * sizeof(__nv_bfloat16) +
         tc_stages<D>() * 2 * BQ * sizeof(float);
}

// Query tiles [i_begin, i_end) hold every row that sees some key of the
// key tile at k0 (`_bwd_dkv_kernel`'s bounds); with none (all keys past
// kv_len), dk and dv are 0.
__device__ __forceinline__ void query_tiles(int k0, int S, int keys,
                                            int causal, int window,
                                            int& i_begin, int& i_end) {
  i_begin = causal ? k0 / BQ : 0;
  i_end = k0 < keys ? S / BQ : 0;
  if (window >= 0) i_end = min(i_end, (k0 + BK - 1 + window - 1) / BQ + 1);
}

// `_bwd_dkv_kernel`'s interior split: of the walked query tiles
// [i_begin, i_end), those in [fs, fe) have every (query, key) pair of keys
// [c0, c0 + cols) visible.
__device__ __forceinline__ void interior_query_tiles(int c0, int cols,
                                                     int i_begin, int i_end,
                                                     int keys, int causal,
                                                     int window, int& fs,
                                                     int& fe) {
  fs = i_begin;
  fe = i_end;
  if (causal) fs = max(fs, -floor_div(-(c0 + cols - 1), BQ));
  if (window >= 0) fe = min(fe, floor_div(c0 + window - BQ, BQ) + 1);
  if (c0 + cols > keys) fe = fs;
  fs = min(max(fs, i_begin), i_end);
  fe = min(max(fe, fs), i_end);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, float scale, int causal, int window, int kv_len) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;

  extern __shared__ float smem[];
  float* q_s = smem;              // BQ x LD
  float* do_s = q_s + BQ * LD;    // BQ x LD
  float* k_s = do_s + BQ * LD;    // BK x LD
  float* v_s = k_s + BK * LD;     // BK x LD
  float* ds_s = v_s + BK * LD;    // BQ x LP
  float* lse_s = ds_s + BQ * LP;  // BQ
  float* delta_s = lse_s + BQ;    // BQ

  const int q0 = blockIdx.x * BQ;
  const long long bh = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long base = bh * S * D;

  const int keys = kv_len >= 0 ? min(kv_len, S) : S;
  int j_begin, j_end;
  key_tiles(q0, BQ, S, causal, window, kv_len, j_begin, j_end);

  load_tile<float, D, THREADS>(q_s, q + base, q0, S, D);
  load_tile<float, D, THREADS>(do_s, dout + base, q0, S, D);
  if (tid < BQ) {
    lse_s[tid] = lse[bh * S + q0 + tid];
    delta_s[tid] = delta[bh * S + q0 + tid];
  }

  // dq of rows ty + 16i, columns tx + 16j.
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  float p[4][4], dp[4][4];
  for (int jt = j_begin; jt < j_end; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();  // the previous tile is done with k_s, v_s and ds_s
    load_tile<float, D, THREADS>(k_s, k + base, k0, S, D);
    load_tile<float, D, THREADS>(v_s, v + base, k0, S, D);
    __syncthreads();
    probs<D>(p, q_s, k_s, lse_s, q0, k0, S, keys, causal, window, scale, tx,
             ty);
    tile_dot<D>(dp, do_s, v_s, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ds_s[r * LP + tx + 16 * j] = p[i][j] * (dp[i][j] - delta_s[r]) * scale;
    }
    __syncthreads();
    tile_mac<D, LP, 1>(acc, ds_s, k_s, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = dq + base + (long long)(q0 + ty + 16 * i) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = acc[i][j];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int S, float scale, int causal,
                     int window, int kv_len) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;

  extern __shared__ float smem[];
  float* k_s = smem;              // BK x LD
  float* v_s = k_s + BK * LD;     // BK x LD
  float* q_s = v_s + BK * LD;     // BQ x LD
  float* do_s = q_s + BQ * LD;    // BQ x LD
  float* p_s = do_s + BQ * LD;    // BQ x LP: round(p), then ds
  float* lse_s = p_s + BQ * LP;   // BQ
  float* delta_s = lse_s + BQ;    // BQ

  const int k0 = blockIdx.x * BK;
  const long long bh = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long base = bh * S * D;

  const int keys = kv_len >= 0 ? min(kv_len, S) : S;
  int i_begin, i_end;
  query_tiles(k0, S, keys, causal, window, i_begin, i_end);

  load_tile<float, D, THREADS>(k_s, k + base, k0, S, D);
  load_tile<float, D, THREADS>(v_s, v + base, k0, S, D);

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
    load_tile<float, D, THREADS>(q_s, q + base, q0, S, D);
    load_tile<float, D, THREADS>(do_s, dout + base, q0, S, D);
    if (tid < BQ) {
      lse_s[tid] = lse[bh * S + q0 + tid];
      delta_s[tid] = delta[bh * S + q0 + tid];
    }
    __syncthreads();
    // Rows q0 + ty + 16i, keys k0 + tx + 16j.
    probs<D>(p, q_s, k_s, lse_s, q0, k0, S, keys, causal, window, scale, tx,
             ty);
    tile_dot<D>(ds, do_s, v_s, tx, ty);  // dp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ds[i][j] = p[i][j] * (ds[i][j] - delta_s[r]) * scale;
        p_s[r * LP + tx + 16 * j] = p[i][j];
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
    const long long row = base + (long long)(k0 + ty + 16 * i) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[row + tx + 16 * j] = acc_dk[i][j];
      dv[row + tx + 16 * j] = acc_dv[i][j];
    }
  }
}

// Q and dO of the query tile at q0, with its lse and delta, into stage st
// of the bf16 dk/dv kernel's ring, as one commit group.
template <int D>
__device__ __forceinline__ void load_query_stage(
    __nv_bfloat16* ring, float* stat, int st, const __nv_bfloat16* q_g,
    const __nv_bfloat16* do_g, const float* lse_bh, const float* delta_bh,
    int q0, int S) {
  using namespace forde::mma;
  bf16* const q_t = ring + st * 2 * BQ * D;
  load_tile_async<D, TC_THREADS>(q_t, q_g, q0, S, D);
  load_tile_async<D, TC_THREADS>(q_t + BQ * D, do_g, q0, S, D);
  float* const stat_t = stat + st * 2 * BQ;
  const int r = threadIdx.x;
  if (r < BQ) {
    cp_async_4(stat_t + r, lse_bh + q0 + r, true);
    cp_async_4(stat_t + BQ + r, delta_bh + q0 + r, true);
  }
  cp_async_commit();
}

// The bf16 route's dk/dv kernel. Warp w owns keys k0 + 16w .. k0 + 16w +
// 15; lane (g, t) holds keys kr0 = k0 + 16w + g and kr1 = kr0 + 8 and, of
// each n8 tile j of a transposed product, query cols 8j + 2t, 8j + 2t + 1.
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int S, float scale,
                        int causal, int window, int kv_len) {
  using namespace forde::mma;
  constexpr int KD = D / 16;  // k-steps over the head dim
  constexpr int ND = D / 8;   // n8 tiles of dk and dv
  constexpr int QC = 32;      // queries per chunk of a tile
  constexpr int NJ = QC / 8;  // n8 tiles of a chunk's s^T and dp^T
  constexpr int STAGES = tc_stages<D>();
  // K and V A fragments in registers for the whole walk (D = 64), or
  // read from shared memory at every k-step (D = 128).
  constexpr bool KV_IN_REGS = D == 64;
  // Stage st of the ring: its Q tile at ring + st * STAGE, its dO tile
  // BQ * D after it; their lse at stat + st * 2 * BQ, delta BQ after it.
  constexpr int STAGE = 2 * BQ * D;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* const k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* const v_s = k_s + BK * D;
  bf16* const ring = v_s + BK * D;
  float* const stat = reinterpret_cast<float*>(ring + STAGES * STAGE);

  const int k0 = blockIdx.x * BK;
  const long long bh = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const long long base = bh * S * D;
  const bf16* q_g = q + base;
  const bf16* do_g = dout + base;
  const float* lse_bh = lse + bh * S;
  const float* delta_bh = delta + bh * S;

  const int keys = kv_len >= 0 ? min(kv_len, S) : S;
  int i_begin, i_end;
  query_tiles(k0, S, keys, causal, window, i_begin, i_end);
  const int n = max(0, i_end - i_begin);

  const int wrow = 16 * warp;
  // Query tiles [fs, fe) need no select for this warp's keys.
  int fs, fe;
  interior_query_tiles(k0 + wrow, 16, i_begin, i_end, keys, causal, window, fs,
                       fe);

  load_tile_async<D, TC_THREADS>(k_s, k + base, k0, S, D);
  load_tile_async<D, TC_THREADS>(v_s, v + base, k0, S, D);
  if (n == 0) cp_async_commit();  // else with query tile 0
  for (int i = 0; i < STAGES - 1 && i < n; ++i)
    load_query_stage<D>(ring, stat, i, q_g, do_g, lse_bh, delta_bh,
                        (i_begin + i) * BQ, S);

  const int kr0 = k0 + wrow + g, kr1 = kr0 + 8;
  const float scale_log2 = scale * LOG2E;
  uint32_t kf[KD][4], vf[KD][4];  // unused at D = 128
  float dkacc[ND][4], dvacc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    dkacc[j][0] = dkacc[j][1] = dkacc[j][2] = dkacc[j][3] = 0.f;
    dvacc[j][0] = dvacc[j][1] = dvacc[j][2] = dvacc[j][3] = 0.f;
  }

  for (int i = 0; i < n; ++i) {
    // Query tile i (and, with tile 0, K and V) has landed once at most the
    // later tiles are in flight; after the barrier every thread's copies
    // have, and every warp is done with tile i - 1, whose stage takes tile
    // i + STAGES - 1.
    if (i + 1 < n)
      cp_async_wait<STAGES - 2>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if constexpr (KV_IN_REGS) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          load_a<D>(kf[kk], k_s, wrow, kk, lane);
          load_a<D>(vf[kk], v_s, wrow, kk, lane);
        }
      }
    }
    if (i + STAGES - 1 < n)
      load_query_stage<D>(ring, stat, (i + STAGES - 1) % STAGES, q_g, do_g,
                          lse_bh, delta_bh, (i_begin + i + STAGES - 1) * BQ,
                          S);

    const int it = i_begin + i;
    const int q0 = it * BQ;
    const int st = i % STAGES;
    const bf16* const q_t = ring + st * STAGE;
    const bf16* const do_t = q_t + BQ * D;
    const float* const lse_t = stat + st * 2 * BQ;
    const float* const dl_t = lse_t + BQ;
    const bool edge = it < fs || it >= fe;
    // Not unrolled: two chunks in flight at once would take more than 255
    // registers beside the dk and dv accumulators at D = 128.
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
        if constexpr (KV_IN_REGS) {
          a[0] = kf[kk][0], a[1] = kf[kk][1], a[2] = kf[kk][2], a[3] = kf[kk][3];
        } else {
          load_a<D>(a, k_s, wrow, kk, lane);
        }
#pragma unroll
        for (int np = 0; np < NJ / 2; ++np) {
          uint32_t bb[4];
          load_b<D>(bb, q_t, qc0 + 16 * np, kk, lane);
          mma_bf16(s[2 * np], a, bb[0], bb[1]);
          mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
        }
        if constexpr (KV_IN_REGS) {
          a[0] = vf[kk][0], a[1] = vf[kk][1], a[2] = vf[kk][2], a[3] = vf[kk][3];
        } else {
          load_a<D>(a, v_s, wrow, kk, lane);
        }
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
          p[e] = exp2_approx(fmaf(s[j][e], scale_log2, -lq));
          p[2 + e] = exp2_approx(fmaf(s[j][2 + e], scale_log2, -lq));
          if (edge) {
            if (!visible(qr, kr0, keys, causal, window)) p[e] = 0.f;
            if (!visible(qr, kr1, keys, causal, window)) p[2 + e] = 0.f;
          }
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
          mma_bf16(dvacc[2 * np], pf[kk], bb[0], bb[1]);
          mma_bf16(dvacc[2 * np + 1], pf[kk], bb[2], bb[3]);
          load_bt<D>(bb, q_t, qc0 + 16 * kk, np, lane);
          mma_bf16(dkacc[2 * np], dsf[kk], bb[0], bb[1]);
          mma_bf16(dkacc[2 * np + 1], dsf[kk], bb[2], bb[3]);
        }
      }
    }
  }

  cp_async_wait<0>();  // K and V when no query tile sees this block
  __syncthreads();     // every warp is done with the ring
  // Stage 0 takes this warp's rows of dk and dv.
  stage_rows<D>(ring, dkacc, wrow, 1.f, 1.f, lane);
  stage_rows<D>(ring + BQ * D, dvacc, wrow, 1.f, 1.f, lane);
  __syncwarp();
  store_rows<D>(dk + base, D, ring, wrow, k0 + wrow, S, lane);
  store_rows<D>(dv + base, D, ring + BQ * D, wrow, k0 + wrow, S, lane);
}

// The bf16 route's dq kernel: flash_fwd.cu's walk with the dk/dv kernel's
// arithmetic. Warp w owns query rows q0 + 16w .. q0 + 16w + 15; lane (g, t)
// holds rows r0 = q0 + 16w + g and r1 = r0 + 8 and, of each n8 tile j of a
// product, cols 8j + 2t, 8j + 2t + 1.
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int S, float scale,
                       int causal, int window, int kv_len) {
  using namespace forde::mma;
  constexpr int KD = D / 16;  // k-steps over the head dim
  constexpr int ND = D / 8;   // n8 tiles of dq
  constexpr int KC = tc_dq_keys<D>();  // keys per chunk of a key tile
  constexpr int NC = KC / 8;  // n8 tiles of a chunk's s and dp
  constexpr int STAGES = tc_stages<D>();
  // Stage st of the ring: its K tile at ring + st * STAGE, its V tile
  // BK * D after it.
  constexpr int STAGE = 2 * BK * D;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* const q_s = reinterpret_cast<bf16*>(smem_raw);  // then dq on its way out
  bf16* const do_s = q_s + BQ * D;
  bf16* const ring = do_s + BQ * D;

  const int q0 = blockIdx.x * BQ;
  const long long bh = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const long long base = bh * S * D;
  const bf16* k_g = k + base;
  const bf16* v_g = v + base;

  int j_begin, j_end;
  key_tiles(q0, BQ, S, causal, window, kv_len, j_begin, j_end);
  const int n = j_end - j_begin;
  const int keys = kv_len >= 0 ? min(kv_len, S) : S;

  const int wrow = 16 * warp;
  // Key tiles [fs, fe) need no select for this warp's rows.
  int fs, fe;
  interior_tiles(q0 + wrow, 16, j_begin, j_end, causal, window, kv_len, fs, fe);

  // Key tile j_begin + i into stage i % STAGES, as one commit group.
  auto fetch = [&](int i) {
    bf16* const dst = ring + (i % STAGES) * STAGE;
    const int k0 = (j_begin + i) * BK;
    load_tile_async<D, TC_THREADS>(dst, k_g, k0, S, D);
    load_tile_async<D, TC_THREADS>(dst + BK * D, v_g, k0, S, D);
    cp_async_commit();
  };
  load_tile_async<D, TC_THREADS>(q_s, q + base, q0, S, D);  // with tile 0
  load_tile_async<D, TC_THREADS>(do_s, dout + base, q0, S, D);
  for (int i = 0; i < STAGES - 1 && i < n; ++i) fetch(i);

  const int r0 = q0 + wrow + g, r1 = r0 + 8;
  // The keys visible to rows r0 and r1: [lo, hi] (common.cuh `visible`).
  const int lo0 = window >= 0 ? r0 - window + 1 : 0;
  const int lo1 = window >= 0 ? r1 - window + 1 : 0;
  const int hi0 = causal ? min(r0, keys - 1) : keys - 1;
  const int hi1 = causal ? min(r1, keys - 1) : keys - 1;
  // p = exp(s * scale - lse) = 2^(s * scale * log2(e) - lse * log2(e)).
  const float scale_log2 = scale * LOG2E;
  const float lq0 = lse[bh * S + r0] * LOG2E, lq1 = lse[bh * S + r1] * LOG2E;
  const float dl0 = delta[bh * S + r0], dl1 = delta[bh * S + r1];
  uint32_t qf[KD][4], df[KD][4];

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < n; ++i) {
    // This thread's copies of tile i (with tile 0, of q and do) have landed
    // once at most the later tiles are in flight; after the barrier every
    // thread's have, and every warp is done with tile i - 1, whose stage
    // takes tile i + STAGES - 1.
    if (i + 1 < n)
      cp_async_wait<STAGES - 2>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        load_a<D>(qf[kk], q_s, wrow, kk, lane);
        load_a<D>(df[kk], do_s, wrow, kk, lane);
      }
    }
    if (i + STAGES - 1 < n) fetch(i + STAGES - 1);

    const int jt = j_begin + i;
    const int k0 = jt * BK;
    const bf16* const k_t = ring + (i % STAGES) * STAGE;
    const bf16* const v_t = k_t + BK * D;
    const bool edge = jt < fs || jt >= fe;
#pragma unroll
    for (int c = 0; c < BK / KC; ++c) {  // chunks of KC keys
      const int kc0 = KC * c;
      float s[NC][4], dp[NC][4];  // s = q k^T and dp = do v^T: rows x keys
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int np = 0; np < NC / 2; ++np) {
          uint32_t bb[4];
          load_b<D>(bb, k_t, kc0 + 16 * np, kk, lane);
          mma_bf16(s[2 * np], qf[kk], bb[0], bb[1]);
          mma_bf16(s[2 * np + 1], qf[kk], bb[2], bb[3]);
          load_b<D>(bb, v_t, kc0 + 16 * np, kk, lane);
          mma_bf16(dp[2 * np], df[kk], bb[0], bb[1]);
          mma_bf16(dp[2 * np + 1], df[kk], bb[2], bb[3]);
        }
      }
      // p = 2^(s scale log2(e) - lse log2(e)), SELECTED to 0 where masked
      // (a row with no visible key has lse = -1e30, and p is inf there);
      // ds = p (dp - delta) scale, rounded to bf16 as the A operand of
      // ds k.
      uint32_t dsf[NC / 2][4];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float p[4];
        p[0] = exp2_approx(fmaf(s[j][0], scale_log2, -lq0));
        p[1] = exp2_approx(fmaf(s[j][1], scale_log2, -lq0));
        p[2] = exp2_approx(fmaf(s[j][2], scale_log2, -lq1));
        p[3] = exp2_approx(fmaf(s[j][3], scale_log2, -lq1));
        if (edge) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kc = k0 + kc0 + 8 * j + 2 * t + e;
            if (kc < lo0 || kc > hi0) p[e] = 0.f;
            if (kc < lo1 || kc > hi1) p[2 + e] = 0.f;
          }
        }
        dsf[j >> 1][(j & 1) * 2] =
            pack_bf16x2(p[0] * (dp[j][0] - dl0) * scale,
                        p[1] * (dp[j][1] - dl0) * scale);
        dsf[j >> 1][(j & 1) * 2 + 1] =
            pack_bf16x2(p[2] * (dp[j][2] - dl1) * scale,
                        p[3] * (dp[j][3] - dl1) * scale);
      }
      // dq += ds k: k-step kk takes keys kc0 + 16kk .. kc0 + 16kk + 15, K
      // read transposed.
#pragma unroll
      for (int kk = 0; kk < NC / 2; ++kk) {
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

  // This warp's rows of the q tile, read into its fragments at tile 0,
  // take its rows of dq.
  stage_rows<D>(q_s, acc, wrow, 1.f, 1.f, lane);
  __syncwarp();
  store_rows<D>(dq + base, D, q_s, wrow, q0 + wrow, S, lane);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  int batch, heads, seq;
  float scale;
  int causal, window, kv_len;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.seq / BQ, a.heads, a.batch);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dq), a.seq, a.scale, a.causal, a.window, a.kv_len);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_tc(const Args& a, void* dq) {
  using bf16 = __nv_bfloat16;
  constexpr size_t smem = tc_dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.seq / BQ, a.heads, a.batch);
  flash_bwd_dq_tc_kernel<D><<<grid, TC_THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(dq), a.seq, a.scale, a.causal, a.window, a.kv_len);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.seq / BK, a.heads, a.batch);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dk), static_cast<float*>(dv), a.seq, a.scale,
      a.causal, a.window, a.kv_len);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_tc(const Args& a, void* dk, void* dv) {
  using bf16 = __nv_bfloat16;
  constexpr size_t smem = tc_dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.seq / BK, a.heads, a.batch);
  flash_bwd_dkv_tc_kernel<D><<<grid, TC_THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.seq, a.scale,
      a.causal, a.window, a.kv_len);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Both entry points: q, k, v, do (B, H, S, D) of one dtype (0 = float32,
// 1 = bfloat16), head_dim 64 or 128, seq a multiple of 64; lse and delta
// (B, H, S) fp32; window < 0 and kv_len < 0 mean none. The bf16 kernels
// (tensor cores) need q, k, v, do and the outputs 16-byte aligned. Each
// returns the CUDA error code of its launch (0 on success).

int forde_flash_bwd_dq(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int batch, int heads, int seq, int head_dim,
                       int dtype, float scale, int causal, int window,
                       int kv_len, void* stream) {
  if (seq % BQ != 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, batch, heads, seq, scale, causal,
               window, kv_len, static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && head_dim == 64) return launch_dq<64>(a, dq);
  if (dtype == 0 && head_dim == 128) return launch_dq<128>(a, dq);
  if (dtype == 1 && head_dim == 64) return launch_dq_tc<64>(a, dq);
  if (dtype == 1 && head_dim == 128) return launch_dq_tc<128>(a, dq);
  return (int)cudaErrorInvalidValue;
}

int forde_flash_bwd_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int batch, int heads, int seq,
                        int head_dim, int dtype, float scale, int causal,
                        int window, int kv_len, void* stream) {
  if (seq % BK != 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, batch, heads, seq, scale, causal,
               window, kv_len, static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && head_dim == 64) return launch_dkv<64>(a, dk, dv);
  if (dtype == 0 && head_dim == 128) return launch_dkv<128>(a, dk, dv);
  if (dtype == 1 && head_dim == 64) return launch_dkv_tc<64>(a, dk, dv);
  if (dtype == 1 && head_dim == 128) return launch_dkv_tc<128>(a, dk, dv);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
