// 4-D flash-attention forward for Hopper (sm_90a).
//
// Replaces two TPU kernels of forde_tpu/ops/flash_attention.py: the
// resident `_fwd_kernel` (S <= 4096, full-S K/V held in VMEM, launched by
// `_fwd_pallas`) and the streaming `_fwd_stream_kernel` (S > 4096, causal,
// launched by `_fwd_stream_pallas`). Both compute the same function; the
// split came from VMEM size. This kernel reads k/v tiles from device memory
// at any S, so it serves both routes. The decoder LM runs it as the local
// (sliding-window) branch of NSA in every prefill, and as the dense causal
// attention of the full forward.
//
// What it computes, on contiguous (B, H, S, D) q, k, v with S a multiple
// of 64 (the wrapper pads S and D):
//   * key c is visible to query r iff r >= c (causal), r - c < window
//     (window >= 0) and c < kv_len (kv_len >= 0, the static bound of a
//     padded non-causal call);
//   * a masked score is -1e30 and the running max starts at -1e30, as in
//     the TPU kernel (a tile whose keys are all masked for a row adds
//     exp(0) = 1 terms until a visible key rescales them away);
//   * scores are fp32 products of the input values summed in fp32 (in
//     fp32, three TF32 passes a product: within 2^-19 of it); p is summed
//     into l in fp32 and rounded to the input type before the product
//     with v (`p.astype(v.dtype)`: in fp32 not at all), against the
//     running max of the walked keys; o = acc / l in the input type,
//     lse = m + log(l) in fp32, l == 0 guarded.
//
// Bound on the H100: at the serving prefill (B=8, H=8, S=2048, D=64, bf16,
// causal, window 512) q, k, v are read once and o, lse written once:
// ~68 MB, ~20 us at 3.35 TB/s; the visible products are 4*D per (query,
// key) over ~0.92M pairs per head: ~15 GFLOP, ~15 us at 989 TFLOP/s. So
// the two are close, the bytes slightly ahead.
//
// Both routes run blocks of query rows and walk the key tiles of 64 keys
// that some row of the block may see, with an online softmax. Tiles wholly
// outside the causal / window / kv_len span are skipped, as `_loop_bounds`
// and `_stream_span` skip them: under a window of 512 a q tile reads 9 k
// tiles whatever S is, so the work grows linearly in S.
//
// bf16 route (flash_fwd_tc_kernel): the tensor cores. A bf16 x bf16
// product is exact in fp32, so mma.sync.m16n8k16 with fp32 accumulators
// computes what `_dot` does, in another order of summation. The design of
// flash_mha_fwd.cu's bf16 route on this layout (row stride D): each warp
// owns 16 query rows whose q fragments stay in registers for the whole
// walk; K and V tiles arrive through a three-stage cp.async ring (16 bytes
// a thread) into XOR-swizzled shared memory, read with ldmatrix (K as the
// B operand of q k^T, V transposed as the B operand of p v); one barrier a
// tile frees the stage of the tile before. The online softmax runs on the
// accumulator fragments in log2 units (one 2^x on the special-function
// unit per element) with quad shuffles; the -1e30 sentinel is kept as it
// is, so a masked score minus a running max of -1e30 is 0 and weighs
// 2^0 = 1, as exp(0) does on the TPU. p, rounded to bf16 in registers, is
// the A operand of p v: it never touches shared memory. o leaves through
// the q tile's shared memory in 16-byte stores.
//   The mask runs only on the edge tiles. `_loop_bounds`' interior split
// (forde_tpu/ops/flash_attention.py:77-95), taken per warp (16 rows),
// gives the key tiles [fs, fe) in which every (row, key) pair of the warp
// is visible; those skip the index compares and selects. At window 512 a
// 64-row block walks 9 key tiles, of which each warp masks 2: the first
// and the diagonal one.
//   Block height and register cap, from builds of each variant timed in
// turns on an NVIDIA H100 80GB HBM3 (700 W) at the serving prefill / at
// S = 8,192: 64-row blocks of 4 warps at 155 registers (3 blocks an SM,
// 56 KB of shared memory each; 149 registers once the code for part-filled
// 128-row blocks left) 0.1059 / 0.0639 ms; 128-row blocks of 8
// warps, which read each K/V tile from L2 half as often, capped at 128
// registers for 2 blocks an SM, spill 68 bytes and take 0.1164 / 0.0646
// ms; 64-row blocks capped at 128 registers (4 an SM) are 1-3% faster but
// spill 108 bytes. The kernel keeps the fastest that does not spill: 64-row
// blocks, 3 an SM. At D = 128: 220 registers, 2 blocks an SM.
//   What bounds it now (chip_smoke.py, same card): 0.102 ms of device time
// at the serving prefill, 5.0x its bound; 0.35x SDPA's time. Useful
// products run at ~148 TFLOP/s (the walk multiplies whole 64 x 64 tiles,
// 1.13x the visible pairs at window 512) and bytes at ~20% of the HBM rate:
// neither bounds it. mma.sync from 12 warps an SM, with the softmax between
// a tile's two products, is latency-bound; wgmma with TMA is the next step.
//
// fp32 route (flash_fwd_tf32_tc_kernel): the tensor cores too, every
// product three TF32 passes (mma.sync.m16n8k8; mma.cuh), as the fp32
// routes of flash_mha_fwd.cu and flash_bwd.cu. It replaces the same two
// TPU kernels in fp32, whose products the TPU takes at full precision, and
// it is the route of every LM run without --bf16 (DTypePolicy's compute
// type defaults to fp32: each serve prefill and train.loop step launches
// it once per layer) and of every checkpoint trained that way. Bound on
// the H100 at the serving prefill (fp32: ~135 MB, 0.040 ms at 3.35 TB/s;
// ~15 GFLOP, 0.224 ms at the CUDA cores' 67 TFLOP/s, 0.091 ms at a third
// of TF32's 495 on the tensor cores): the products bound it, and the
// CUDA-core kernel this route replaced (a 16 x 16 thread grid, scores and
// probabilities through shared memory, fmaf loops) ran 0.94 ms, 4.2x even
// the CUDA cores' bound. The walk is the bf16 route's: 4 warps of 16 query
// rows, 64-row blocks, the 64-key tiles of `key_tiles` with the per-warp
// interior split `interior_tiles`, so the mask runs only on a warp's edge
// tiles, and the online softmax in log2 units on the accumulator fragments
// with the -1e30 sentinel as it is. What changes for fp32 is
// flash_mha_fwd.cu's fp32 pattern: the q tile stays fp32 in shared memory
// with row pitch D + 4 for the block's walk, a 64-key tile comes through a
// two-stage cp.async ring in pieces of TF32_KEYS keys (the edge test stays
// per 64-key tile and warp), q and K are split into TF32 hi and lo as
// their fragments are loaded (the planes never take shared memory: split
// once per block they cost occupancy, PERF.md), and p, split in registers,
// is the A operand of p v as it stands in the accumulators (column 2t to k
// slot t, 2t + 1 to slot t + 4; V read at rows 2t, 2t + 1 by load_bt_f32).
// p is not rounded before p v: l and the product take the same p. Each
// piece's p v is summed in a fresh accumulator and added to the rescaled o
// on the CUDA cores (mma_step_tf32x3): chained through the tensor cores'
// accumulation over a walk of up to S keys, the error drifts one way
// (PERF.md). o = acc / l and lse as the bf16 route; two calls give the
// same bits. Registers (ptxas): 168 at D = 64 (3 blocks an SM), 241 at
// D = 128 (2 blocks); no spills. Measured (chip_smoke.py flash_fwd_turns,
// NVIDIA H100 80GB HBM3, 700.00 W): 0.3511-0.3518 ms of device time at the
// serving prefill and 0.2086-0.2093 at S = 8,192 (the CUDA-core kernel
// took 0.9408-0.9426 and 0.5288-0.5304 in the same call): 3.9x the
// three-pass bound, 1.6x the CUDA cores', 3.4x the bf16 route's time and
// 0.15x SDPA's fp32 call; useful products at ~43 TFLOP/s. As in the other
// TF32 routes, issue slots bound it: the D = 64 kernel's SASS holds 2,264
// instructions for 192 TF32 HMMA (the split, three instructions an
// element, taken again by every warp at every load).

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using forde::interior_tiles;
using forde::key_tiles;

constexpr int BQ = 64;               // query rows per block
constexpr int BK = forde::FLASH_BK;  // keys per tile
constexpr float MASK_VALUE = -1e30f;
constexpr int TC_THREADS = 128;      // 4 warps of 16 query rows

// The bf16 route: stages of its ring (tiles i + 1 and i + 2 are in flight
// while tile i is multiplied), and blocks an SM, which caps the registers a
// thread at 65,536 / 128 / blocks; at D = 128 the kernel takes ~220
// registers a thread.
constexpr int TC_STAGES = 3;

template <int D>
constexpr int tc_blocks_per_sm() {
  return D == 128 ? 1 : 3;
}

// The q tile, then TC_STAGES stages of a K and a V tile, bf16.
template <int D>
constexpr size_t tc_smem_bytes() {
  return (BQ + 2 * TC_STAGES * BK) * D * sizeof(__nv_bfloat16);
}

// The fp32 route: keys per step (a piece of a 64-key tile; two stages of
// the ring) and blocks an SM. The q tile and two stages of a 32-key K and
// V piece take 51 KB at D = 64 (pitch D + 4), three blocks an SM under 168
// registers a thread; 99 KB at D = 128, two blocks. A whole 64-key tile a
// step would hold 64 registers of p's hi and lo beside the accumulators.
constexpr int TF32_KEYS = 32;

template <int D>
constexpr int tf32_blocks_per_sm() {
  return D == 128 ? 2 : 3;
}

template <int D>
constexpr size_t tf32_smem_bytes() {
  return (BQ + 2 * 2 * TF32_KEYS) * (D + 4) * sizeof(float);
}

// The fp32 route. Warp w owns rows q0 + 16w .. q0 + 16w + 15; lane (g, t)
// holds rows g and g + 8 of them (r0, r1) and, of each n8 tile j of a
// product, cols 8j + 2t and 8j + 2t + 1. Every product is three TF32 passes
// (mma.cuh); q and K are split as their fragments are loaded. Step i takes
// keys j_begin * BK + i * KT .. + KT - 1 of key tile j_begin + i / PIECES.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, tf32_blocks_per_sm<D>())
flash_fwd_tf32_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int S, float scale, int causal,
                         int window, int kv_len) {
  using namespace forde::mma;
  constexpr int LD = D + 4;          // row pitch of the fp32 tiles
  constexpr int KD = D / 8;          // k8 steps over the head dim
  constexpr int ND = D / 8;          // n8 tiles of the output
  constexpr int KT = TF32_KEYS;      // keys per step
  constexpr int NJ = KT / 8;         // n8 tiles of s
  constexpr int PIECES = BK / KT;    // steps per key tile
  constexpr int STAGE = 2 * KT * LD; // a K piece, then a V piece

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* const q_s = reinterpret_cast<float*>(smem_raw);
  float* const ring = q_s + BQ * LD;

  const int q0 = blockIdx.x * BQ;
  const long long bh = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long base = bh * S * D;
  const float* k_g = k + base;
  const float* v_g = v + base;

  int j_begin, j_end;
  key_tiles(q0, BQ, S, causal, window, kv_len, j_begin, j_end);
  const int n = (j_end - j_begin) * PIECES;  // at least one tile
  const int keys = kv_len >= 0 ? min(kv_len, S) : S;

  const int wrow = 16 * warp;
  // Key tiles [fs, fe) need no mask for this warp's rows.
  int fs, fe;
  interior_tiles(q0 + wrow, 16, j_begin, j_end, causal, window, kv_len, fs, fe);

  // Step i's K and V pieces into stage i % 2, as one commit group.
  auto fetch = [&](int i) {
    float* const dst = ring + (i & 1) * STAGE;
    const int k0 = j_begin * BK + i * KT;
    load_tile_f32_async<KT, D, TC_THREADS>(dst, k_g, k0, S, D);
    load_tile_f32_async<KT, D, TC_THREADS>(dst + KT * LD, v_g, k0, S, D);
    cp_async_commit();
  };
  load_tile_f32_async<BQ, D, TC_THREADS>(q_s, q + base, q0, S, D);
  fetch(0);  // with q

  const int r0 = q0 + wrow + g, r1 = r0 + 8;
  // The keys visible to rows r0 and r1: [lo, hi] (common.cuh `visible`).
  const int lo0 = window >= 0 ? r0 - window + 1 : 0;
  const int lo1 = window >= 0 ? r1 - window + 1 : 0;
  const int hi0 = causal ? min(r0, keys - 1) : keys - 1;
  const int hi1 = causal ? min(r1, keys - 1) : keys - 1;
  // Scores in log2 units: exp(s * scale - m) = 2^(s * scale * log2(e) - m').
  const float scale_log2 = scale * LOG2E;

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // Running max of rows r0, r1 (log2 units; -1e30 as on the TPU), and this
  // lane's part of the running sums.
  float m0 = MASK_VALUE, m1 = MASK_VALUE;
  float l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n; ++i) {
    // Step i's pieces have landed; after the barrier every warp is done
    // with step i - 1, whose stage takes step i + 1.
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < n) fetch(i + 1);

    const int k0 = j_begin * BK + i * KT;
    const int jt = j_begin + i / PIECES;
    const bool edge = jt < fs || jt >= fe;
    const float* const k_t = ring + (i & 1) * STAGE;
    const float* const v_t = k_t + KT * LD;
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], qh[4], ql[4];
      load_a_f32<D>(qa, q_s, wrow, kk, lane);
      split_tf32(qa, qh, ql);
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np) {
        uint32_t kb[4], kh[4], kl[4];
        load_b_f32<D>(kb, k_t, 16 * np, kk, lane);
        split_tf32(kb, kh, kl);
        mma_tf32x3(s[2 * np], qh, ql, kh[0], kh[1], kl[0], kl[1]);
        mma_tf32x3(s[2 * np + 1], qh, ql, kh[2], kh[3], kl[2], kl[3]);
      }
    }

    // Scale, and on an edge tile mask to -1e30.
    float mx0 = MASK_VALUE, mx1 = MASK_VALUE;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = k0 + 8 * j + 2 * t + e;
        float x0 = s[j][e] * scale_log2, x1 = s[j][2 + e] * scale_log2;
        if (edge) {
          if (kc < lo0 || kc > hi0) x0 = MASK_VALUE;
          if (kc < lo1 || kc > hi1) x1 = MASK_VALUE;
        }
        s[j][e] = x0;
        s[j][2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = exp2_approx(m0 - mn0), a1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= a0;
      acc[j][1] *= a0;
      acc[j][2] *= a1;
      acc[j][3] *= a1;
    }

    // p = 2^(s - m), summed into l; n8 tile kk of p, split into TF32, is
    // the A operand of k8 step kk of p v, summed apart and added to o.
    uint32_t ph[NJ][4], pl[NJ][4];
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
      float p[4];
      p[0] = exp2_approx(s[kk][0] - m0);
      p[1] = exp2_approx(s[kk][1] - m0);
      p[2] = exp2_approx(s[kk][2] - m1);
      p[3] = exp2_approx(s[kk][3] - m1);
      l0 += p[0] + p[1];
      l1 += p[2] + p[3];
      acc_to_a_tf32(ph[kk], pl[kk], p);
    }
    mma_step_tf32x3<D, NJ>(acc, ph, pl, v_t, lane);  // o += p v
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float ls0 = l0 == 0.f ? 1.f : l0, ls1 = l1 == 0.f ? 1.f : l1;
  store_rows_f32<D>(o + base, D, acc, r0, S, 1.f / ls0, 1.f / ls1, lane);
  if (t == 0) {
    float* lse_bh = lse + bh * S;
    // lse = m + log(l) in natural units; a row with every walked key
    // masked keeps m = -1e30 as it is.
    const bool valid0 = m0 > MASK_VALUE * 0.5f, valid1 = m1 > MASK_VALUE * 0.5f;
    lse_bh[r0] = (valid0 ? m0 * LN2 : m0) + logf(ls0);
    lse_bh[r1] = (valid1 ? m1 * LN2 : m1) + logf(ls1);
  }
}

// The bf16 route. Warp w owns rows q0 + 16w .. q0 + 16w + 15; lane (g, t)
// holds rows g and g + 8 of them (r0, r1) and, of each n8 tile j of a
// product, cols 8j + 2t and 8j + 2t + 1.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, tc_blocks_per_sm<D>())
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int S, float scale, int causal, int window, int kv_len) {
  using namespace forde::mma;
  constexpr int KD = D / 16;  // k-steps over the head dim
  constexpr int ND = D / 8;   // n8 tiles of the output
  constexpr int NJ = BK / 8;  // n8 tiles of s
  // The q tile (until its fragments are loaded; then o on its way out),
  // then the ring: stage st holds its K tile at ring + st * STAGE and its
  // V tile BK * D after it.
  constexpr int STAGE = 2 * BK * D;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* const q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* const ring = q_s + BQ * D;

  const int q0 = blockIdx.x * BQ;
  const long long bh = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const long long base = bh * S * D;
  const bf16* q_g = q + base;
  const bf16* k_g = k + base;
  const bf16* v_g = v + base;

  int j_begin, j_end;
  key_tiles(q0, BQ, S, causal, window, kv_len, j_begin, j_end);
  const int n = j_end - j_begin;
  const int keys = kv_len >= 0 ? min(kv_len, S) : S;

  const int wrow = 16 * warp;
  // Tiles [fs, fe) need no mask for this warp's rows.
  int fs, fe;
  interior_tiles(q0 + wrow, 16, j_begin, j_end, causal, window, kv_len, fs, fe);

  // Key tile j_begin + i into stage i % TC_STAGES, as one commit group.
  auto fetch = [&](int i) {
    bf16* const dst = ring + (i % TC_STAGES) * STAGE;
    const int k0 = (j_begin + i) * BK;
    load_tile_async<D, TC_THREADS>(dst, k_g, k0, S, D);
    load_tile_async<D, TC_THREADS>(dst + BK * D, v_g, k0, S, D);
    cp_async_commit();
  };
  load_tile_async<D, TC_THREADS>(q_s, q_g, q0, S, D);  // with tile 0
  for (int i = 0; i < TC_STAGES - 1 && i < n; ++i) fetch(i);

  const int r0 = q0 + wrow + g, r1 = r0 + 8;
  // The keys visible to rows r0 and r1: [lo, hi] (common.cuh `visible`).
  const int lo0 = window >= 0 ? r0 - window + 1 : 0;
  const int lo1 = window >= 0 ? r1 - window + 1 : 0;
  const int hi0 = causal ? min(r0, keys - 1) : keys - 1;
  const int hi1 = causal ? min(r1, keys - 1) : keys - 1;
  // Scores in log2 units: exp(s * scale - m) = 2^(s * scale * log2(e) - m').
  const float scale_log2 = scale * LOG2E;
  uint32_t qf[KD][4];

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // Running max of rows r0, r1 (log2 units; -1e30 as on the TPU), and this
  // lane's part of the running sums.
  float m0 = MASK_VALUE, m1 = MASK_VALUE;
  float l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n; ++i) {
    // This thread's copies of tile i have landed once at most the later
    // tile i + 1 is in flight; after the barrier, every thread's have, and
    // every warp is done with tile i - 1, whose stage takes tile i + 2.
    if (i + 1 < n)
      cp_async_wait<TC_STAGES - 2>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) load_a<D>(qf[kk], q_s, wrow, kk, lane);
    }
    if (i + TC_STAGES - 1 < n) fetch(i + TC_STAGES - 1);

    const int jt = j_begin + i;
    const int k0 = jt * BK;
    const bf16* const k_t = ring + (i % TC_STAGES) * STAGE;
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

    // Scale, and on an edge tile mask to -1e30.
    const bool edge = jt < fs || jt >= fe;
    float mx0 = MASK_VALUE, mx1 = MASK_VALUE;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = k0 + 8 * j + 2 * t + e;
        float x0 = s[j][e] * scale_log2, x1 = s[j][2 + e] * scale_log2;
        if (edge) {
          if (kc < lo0 || kc > hi0) x0 = MASK_VALUE;
          if (kc < lo1 || kc > hi1) x1 = MASK_VALUE;
        }
        s[j][e] = x0;
        s[j][2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = exp2_approx(m0 - mn0), a1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= a0;
      acc[j][1] *= a0;
      acc[j][2] *= a1;
      acc[j][3] *= a1;
    }

    // p = 2^(s - m): summed unrounded into l, rounded to bf16 into the A
    // operand of p v, one k-step (n8 tiles 2kk, 2kk + 1) at a time.
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      uint32_t pf[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * kk + h;
        const float p00 = exp2_approx(s[j][0] - m0), p01 = exp2_approx(s[j][1] - m0);
        const float p10 = exp2_approx(s[j][2] - m1), p11 = exp2_approx(s[j][3] - m1);
        l0 += p00 + p01;
        l1 += p10 + p11;
        pf[2 * h] = pack_bf16x2(p00, p01);
        pf[2 * h + 1] = pack_bf16x2(p10, p11);
      }
#pragma unroll
      for (int np = 0; np < KD; ++np) {
        uint32_t bv[4];
        load_bt<D>(bv, v_t, 16 * kk, np, lane);
        mma_bf16(acc[2 * np], pf, bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], pf, bv[2], bv[3]);
      }
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float ls0 = l0 == 0.f ? 1.f : l0, ls1 = l1 == 0.f ? 1.f : l1;
  // This warp's rows of the q tile, read into its fragments at tile 0,
  // take its rows of o.
  stage_rows<D>(q_s, acc, wrow, 1.f / ls0, 1.f / ls1, lane);
  __syncwarp();
  store_rows<D>(o + base, D, q_s, wrow, q0 + wrow, S, lane);
  if (t == 0) {
    float* lse_bh = lse + bh * S;
    // lse = m + log(l) in natural units; a row with every walked key
    // masked keeps m = -1e30 as it is.
    const bool valid0 = m0 > MASK_VALUE * 0.5f, valid1 = m1 > MASK_VALUE * 0.5f;
    lse_bh[r0] = (valid0 ? m0 * LN2 : m0) + logf(ls0);
    lse_bh[r1] = (valid1 ? m1 * LN2 : m1) + logf(ls1);
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      void* lse, int batch, int heads, int seq, float scale,
                      int causal, int window, int kv_len, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr size_t smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(seq / BQ, heads, batch);
  flash_fwd_tc_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), seq, scale, causal, window, kv_len);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o,
                        void* lse, int batch, int heads, int seq, float scale,
                        int causal, int window, int kv_len, cudaStream_t stream) {
  constexpr size_t smem = tf32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(seq / BQ, heads, batch);
  flash_fwd_tf32_tc_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), seq, scale, causal, window, kv_len);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (three TF32 passes a product), 1 = bfloat16; both on
// the tensor cores, q, k, v and o 16-byte aligned; seq a multiple of 64;
// window < 0 and kv_len < 0 mean none. Returns the CUDA error code of the launch (0 on
// success).
int forde_flash_fwd(const void* q, const void* k, const void* v, void* o,
                    void* lse, int batch, int heads, int seq, int head_dim,
                    int dtype, float scale, int causal, int window, int kv_len,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (seq % BQ != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64)
    return launch_tf32<64>(q, k, v, o, lse, batch, heads, seq, scale, causal,
                           window, kv_len, st);
  if (dtype == 0 && head_dim == 128)
    return launch_tf32<128>(q, k, v, o, lse, batch, heads, seq, scale, causal,
                            window, kv_len, st);
  if (dtype == 1 && head_dim == 64)
    return launch_tc<64>(q, k, v, o, lse, batch, heads, seq, scale, causal,
                         window, kv_len, st);
  if (dtype == 1 && head_dim == 128)
    return launch_tc<128>(q, k, v, o, lse, batch, heads, seq, scale, causal,
                          window, kv_len, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
