// Fused-qkv multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_mha_fwd_kernel` of forde_tpu/ops/flash_attention.py
// (launched by `_mha_fwd_pallas` through `pl.pallas_call`). Both encoder
// towers of the dual encoder run it in every block.
//
// What it computes: bidirectional attention read straight out of the
// (B, S, 3*H*D) output of the qkv projection (q, k, v of head h at column
// offsets h*D, (H+h)*D, (2H+h)*D of each row, row stride 3*H*D), with no
// transposes. It writes o (B, S, H*D) in the input type and the row
// log-sum-exp lse (B, H, S) in fp32. Masks, as in the TPU kernel:
//   * key c is visible to query r iff c < kv_len[b] (per sample, optional),
//     c < kv_bound (static, optional), r >= c (causal), r - c < window;
//   * a masked score is -1e30; a row is valid iff its max > -0.5e30, and
//     invalid rows (every key masked, e.g. kv_len[b] == 0) write zeros;
//   * l == 0 guards the division; lse = m + log(l).
// Products are exact multiplies of the input values summed in fp32, as the
// JAX kernel's `_dot` accumulates in fp32 (in fp32, to 2^-19 of each
// product: the fp32 route below).
//
// Bound on the H100: at the serving shapes (batch 128, bf16) the work is
// far below the card's ridge point. Vision (S=200, H=6, D=128) moves about
// 158 MB (qkv read once, o and lse written once): ~47 us at 3.35 TB/s,
// against 15.7 GFLOP, ~16 us at 989 TFLOP/s. Text (S=64, H=4, D=128) moves
// about 34 MB: ~10 us. So memory bounds it. Both routes run one block per
// (q tile of 64 rows, head, sample), walk the k/v tiles (64 keys in bf16,
// 32 in fp32) with an online softmax, and skip the tiles that every row of the block masks
// (past kv_len, past the diagonal when causal, before the window). Every
// qkv element of a (sample, head) is read from device memory once per q
// tile; the reads of the later q tiles hit L2.
//
// bf16 route (flash_mha_fwd_tc_kernel): the tensor cores. A bf16 x bf16
// product is exact in fp32, so mma.sync.m16n8k16 with fp32 accumulators
// computes what `_dot` does, in another order of summation. 4 warps, each
// owning 16 query rows whose q fragments stay in registers for the whole
// walk. K and V tiles arrive through a three-stage cp.async ring (16 bytes
// a thread) into XOR-swizzled bf16 shared memory, read with ldmatrix;
// tiles i + 1 and i + 2 are in flight while tile i is multiplied, and one
// barrier a tile frees the stage of tile i - 1. s = q k^T lands in fp32
// registers, is scaled and masked per fragment element, and the online
// softmax runs there with quad shuffles, in log2 units so that exp() is
// one 2^x on the special-function unit; p = exp(s - m) is rounded to bf16
// and is, as it stands in the accumulator registers, the A operand of p v
// (mma.cuh): p never touches shared memory. The TPU kernel rounds the
// normalised p / l to bf16 before p v (flash_attention.py:1024); this one
// rounds exp(s - m) and divides by l at the end: the same relative
// rounding of each term. o leaves through shared memory (the q tile's) in
// 16-byte stores. mma.sync rather than wgmma: the bytes bound these shapes
// (47 us against 16 us of products at the vision shape), its 16-row warp
// tiles fit S = 200 and S = 64 where wgmma's 64-row tiles pad S = 200 to
// 256, and p stays in registers with no staging. At D = 128 the q tile and
// the ring take 112 KB and the kernel 224 registers a thread: two blocks
// an SM. Each of the S / 64 blocks of a (sample, head) reads every K and
// V tile again, from L2: at the vision shape the blocks read 3 times the
// bytes of qkv.
//
// fp32 route (flash_mha_fwd_tf32_tc_kernel): the tensor cores too, in three
// TF32 passes a product (mma.cuh). It is the route of every CLI run without
// --bf16 (DTypePolicy's compute type defaults to fp32: clip_loop, embed,
// serve and train.loop) and of every checkpoint trained that way, not only
// of checks and parity runs. It replaces the same TPU kernel in fp32, whose
// `_dot` products the TPU takes at full precision in several bf16 passes.
// Bound on the H100 at the vision shape (batch 128): 15.7 GFLOP, 0.235 ms
// at the CUDA cores' 67 TFLOP/s, 0.095 ms at a third of the 495 TFLOP/s of
// TF32 (three passes); 316 MB of bytes, 0.094 ms. So the products bound
// it, and the CUDA cores cannot come near: the CUDA-core kernel this route
// replaced, fmaf loops bound by shared-memory reads, ran 7.5x its bound
// (1.75 ms of device time; chip_smoke.py on an NVIDIA H100 80GB HBM3,
// 700 W). The split
// keeps fp32-class products on the tensor cores: x = hi + lo, hi x rounded
// to TF32 and lo = x - hi, and a b = lo_a hi_b + hi_a lo_b + hi_a hi_b into
// the fp32 accumulator, within 2^-19 of |a b| (mma.cuh). The layout is the bf16 route's: 4 warps of 16 query
// rows, K and V through a cp.async ring, the online softmax in log2 units
// on the accumulator fragments, p split in registers and used, as it
// stands in the accumulators, as the A operand of p v (column 2t to k slot
// t, 2t + 1 to slot t + 4, and V read at rows 2t, 2t + 1: the k order of a
// product may be permuted in both operands alike). What changes for fp32:
// the tiles stay fp32 in shared memory with row pitch D + 4 (16-byte rows,
// no bank conflicts for ldmatrix's 32-bit words or V's scalar loads), and
// q, k and v are split as their fragments are loaded, so the planes of hi
// and lo never take shared memory: at D = 128 the q tile (33 KB) and two
// stages of 32-key K and V tiles (66 KB) fit two blocks an SM, where o's
// accumulator alone takes 64 registers a thread and q's hi and lo
// fragments would take another 128. What bounds it now is issue slots:
// the split costs three instructions an element loaded, each warp splits
// the K and V tiles again, and a tile walk at D = 128 is ~3,550
// instructions for 384 TF32 HMMA (chip_smoke.py's sass_mix). At the vision
// shape it takes 0.435 ms of device time, 1.9x the CUDA cores' bound and
// 0.73x SDPA's fp32 call (PERF.md).

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using forde::visible;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile (bf16 route)
constexpr int TC_THREADS = 128;  // 4 warps of 16 query rows
constexpr float MASK_VALUE = -1e30f;

// The bf16 route: stages of its ring (tiles i + 1 and i + 2 are in flight
// while tile i is multiplied), and blocks an SM, which caps the registers
// (65,536 / (128 threads x blocks)): at D = 64 four blocks (128 registers,
// 56 KB each) ran faster on the H100 than three; at D = 128 the kernel
// takes 224 registers and 112 KB, two blocks an SM. (Tiles of 32 keys fit
// three blocks at D = 128 and ran faster, but move the bf16 rounding of p
// and with it the step-parity readings past their bars.)
constexpr int TC_STAGES = 3;

template <int D>
constexpr int tc_blocks_per_sm() {
  return D == 128 ? 1 : 4;
}

// The q tile, then TC_STAGES stages of a K and a V tile, 64 x D bf16 each.
template <int D>
constexpr size_t tc_smem_bytes() {
  return (1 + 2 * TC_STAGES) * BK * D * sizeof(__nv_bfloat16);
}

// The fp32 route: keys per tile, stages of its ring (tile i + 1 in flight
// while tile i is multiplied) and blocks an SM. At D = 128 the q tile and
// two stages of 32-key K and V tiles take 99 KB (pitch D + 4), two blocks
// an SM; 64-key tiles would take 165 KB, one block of 4 warps an SM. At
// S = 200 the 32-key tiles also pad the keys to 224, not 256.
constexpr int F32_BK = 32;
constexpr int F32_STAGES = 2;

template <int D>
constexpr int f32_blocks_per_sm() {
  return D == 128 ? 2 : 3;
}

template <int D>
constexpr size_t f32_smem_bytes() {
  return (BQ + 2 * F32_STAGES * F32_BK) * (D + 4) * sizeof(float);
}

// kv_len: keys at or past it are masked for every row. Key tiles of TILE
// keys [j_begin, j_end) hold every key some row of the q tile at q0 may
// see; at least one, so a row with every key masked still sees -1e30
// scores (m = -1e30, zeroed output, lse = -1e30) as the TPU kernel does.
template <int TILE = BK>
__device__ __forceinline__ void key_span(const int* lens, int b, int q0,
                                         int S, int causal, int window,
                                         int kv_bound, int& kv_len,
                                         int& j_begin, int& j_end) {
  kv_len = S;
  if (lens != nullptr) kv_len = min(kv_len, lens[b]);
  if (kv_bound >= 0) kv_len = min(kv_len, kv_bound);
  const int q_last = min(q0 + BQ, S) - 1;
  int end_col = kv_len;
  if (causal) end_col = min(end_col, q_last + 1);
  j_begin = window >= 0 ? max(0, q0 - window + 1) / TILE : 0;
  j_end = (end_col + TILE - 1) / TILE;
  if (j_end <= j_begin) j_end = j_begin + 1;
}

// The fp32 route. Warp w owns rows q0 + 16w .. q0 + 16w + 15; lane (g, t)
// holds rows g and g + 8 of them (r0, r1) and, of each n8 tile j of a
// product, cols 8j + 2t and 8j + 2t + 1. Every product is three TF32 passes
// (mma.cuh); the operands are split as their fragments are loaded.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, f32_blocks_per_sm<D>())
flash_mha_fwd_tf32_tc_kernel(const float* __restrict__ qkv,
                             const int* __restrict__ lens,
                             float* __restrict__ o, float* __restrict__ lse,
                             int S, int H, float scale, int causal, int window,
                             int kv_bound) {
  using namespace forde::mma;
  constexpr int LD = D + 4;        // row pitch of the fp32 tiles
  constexpr int KD = D / 8;        // k8 steps over the head dim
  constexpr int ND = D / 8;        // n8 tiles of the output
  constexpr int NJ = F32_BK / 8;   // n8 tiles of s
  constexpr int STAGE = 2 * F32_BK * LD;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  // The q tile for the whole walk, then the ring: stage st holds its K
  // tile at ring + st * STAGE and its V tile F32_BK * LD after it.
  float* const q_s = reinterpret_cast<float*>(smem_raw);
  float* const ring = q_s + BQ * LD;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const long long stride = 3LL * H * D;
  const float* base = qkv + (long long)b * S * stride;
  const float* q_g = base + (long long)h * D;
  const float* k_g = base + (long long)(H + h) * D;
  const float* v_g = base + (long long)(2 * H + h) * D;

  int kv_len, j_begin, j_end;
  key_span<F32_BK>(lens, b, q0, S, causal, window, kv_bound, kv_len, j_begin,
                   j_end);
  const int n = j_end - j_begin;

  // Key tile j_begin + i into stage i % F32_STAGES, as one commit group.
  auto fetch = [&](int i) {
    float* const dst = ring + (i % F32_STAGES) * STAGE;
    const int k0 = (j_begin + i) * F32_BK;
    load_tile_f32_async<F32_BK, D, TC_THREADS>(dst, k_g, k0, S, stride);
    load_tile_f32_async<F32_BK, D, TC_THREADS>(dst + F32_BK * LD, v_g, k0, S,
                                               stride);
    cp_async_commit();
  };
  load_tile_f32_async<BQ, D, TC_THREADS>(q_s, q_g, q0, S, stride);  // with tile 0
  for (int i = 0; i < F32_STAGES - 1 && i < n; ++i) fetch(i);

  const int wrow = 16 * warp;
  // A warp whose rows all lie at or past S does no products; it still
  // takes part in the copies and barriers.
  const bool active = q0 + wrow < S;
  const int r0 = q0 + wrow + g, r1 = r0 + 8;
  const float scale_log2 = scale * LOG2E;

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0, r1 (log2 units)
  float l0 = 0.f, l1 = 0.f;  // this lane's part of the running sums

  for (int i = 0; i < n; ++i) {
    // Tile i (and, at i = 0, the q tile) has landed once at most the later
    // tiles are in flight; after the barrier every warp is done with tile
    // i - 1, whose stage takes tile i + F32_STAGES - 1.
    if (i + 1 < n)
      cp_async_wait<F32_STAGES - 2>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (i + F32_STAGES - 1 < n) fetch(i + F32_STAGES - 1);

    if (active) {
      const int k0 = (j_begin + i) * F32_BK;
      const float* const k_t = ring + (i % F32_STAGES) * STAGE;
      const float* const v_t = k_t + F32_BK * LD;
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

      // Scale and mask as the bf16 route does: -1e30 where masked, -inf
      // for a column past S; a tile wholly inside kv_len with no causal or
      // window mask needs neither.
      const bool full = !causal && window < 0 && k0 + F32_BK <= kv_len;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kc = k0 + 8 * j + 2 * t + e;
          float x0 = s[j][e] * scale_log2, x1 = s[j][2 + e] * scale_log2;
          if (!full) {
            if (kc >= S) {
              x0 = x1 = -INFINITY;
            } else {
              if (!visible(r0, kc, kv_len, causal, window)) x0 = MASK_VALUE;
              if (!visible(r1, kc, kv_len, causal, window)) x1 = MASK_VALUE;
            }
          }
          s[j][e] = x0;
          s[j][2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
      // Finite: column k0 < S is in the tile.
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

      // p = exp(s - m), summed into l; n8 tile kk of p, split into TF32,
      // is the A operand of k8 step kk of p v.
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
        s[kk][0] = exp2_approx(s[kk][0] - m0);
        s[kk][1] = exp2_approx(s[kk][1] - m0);
        s[kk][2] = exp2_approx(s[kk][2] - m1);
        s[kk][3] = exp2_approx(s[kk][3] - m1);
        l0 += s[kk][0] + s[kk][1];
        l1 += s[kk][2] + s[kk][3];
        uint32_t ph[4], pl[4];
        acc_to_a_tf32(ph, pl, s[kk]);
#pragma unroll
        for (int np = 0; np < ND; ++np) {
          uint32_t bh[2], bl[2];
          load_bt_f32<D>(bh, bl, v_t, 8 * kk, 8 * np, lane);
          mma_tf32x3(acc[np], ph, pl, bh[0], bh[1], bl[0], bl[1]);
        }
      }
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (!active) return;
  const float ls0 = l0 == 0.f ? 1.f : l0, ls1 = l1 == 0.f ? 1.f : l1;
  const bool valid0 = m0 > MASK_VALUE * 0.5f, valid1 = m1 > MASK_VALUE * 0.5f;
  const int HD = H * D;
  store_rows_f32<D>(o + (long long)b * S * HD + (long long)h * D, HD, acc,
                    r0, S, valid0 ? 1.f / ls0 : 0.f, valid1 ? 1.f / ls1 : 0.f,
                    lane);
  if (t == 0) {
    float* lse_bh = lse + ((long long)b * H + h) * S;
    // lse = m + log(l) in natural units; -1e30 (+ log l) on an invalid row.
    if (r0 < S) lse_bh[r0] = (valid0 ? m0 * LN2 : m0) + logf(ls0);
    if (r1 < S) lse_bh[r1] = (valid1 ? m1 * LN2 : m1) + logf(ls1);
  }
}

// The bf16 route. Warp w owns rows q0 + 16w .. q0 + 16w + 15; lane (g, t)
// holds rows g and g + 8 of them (r0, r1) and, of each n8 tile j of a
// product, cols 8j + 2t and 8j + 2t + 1.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, tc_blocks_per_sm<D>())
flash_mha_fwd_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                        const int* __restrict__ lens,
                        __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                        int S, int H, float scale, int causal, int window,
                        int kv_bound) {
  using namespace forde::mma;
  constexpr int KD = D / 16;  // k-steps over the head dim
  constexpr int ND = D / 8;   // n8 tiles of the output

  extern __shared__ __align__(128) unsigned char smem_raw[];
  // The q tile (until its fragments are loaded; then o on its way out),
  // then the ring: stage st holds its K tile at ring + st * STAGE and its
  // V tile BK * D after it.
  constexpr int NJ = BK / 8;  // n8 tiles of s
  constexpr int STAGE = 2 * BK * D;
  bf16* const q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* const ring = q_s + BQ * D;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const long long stride = 3LL * H * D;
  const bf16* base = qkv + (long long)b * S * stride;
  const bf16* q_g = base + (long long)h * D;
  const bf16* k_g = base + (long long)(H + h) * D;
  const bf16* v_g = base + (long long)(2 * H + h) * D;

  int kv_len, j_begin, j_end;
  key_span(lens, b, q0, S, causal, window, kv_bound, kv_len, j_begin, j_end);
  const int n = j_end - j_begin;

  // Key tile j_begin + i into stage i % TC_STAGES, as one commit group.
  auto fetch = [&](int i) {
    bf16* const dst = ring + (i % TC_STAGES) * STAGE;
    const int k0 = (j_begin + i) * BK;
    load_tile_async<D, TC_THREADS>(dst, k_g, k0, S, stride);
    load_tile_async<D, TC_THREADS>(dst + BK * D, v_g, k0, S, stride);
    cp_async_commit();
  };
  load_tile_async<D, TC_THREADS>(q_s, q_g, q0, S, stride);  // with tile 0
  for (int i = 0; i < TC_STAGES - 1 && i < n; ++i) fetch(i);

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
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0, r1 (log2 units)
  float l0 = 0.f, l1 = 0.f;  // this lane's part of the running sums

  for (int i = 0; i < n; ++i) {
    // This thread's copies of tile i have landed once at most the later
    // tile i + 1 is in flight; after the barrier, every thread's have, and
    // every warp is done with tile i - 1, whose stage takes tile i + 2.
    if (i + 1 < n)
      cp_async_wait<TC_STAGES - 2>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (i == 0 && active) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) load_a<D>(qf[kk], q_s, wrow, kk, lane);
    }
    if (i + TC_STAGES - 1 < n) fetch(i + TC_STAGES - 1);

    if (active) {
      const int k0 = (j_begin + i) * BK;
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

      // Scale and mask: -1e30 where masked, -inf for a column past S (not
      // a key at all). A tile wholly inside kv_len with no causal or
      // window mask needs neither. A row with every key masked has
      // m = -1e30 in either unit, and stays invalid.
      const bool full = !causal && window < 0 && k0 + BK <= kv_len;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kc = k0 + 8 * j + 2 * t + e;
          float x0 = s[j][e] * scale_log2, x1 = s[j][2 + e] * scale_log2;
          if (!full) {
            if (kc >= S) {
              x0 = x1 = -INFINITY;
            } else {
              if (!visible(r0, kc, kv_len, causal, window)) x0 = MASK_VALUE;
              if (!visible(r1, kc, kv_len, causal, window)) x1 = MASK_VALUE;
            }
          }
          s[j][e] = x0;
          s[j][2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
      // Finite: column k0 < S is in the tile.
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

      // p = exp(s - m): summed unrounded into l, rounded to bf16 into the
      // A operand of p v (n8 tiles 2kk, 2kk + 1 -> k-step kk).
      uint32_t pf[NJ / 2][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p00 = exp2_approx(s[j][0] - m0), p01 = exp2_approx(s[j][1] - m0);
        const float p10 = exp2_approx(s[j][2] - m1), p11 = exp2_approx(s[j][3] - m1);
        l0 += p00 + p01;
        l1 += p10 + p11;
        pf[j >> 1][(j & 1) * 2] = pack_bf16x2(p00, p01);
        pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(p10, p11);
      }
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk) {
#pragma unroll
        for (int np = 0; np < KD; ++np) {
          uint32_t bv[4];
          load_bt<D>(bv, v_t, 16 * kk, np, lane);
          mma_bf16(acc[2 * np], pf[kk], bv[0], bv[1]);
          mma_bf16(acc[2 * np + 1], pf[kk], bv[2], bv[3]);
        }
      }
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (!active) return;
  const float ls0 = l0 == 0.f ? 1.f : l0, ls1 = l1 == 0.f ? 1.f : l1;
  const bool valid0 = m0 > MASK_VALUE * 0.5f, valid1 = m1 > MASK_VALUE * 0.5f;
  const float w0 = valid0 ? 1.f / ls0 : 0.f;
  const float w1 = valid1 ? 1.f / ls1 : 0.f;
  // This warp's rows of the q tile, read into its fragments at tile 0,
  // take its rows of o.
  stage_rows<D>(q_s, acc, wrow, w0, w1, lane);
  __syncwarp();
  const int HD = H * D;
  store_rows<D>(o + (long long)b * S * HD + (long long)h * D, HD, q_s, wrow,
                q0 + wrow, S, lane);
  if (t == 0) {
    float* lse_bh = lse + ((long long)b * H + h) * S;
    // lse = m + log(l) in natural units; -1e30 (+ log l) on an invalid row.
    if (r0 < S) lse_bh[r0] = (valid0 ? m0 * LN2 : m0) + logf(ls0);
    if (r1 < S) lse_bh[r1] = (valid1 ? m1 * LN2 : m1) + logf(ls1);
  }
}

template <int D>
cudaError_t launch_tc(const void* qkv, const void* lens, void* o, void* lse,
                      int batch, int seq, int heads, float scale, int causal,
                      int window, int kv_bound, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mha_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + BQ - 1) / BQ, heads, batch);
  flash_mha_fwd_tc_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), seq, heads,
      scale, causal, window, kv_bound);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tf32(const void* qkv, const void* lens, void* o, void* lse,
                        int batch, int seq, int heads, float scale, int causal,
                        int window, int kv_bound, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mha_fwd_tf32_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + BQ - 1) / BQ, heads, batch);
  flash_mha_fwd_tf32_tc_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const int*>(lens),
      static_cast<float*>(o), static_cast<float*>(lse), seq, heads, scale,
      causal, window, kv_bound);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (three-pass TF32 route), 1 = bfloat16 (both on the
// tensor cores; qkv and o 16-byte aligned). lens may be null (no per-sample lengths);
// window < 0 and kv_bound < 0 mean none. Returns the CUDA error code of
// the launch (0 on success).
int forde_flash_mha_fwd(const void* qkv, const void* lens, void* o, void* lse,
                        int batch, int seq, int heads, int head_dim, int dtype,
                        float scale, int causal, int window, int kv_bound,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch_tf32<64>(qkv, lens, o, lse, batch, seq, heads, scale,
                           causal, window, kv_bound, st);
  if (dtype == 0 && head_dim == 128)
    return launch_tf32<128>(qkv, lens, o, lse, batch, seq, heads, scale,
                            causal, window, kv_bound, st);
  if (dtype == 1 && head_dim == 64)
    return launch_tc<64>(qkv, lens, o, lse, batch, seq, heads, scale, causal,
                         window, kv_bound, st);
  if (dtype == 1 && head_dim == 128)
    return launch_tc<128>(qkv, lens, o, lse, batch, seq, heads, scale, causal,
                          window, kv_bound, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
