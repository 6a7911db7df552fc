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
// fp32 route (small_kv_fwd_split_kernel, then small_kv_fwd_merge_kernel):
// the CUDA cores, since the tensor cores would round fp32 to TF32. It runs
// fp32 serving (serve without --bf16, decode_scaling), checks and parity
// runs. What bounds it on the H100 is the K/V rows read once: at a decode
// step (S = 1) a (sample, head) holds one query and up to 8,192 keys, and
// decode_scaling's 4,096 pools on 4 heads are 8 MB, 2.5 us at 3.35 TB/s.
// The products are 4 * D per key and nothing to the card. So the route
// spreads the keys over the card: K is cut into chunks of whole 64-key
// tiles, as many as the wrapper asks for (`fwd_chunks` in
// ops/nsa_attention.py: a function of B, H, S and K alone, about 2 blocks
// per SM, 1 where the query tiles fill the card as a 2,048-row prefill
// does; no chunk empty), and each block walks its chunk's K and V tiles
// once with an online softmax in fp32: each row's running max m_c, its sum
// l_c of exp(s - m_c) and acc_c = sum exp(s - m_c) v. Scores and masks are
// skv_score's; a running max that is still -inf (every key so far padding)
// is taken as 0, so no -inf - -inf is ever formed and a chunk of padding
// adds nothing. A chunk whose keys are all masked is walked like any other:
// a row that sees no key gets the uniform distribution over the real keys
// (m = -1e9 in every chunk that holds one). Two block layouts, by S:
//   * S <= ROW_MAX_S (a decode step, a speculative verification): one
//     query row per block, 128 threads in groups of D / 4 lanes; a group
//     takes one key at a time, each lane one 16-byte piece of its K and V
//     rows (the row's q piece held in registers), the dot summed over the
//     group's lanes by shuffles. Each group keeps its own m, l and acc over
//     ROW_UNROLL keys a step, all loads issued first; the block then
//     combines its groups in group order. No FMA is spent on a row past S.
//   * larger S: 32 query rows per block, 16 x 16 threads of 2 rows x 4
//     keys for q k^T and 2 rows x D / 16 columns for w v, the q tile and
//     each 64-key K and V tile in shared memory (16-byte loads).
// With one chunk the block writes out = acc / l. With more, it writes (m_c,
// l_c, acc_c) to fp32 scratch the wrapper allocates, B * H * S * chunks *
// (D + 2) floats, and small_kv_fwd_merge_kernel combines the chunks in
// chunk order: m = max m_c, out = sum e^(m_c - m) acc_c / sum e^(m_c - m)
// l_c. No atomics: every sum has a fixed order, so two calls give the same
// bits. Against the TPU kernel's straight softmax (w = p / sum p, then w v)
// only the order of the fp32 sums and the point of the division differ; in
// fp32 `w.astype(v.dtype)` is the identity. Up to 8,192 keys
// (FWD_MAX_KEYS), as the bf16 route.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using forde::skv_score;
using forde::SKV_INVALID_KEY_POS;

constexpr int BK = 64;        // keys per tile
constexpr int FWD_MAX_KEYS = 8192;
constexpr int TC_BQ = 64;        // query rows per block (bf16 route)
constexpr int TC_THREADS = 128;  // 4 warps of 16 query rows
// The fp32 route: one query row per block up to ROW_MAX_S rows (ROW_THREADS
// threads, ROW_UNROLL keys per group a step), else BQ rows per block on a
// 16 x 16 thread grid; MERGE_THREADS threads per block of the merge, which
// loads MERGE_UNROLL chunks at a time.
constexpr int ROW_MAX_S = 8;
constexpr int ROW_THREADS = 128;
constexpr int ROW_UNROLL = 8;
constexpr int BQ = 32;
constexpr int THREADS = 256;
constexpr int MERGE_THREADS = 128;
constexpr int MERGE_UNROLL = 8;

// The q tile (then out on its way out), two stages of a K and a V tile,
// 64 x D bf16 each, and kp key thresholds.
template <int D>
size_t tc_smem_bytes(int kp) {
  return (TC_BQ * D + 4 * BK * D) * sizeof(__nv_bfloat16) + kp * sizeof(int);
}

// The fp32 route's 32-row layout: the q tile, a K and a V tile (pitch
// D + 1) and a 32 x 64 tile of exp(s - m).
template <int D>
size_t tile_smem_bytes() {
  return ((BQ + 2 * BK) * (D + 1) + BQ * (BK + 1)) * sizeof(float);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The max that exp(s - m) is taken against: 0 while every score so far is
// -inf (padding), so that no -inf - -inf is formed.
__device__ __forceinline__ float finite_max(float m) { return m == -INFINITY ? 0.f : m; }

// Rows [row0, row0 + ROWS) of a (rows, D) fp32 array into shared memory with
// pitch D + 1, 16 bytes a load; rows at or past `limit` are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0,
                                          int limit) {
  constexpr int L = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * L; idx += THREADS) {
    const int r = idx / L, c = 4 * (idx % L);
    const int g = row0 + r;
    const float4 x = g < limit ? ldg4(src + (long long)g * D + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    float* const d = dst + r * (D + 1) + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
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

// One row's result of one chunk: out = acc / l with one chunk; else acc into
// the scratch's (chunks, rows, D) part and, from the thread with `lead`,
// (m, l) into its (chunks, rows, 2) part.
struct Part {
  float* out;
  float* acc;  // nullptr: one chunk
  float* ml;
  int rows;    // B * H * S
  int chunk;
  __device__ __forceinline__ void put(int row, int col, float a, float m, float l,
                                     bool lead, int D) const {
    if (acc == nullptr) {
      out[(long long)row * D + col] = __fdividef(a, l);  // 1 <= l <= K: inline, no call
      return;
    }
    const long long r = (long long)chunk * rows + row;
    acc[r * D + col] = a;
    if (lead) {
      ml[2 * r] = m;
      ml[2 * r + 1] = l;
    }
  }
};

// S <= ROW_MAX_S: query row blockIdx.x against the chunk's keys [kb, ke).
// Group g of L = D / 4 lanes takes keys kb + g, kb + g + G, ...; at each of
// a step's ROW_UNROLL keys the G groups read G neighbouring rows.
template <int D>
__device__ __forceinline__ void row_chunk(const float* __restrict__ q,
                                          const float* __restrict__ k_g,
                                          const float* __restrict__ v_g,
                                          const int* __restrict__ pos_b, const Part& part,
                                          int S, int K, int kb, int ke, float scale) {
  constexpr int L = D / 4;
  constexpr int G = ROW_THREADS / L;
  __shared__ float m_s[G], l_s[G];
  __shared__ float4 acc_s[G][L];
  const int p = blockIdx.x;
  const int row = blockIdx.y * S + p;
  const int g = threadIdx.x / L, lane = threadIdx.x % L;
  const float4 qv = ldg4(q + (long long)row * D + 4 * lane);

  float m = -INFINITY, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int base = kb; base < ke; base += G * ROW_UNROLL) {
    float4 kr[ROW_UNROLL], vr[ROW_UNROLL];
    int kpos[ROW_UNROLL];
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) {
      const int j = base + u * G + g;
      const bool ok = j < ke;
      kr[u] = ok ? ldg4(k_g + (long long)j * D + 4 * lane) : make_float4(0.f, 0.f, 0.f, 0.f);
      vr[u] = ok ? ldg4(v_g + (long long)j * D + 4 * lane) : make_float4(0.f, 0.f, 0.f, 0.f);
      kpos[u] = ok ? __ldg(pos_b + j) : SKV_INVALID_KEY_POS;  // past ke: -inf
    }
    float s[ROW_UNROLL];
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) {
      float x = qv.x * kr[u].x;
      x = fmaf(qv.y, kr[u].y, x);
      x = fmaf(qv.z, kr[u].z, x);
      x = fmaf(qv.w, kr[u].w, x);
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      s[u] = skv_score(x * scale, p, base + u * G + g, K, kpos[u]);
      mx = fmaxf(mx, s[u]);
    }
    const float mn = fmaxf(m, mx), ms = finite_max(mn);
    const float alpha = expf(m - ms);
    l *= alpha;
    acc.x *= alpha;
    acc.y *= alpha;
    acc.z *= alpha;
    acc.w *= alpha;
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) {
      const float e = expf(s[u] - ms);
      l += e;
      acc.x = fmaf(e, vr[u].x, acc.x);
      acc.y = fmaf(e, vr[u].y, acc.y);
      acc.z = fmaf(e, vr[u].z, acc.z);
      acc.w = fmaf(e, vr[u].w, acc.w);
    }
    m = mn;
  }

  // The block's groups, combined in group order by the first group.
  if (lane == 0) {
    m_s[g] = m;
    l_s[g] = l;
  }
  acc_s[g][lane] = acc;
  __syncthreads();
  if (g != 0) return;
  float mb = -INFINITY;
#pragma unroll
  for (int i = 0; i < G; ++i) mb = fmaxf(mb, m_s[i]);
  const float ms = finite_max(mb);
  float lb = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const float w = expf(m_s[i] - ms);
    const float4 x = acc_s[i][lane];
    lb = fmaf(w, l_s[i], lb);
    a.x = fmaf(w, x.x, a.x);
    a.y = fmaf(w, x.y, a.y);
    a.z = fmaf(w, x.z, a.z);
    a.w = fmaf(w, x.w, a.w);
  }
  part.put(row, 4 * lane, a.x, mb, lb, lane == 0, D);
  part.put(row, 4 * lane + 1, a.y, mb, lb, false, D);
  part.put(row, 4 * lane + 2, a.z, mb, lb, false, D);
  part.put(row, 4 * lane + 3, a.w, mb, lb, false, D);
}

// Larger S: query rows q0 = 32 blockIdx.x .. q0 + 31 against the chunk's
// keys; thread (tx, ty) holds rows ty + 16i, keys k0 + tx + 16j of each
// score tile and columns tx + 16j of out.
template <int D>
__device__ __forceinline__ void tile_chunk(const float* __restrict__ q,
                                           const float* __restrict__ k_g,
                                           const float* __restrict__ v_g,
                                           const int* __restrict__ pos_b, const Part& part,
                                           int S, int K, int kb, int ke, float scale) {
  constexpr int LD = D + 1;
  constexpr int LW = BK + 1;  // pitch of the w tile
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;            // BQ x LD
  float* k_s = q_s + BQ * LD;   // BK x LD
  float* v_s = k_s + BK * LD;   // BK x LD
  float* w_s = v_s + BK * LD;   // BQ x LW: one tile's exp(s - m)

  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_rows<D, BQ>(q_s, q + (long long)blockIdx.y * S * D, q0, S);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's part
  float acc[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += BK) {
    __syncthreads();  // q_s written; the previous tiles consumed
    load_rows<D, BK>(k_s, k_g, k0, ke);
    load_rows<D, BK>(v_s, v_g, k0, ke);
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
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k0 + tx + 16 * j;
      const int kpos = c < ke ? pos_b[c] : SKV_INVALID_KEY_POS;  // past ke: -inf
#pragma unroll
      for (int i = 0; i < 2; ++i)
        sc[i][j] = skv_score(sc[i][j] * scale, q0 + ty + 16 * i, c, K, kpos);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mx = row_max16(fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3])));
      const float mn = fmaxf(m[i], mx), ms = finite_max(mn);
      const float alpha = expf(m[i] - ms);
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(sc[i][j] - ms);
        l[i] += e;
        w_s[(ty + 16 * i) * LW + tx + 16 * j] = e;
      }
      m[i] = mn;
    }
    __syncthreads();  // the w tile written
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float wv[2], vv[DJ];
#pragma unroll
      for (int i = 0; i < 2; ++i) wv[i] = w_s[(ty + 16 * i) * LW + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = v_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(wv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = row_sum16(l[i]);
    const int p = q0 + ty + 16 * i;
    if (p >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      part.put(blockIdx.y * S + p, tx + 16 * j, acc[i][j], m[i], li, tx == 0 && j == 0, D);
  }
}

// The fp32 route's walk: block (query tile, sample * head, chunk) over the
// chunk's whole 64-key tiles [c * per, min(tiles, (c + 1) * per)) once.
// ROWS = 1: one query row per block; ROWS = BQ: 32 rows, as many blocks an
// SM as tile_smem_bytes lets in (4 at D = 64, 2 at D = 128; without that
// bound ptxas holds the D = 128 case to 48 registers and spills).
template <int D, int ROWS>
__global__ void __launch_bounds__(ROWS == 1 ? ROW_THREADS : THREADS,
                                  ROWS == 1 ? 1 : (D == 64 ? 4 : 2))
small_kv_fwd_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const int* __restrict__ key_pos,
                          float* __restrict__ out, float* __restrict__ scratch, int H,
                          int S, int K, int per, float scale) {
  const int bh = blockIdx.y;  // b * H + h
  const int c = blockIdx.z;
  const int rows = gridDim.y * S;
  const Part part{out, scratch, scratch == nullptr ? nullptr : scratch + (long long)gridDim.z * rows * D,
                  rows, c};
  const int kb = c * per * BK, ke = min(K, kb + per * BK);
  const float* k_g = k + (long long)bh * K * D;
  const float* v_g = v + (long long)bh * K * D;
  const int* pos_b = key_pos + (long long)(bh / H) * K;
  if constexpr (ROWS == 1)
    row_chunk<D>(q, k_g, v_g, pos_b, part, S, K, kb, ke, scale);
  else
    tile_chunk<D>(q, k_g, v_g, pos_b, part, S, K, kb, ke, scale);
}

// The chunks of one row, in chunk order: thread (row, lane) takes columns
// 4 lane .. 4 lane + 3. The loads of MERGE_UNROLL chunks go out together;
// the sums still run chunk by chunk.
template <int D>
__global__ void __launch_bounds__(MERGE_THREADS)
small_kv_fwd_merge_kernel(const float* __restrict__ scratch, float* __restrict__ out, int rows,
                          int chunks) {
  constexpr int L = D / 4;
  const long long idx = (long long)blockIdx.x * MERGE_THREADS + threadIdx.x;
  const int row = (int)(idx / L), lane = (int)(idx % L);
  if (row >= rows) return;
  const float* ml = scratch + (long long)chunks * rows * D;
  float m = -INFINITY;
  for (int c0 = 0; c0 < chunks; c0 += MERGE_UNROLL) {
    float mc[MERGE_UNROLL];
#pragma unroll
    for (int u = 0; u < MERGE_UNROLL; ++u)
      mc[u] = c0 + u < chunks ? __ldg(ml + 2 * ((long long)(c0 + u) * rows + row)) : -INFINITY;
#pragma unroll
    for (int u = 0; u < MERGE_UNROLL; ++u) m = fmaxf(m, mc[u]);
  }
  const float ms = finite_max(m);
  float l = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < chunks; c0 += MERGE_UNROLL) {
    float mc[MERGE_UNROLL], lc[MERGE_UNROLL];
    float4 a[MERGE_UNROLL];
#pragma unroll
    for (int u = 0; u < MERGE_UNROLL; ++u) {
      const long long r = (long long)(c0 + u) * rows + row;
      const bool ok = c0 + u < chunks;
      mc[u] = ok ? __ldg(ml + 2 * r) : -INFINITY;
      lc[u] = ok ? __ldg(ml + 2 * r + 1) : 0.f;
      a[u] = ok ? ldg4(scratch + r * D + 4 * lane) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < MERGE_UNROLL; ++u) {
      if (c0 + u >= chunks) break;
      const float w = expf(mc[u] - ms);
      l = fmaf(w, lc[u], l);
      o.x = fmaf(w, a[u].x, o.x);
      o.y = fmaf(w, a[u].y, o.y);
      o.z = fmaf(w, a[u].z, o.z);
      o.w = fmaf(w, a[u].w, o.w);
    }
  }
  *reinterpret_cast<float4*>(out + (long long)row * D + 4 * lane) = make_float4(
      __fdividef(o.x, l), __fdividef(o.y, l), __fdividef(o.z, l), __fdividef(o.w, l));
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

// The fp32 route: the walk over `chunks` chunks of the key tiles (no chunk
// empty), then, with more than one, the merge. `scratch` holds B * H * S *
// chunks * (D + 2) floats; it is not read with one chunk.
template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, const void* key_pos,
                        void* out, void* scratch, int batch, int heads, int seq, int keys,
                        int chunks, float scale, cudaStream_t stream) {
  const int tiles = (keys + BK - 1) / BK;
  if (chunks < 1 || chunks > tiles) return cudaErrorInvalidValue;
  const int per = (tiles + chunks - 1) / chunks;
  if ((tiles + per - 1) / per != chunks || (chunks > 1 && scratch == nullptr))
    return cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* pos = static_cast<const int*>(key_pos);
  auto* of = static_cast<float*>(out);
  auto* part = chunks > 1 ? static_cast<float*>(scratch) : nullptr;
  const int bh = batch * heads;
  if (seq <= ROW_MAX_S) {
    small_kv_fwd_split_kernel<D, 1><<<dim3(seq, bh, chunks), ROW_THREADS, 0, stream>>>(
        qf, kf, vf, pos, of, part, heads, seq, keys, per, scale);
  } else {
    cudaError_t err = cudaFuncSetAttribute(small_kv_fwd_split_kernel<D, BQ>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)tile_smem_bytes<D>());
    if (err != cudaSuccess) return err;
    small_kv_fwd_split_kernel<D, BQ>
        <<<dim3((seq + BQ - 1) / BQ, bh, chunks), THREADS, tile_smem_bytes<D>(), stream>>>(
            qf, kf, vf, pos, of, part, heads, seq, keys, per, scale);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return err;
  const long long threads = (long long)bh * seq * (D / 4);
  small_kv_fwd_merge_kernel<D>
      <<<(unsigned)((threads + MERGE_THREADS - 1) / MERGE_THREADS), MERGE_THREADS, 0, stream>>>(
          part, of, bh * seq, chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the CUDA-core route, the keys in one chunk), 1 =
// bfloat16 (tensor-core route); q, k, v and out 16-byte aligned; 0 < keys
// <= 8192. Returns the CUDA error code of the launch (0 on success).
int forde_small_kv_fwd(const void* q, const void* k, const void* v,
                       const void* key_pos, void* out, int batch, int heads,
                       int seq, int keys, int head_dim, int dtype, float scale,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (keys <= 0 || keys > FWD_MAX_KEYS || seq <= 0) return (int)cudaErrorInvalidValue;
#define FORDE_SKV_FWD(DIM)                                                                 \
  return dtype == 0 ? launch_fp32<DIM>(q, k, v, key_pos, out, nullptr, batch, heads, seq, \
                                       keys, 1, scale, st)                                \
                    : launch_tc<DIM>(q, k, v, key_pos, out, batch, heads, seq, keys, scale, st)
  if ((dtype == 0 || dtype == 1) && head_dim == 64) FORDE_SKV_FWD(64);
  if ((dtype == 0 || dtype == 1) && head_dim == 128) FORDE_SKV_FWD(128);
#undef FORDE_SKV_FWD
  return (int)cudaErrorInvalidValue;
}

// The fp32 route with the keys cut into `chunks` chunks of whole 64-key
// tiles (1 <= chunks <= ceil(keys / 64), none empty: the wrapper's
// fwd_chunks) and, with more than one, fp32 scratch of batch * heads * seq
// * chunks * (head_dim + 2) floats; q, k, v and out 16-byte aligned.
int forde_small_kv_fwd_split(const void* q, const void* k, const void* v, const void* key_pos,
                            void* out, void* scratch, int batch, int heads, int seq, int keys,
                            int head_dim, int chunks, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (keys <= 0 || keys > FWD_MAX_KEYS || seq <= 0) return (int)cudaErrorInvalidValue;
  if (head_dim == 64)
    return launch_fp32<64>(q, k, v, key_pos, out, scratch, batch, heads, seq, keys, chunks,
                           scale, st);
  if (head_dim == 128)
    return launch_fp32<128>(q, k, v, key_pos, out, scratch, batch, heads, seq, keys, chunks,
                            scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
