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
// Products are fp32 multiplies of the input values, summed in fp32, as the
// JAX kernel's `_dot` accumulates in fp32.
//
// Bound on the H100: at the serving shapes (batch 128, bf16) the work is
// far below the card's ridge point. Vision (S=200, H=6, D=128) moves about
// 158 MB (qkv read once, o and lse written once): ~47 us at 3.35 TB/s,
// against 15.7 GFLOP, ~16 us at 989 TFLOP/s. Text (S=64, H=4, D=128) moves
// about 34 MB: ~10 us. So memory bounds it.
//
// Design (right and simple first): one block per (q tile of 64 rows, head,
// sample); the TPU kernel's one-sample-per-program layout came from VMEM
// size and is not carried over. The block keeps its q tile in shared
// memory as fp32, walks the k/v tiles of 64 keys with an online softmax
// (K and then V of a tile share one buffer), and keeps its 64 x D output
// in registers. Every qkv element of a (sample, head) is read from device
// memory once per q tile; the reads of the later tiles hit L2. Tiles that
// every row of the block masks (past kv_len, past the diagonal when
// causal, before the window) are skipped. The products run on the CUDA
// cores in fp32, so this kernel is bound by its arithmetic, not by the
// bytes above; tensor cores (wgmma) and TMA are the next step.

#include <math.h>

#include "common.cuh"

namespace {

using forde::from_float;
using forde::load_tile;
using forde::visible;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 thread grid
constexpr float MASK_VALUE = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return ((BQ + BK) * (D + 1) + BQ * (BK + 1) + 3 * BQ) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_mha_fwd_kernel(const T* __restrict__ qkv, const int* __restrict__ lens,
                     T* __restrict__ o, float* __restrict__ lse, int S, int H,
                     float scale, int causal, int window, int kv_bound) {
  constexpr int LD = D + 1;   // pitch of q/kv rows: conflict-free column reads
  constexpr int LP = BK + 1;  // pitch of score rows
  constexpr int DJ = D / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* q_s = smem;             // BQ x LD
  float* kv_s = q_s + BQ * LD;   // BK x LD: K of the tile, then its V
  float* p_s = kv_s + BK * LD;   // BQ x LP: scores, then probabilities
  float* m_s = p_s + BQ * LP;    // running row max
  float* l_s = m_s + BQ;         // running row sum
  float* a_s = l_s + BQ;         // rescale factor of the current tile

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;

  const long long stride = 3LL * H * D;
  const T* base = qkv + (long long)b * S * stride;
  const T* q_g = base + (long long)h * D;
  const T* k_g = base + (long long)(H + h) * D;
  const T* v_g = base + (long long)(2 * H + h) * D;

  // Keys at or past kv_len are masked for every row.
  int kv_len = S;
  if (lens != nullptr) kv_len = min(kv_len, lens[b]);
  if (kv_bound >= 0) kv_len = min(kv_len, kv_bound);

  // Tiles [j_begin, j_end) hold every key some row of this block may see.
  const int q_last = min(q0 + BQ, S) - 1;
  int end_col = kv_len;
  if (causal) end_col = min(end_col, q_last + 1);
  const int j_begin = window >= 0 ? max(0, q0 - window + 1) / BK : 0;
  int j_end = (end_col + BK - 1) / BK;
  // At least one tile, so a row with every key masked still sees -1e30
  // scores (m = -1e30, zeroed output, lse = -1e30) as the TPU kernel does.
  if (j_end <= j_begin) j_end = j_begin + 1;

  load_tile<T, D, THREADS>(q_s, q_g, q0, S, stride);
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int jt = j_begin; jt < j_end; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();  // the previous tile is done with kv_s and p_s
    load_tile<T, D, THREADS>(kv_s, k_g, k0, S, stride);
    __syncthreads();

    // Scores of rows ty + 16i, keys tx + 16j.
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kv_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qr = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kc = k0 + c;
        float s;
        if (kc >= S) {
          s = -INFINITY;  // not a key at all: contributes nothing
        } else {
          s = sc[i][j] * scale;
          if (!visible(qr, kc, kv_len, causal, window)) s = MASK_VALUE;
        }
        p_s[r * LP + c] = s;
      }
    }
    __syncthreads();

    // Online softmax: each warp owns 8 rows, each lane 2 keys of a row.
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const float s0 = p_s[r * LP + lane];
      const float s1 = p_s[r * LP + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);  // finite: key k0 < S is in range
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      p_s[r * LP + lane] = p0;
      p_s[r * LP + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    // K is no longer read: the same buffer takes V.
    load_tile<T, D, THREADS>(kv_s, v_g, k0, S, stride);
    __syncthreads();

    // acc = alpha * acc + P V for rows ty + 16i, columns tx + 16j.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = kv_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  const int HD = H * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qr = q0 + r;
    if (qr >= S) continue;
    const float m = m_s[r];
    const float l = l_s[r];
    const float l_safe = l == 0.f ? 1.f : l;
    const float valid = m > MASK_VALUE * 0.5f ? 1.f : 0.f;
    T* orow = o + ((long long)b * S + qr) * HD + (long long)h * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      orow[tx + 16 * j] = from_float<T>(acc[i][j] / l_safe * valid);
    if (tx == 0) lse[((long long)b * H + h) * S + qr] = m + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* qkv, const void* lens, void* o, void* lse,
                   int batch, int seq, int heads, float scale, int causal,
                   int window, int kv_bound, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mha_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + BQ - 1) / BQ, heads, batch);
  flash_mha_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const int*>(lens),
      static_cast<T*>(o), static_cast<float*>(lse), seq, heads, scale, causal,
      window, kv_bound);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. lens may be null (no per-sample
// lengths); window < 0 and kv_bound < 0 mean none. Returns the CUDA error
// code of the launch (0 on success).
int forde_flash_mha_fwd(const void* qkv, const void* lens, void* o, void* lse,
                        int batch, int seq, int heads, int head_dim, int dtype,
                        float scale, int causal, int window, int kv_bound,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(qkv, lens, o, lse, batch, seq, heads, scale,
                             causal, window, kv_bound, st);
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(qkv, lens, o, lse, batch, seq, heads, scale,
                              causal, window, kv_bound, st);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(qkv, lens, o, lse, batch, seq, heads,
                                     scale, causal, window, kv_bound, st);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(qkv, lens, o, lse, batch, seq, heads,
                                      scale, causal, window, kv_bound, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
