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
//   * scores are fp32 products of the input values summed in fp32; p is
//     summed into l in fp32 and rounded to the input type before the
//     product with v (`p.astype(v.dtype)`); o = acc / l in the input type,
//     lse = m + log(l) in fp32, l == 0 guarded.
//
// Bound on the H100: at the serving prefill (B=8, H=8, S=2048, D=64, bf16,
// causal, window 512) q, k, v are read once and o, lse written once:
// ~68 MB, ~20 us at 3.35 TB/s; the visible products are 4*D per (query,
// key) over ~0.92M pairs per head: ~15 GFLOP, ~15 us at 989 TFLOP/s. So
// the two are close, the bytes slightly ahead. This simple kernel runs
// the products in fp32 on the CUDA cores (67 TFLOP/s), so it is bound by
// them: tensor cores (mma.sync, then wgmma with TMA) are the next step.
//
// Design (right and simple first): one block per (q tile of 64 rows, head,
// sample); the q tile is held in shared memory as fp32, and the block walks
// the k/v tiles of 64 keys with an online softmax (K and then V of a tile
// share one buffer), its 64 x D output in registers. Tiles wholly outside
// the causal / window / kv_len span are skipped, as `_loop_bounds` and
// `_stream_span` skip them: under a window of 512 a q tile reads 9 k tiles
// whatever S is, so the work grows linearly in S.

#include <math.h>

#include "common.cuh"

namespace {

using forde::from_float;
using forde::load_tile;
using forde::round_to;

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
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, float scale, int causal,
                 int window, int kv_len) {
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
  const int bh = blockIdx.z * gridDim.y + blockIdx.y;  // b * H + h
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;

  const long long base = (long long)bh * S * D;
  const T* q_g = q + base;
  const T* k_g = k + base;
  const T* v_g = v + base;

  // Tiles [j_begin, j_end) hold every key some row of this block may see.
  const int n_tiles = kv_len >= 0 ? (kv_len + BK - 1) / BK : S / BK;
  int j_end = n_tiles;
  if (causal) j_end = min(j_end, (q0 + BQ - 1) / BK + 1);
  const int j_begin = window >= 0 ? max(0, q0 - window + 1) / BK : 0;
  if (j_end <= j_begin) j_end = j_begin + 1;  // at least one tile, as on the TPU

  load_tile<T, D, THREADS>(q_s, q_g, q0, S, D);
  if (tid < BQ) {
    m_s[tid] = MASK_VALUE;
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
    load_tile<T, D, THREADS>(kv_s, k_g, k0, S, D);
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
        bool vis = kv_len < 0 || kc < kv_len;
        if (causal) vis = vis && qr >= kc;
        if (window >= 0) vis = vis && (qr - kc) < window;
        p_s[r * LP + c] = vis ? sc[i][j] * scale : MASK_VALUE;
      }
    }
    __syncthreads();

    // Online softmax: each warp owns 8 rows, each lane 2 keys of a row.
    // l sums the fp32 p; the PV product reads p rounded to the input type.
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const float s0 = p_s[r * LP + lane];
      const float s1 = p_s[r * LP + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      p_s[r * LP + lane] = round_to<T>(p0);
      p_s[r * LP + lane + 32] = round_to<T>(p1);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    // K is no longer read: the same buffer takes V.
    load_tile<T, D, THREADS>(kv_s, v_g, k0, S, D);
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qr = q0 + r;
    if (qr >= S) continue;
    const float l = l_s[r];
    const float l_safe = l == 0.f ? 1.f : l;
    T* orow = o + base + (long long)qr * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = from_float<T>(acc[i][j] / l_safe);
    if (tx == 0) lse[(long long)bh * S + qr] = m_s[r] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int heads, int seq, float scale,
                   int causal, int window, int kv_len, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(seq / BQ, heads, batch);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      seq, scale, causal, window, kv_len);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; seq a multiple of 64; window < 0 and
// kv_len < 0 mean none. Returns the CUDA error code of the launch (0 on
// success).
int forde_flash_fwd(const void* q, const void* k, const void* v, void* o,
                    void* lse, int batch, int heads, int seq, int head_dim,
                    int dtype, float scale, int causal, int window, int kv_len,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (seq % BQ != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k, v, o, lse, batch, heads, seq, scale, causal,
                             window, kv_len, st);
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k, v, o, lse, batch, heads, seq, scale,
                              causal, window, kv_len, st);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, batch, heads, seq, scale,
                                     causal, window, kv_len, st);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, batch, heads, seq,
                                      scale, causal, window, kv_len, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
