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
// and v. Products are fp32 multiplies of the (rounded) input values, summed
// in fp32, as the TPU kernel's `_dot` accumulates in fp32. The mask is the
// forward's (common.cuh `visible`).
//
// Bound on the H100 at the training shapes (batch 128, bf16): vision
// (S=200, H=6, D=128) moves about 276 MB (qkv and do read, dqkv written):
// ~82 us at 3.35 TB/s, against ~39 GFLOP of products, ~40 us at 989
// TFLOP/s. Text (S=64, H=4, D=128) moves about 59 MB: ~18 us. So memory
// bounds it.
//
// Design (right and simple first), FA-2's split into two kernels, both with
// one block of 16 x 16 threads per (tile of 64 rows, head, sample):
//   * dq: the block owns 64 query rows. A first walk over the key tiles sums
//     delta for its rows and writes it for the second kernel; a second walk
//     recomputes p and dp, forms ds and accumulates dq = ds k in registers.
//   * dk/dv: the block owns 64 keys, walks the query tiles that can see
//     them, and accumulates dv = p^T do and dk = ds^T q in registers.
// Each output element is summed by one thread in a fixed order: no atomics,
// the result is deterministic. Tiles that no row can see are skipped. Tiles
// sit in shared memory as fp32 with row pitch D + 1 (conflict-free column
// reads), and the products run on the CUDA cores: 9 tile products per
// (query tile, key tile) where the math needs 5. So this kernel is bound by
// its arithmetic, not by the bytes above; tensor cores (wgmma), TMA and one
// pass with dq summed by atomics are the next steps.

#include <math.h>

#include "common.cuh"

namespace {

using forde::from_float;
using forde::load_tile;
using forde::round_to;
using forde::visible;

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 thread grid
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

// out[i][j] = sum_d a[row ty + 16i][d] * b[row tx + 16j][d] over two fp32
// tiles of pitch D + 1, with the forward kernel's order of summation.
template <int D>
__device__ __forceinline__ void tile_dot(float out[4][4], const float* a,
                                         const float* b, int tx, int ty) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(av[i], bv[j], out[i][j]);
  }
}

// acc[i][j] += sum_c p(ty + 16i, c) * m[row c][col tx + 16j] for c < 64,
// where p(r, c) = p_s[r * RS + c * CS]: (RS, CS) = (LP, 1) reads the 64 x 64
// tile as it is, (1, LP) reads its transpose.
template <int D, int RS, int CS>
__device__ __forceinline__ void tile_mac(float acc[4][D / 16], const float* p_s,
                                         const float* m, int tx, int ty) {
  constexpr int LD = D + 1;
#pragma unroll 4
  for (int c = 0; c < 64; ++c) {
    float pv[4], mv[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * RS + c * CS];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) mv[j] = m[c * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(pv[i], mv[j], acc[i][j]);
  }
}

// p of rows q0 + ty + 16i, keys k0 + tx + 16j from the scores of q_s and
// k_s: exp(s * scale - lse) where visible, else selected to 0.
template <int D>
__device__ __forceinline__ void probs(float p[4][4], const float* q_s,
                                      const float* k_s, const float* lse_s,
                                      int q0, int k0, int S, int kv_len,
                                      int causal, int window, float scale,
                                      int tx, int ty) {
  tile_dot<D>(p, q_s, k_s, tx, ty);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qr = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kc = k0 + tx + 16 * j;
      const bool vis = qr < S && visible(qr, kc, kv_len, causal, window);
      p[i][j] = vis ? expf(p[i][j] * scale - lse_s[r]) : 0.f;
    }
  }
}

__device__ __forceinline__ int key_count(const int* lens, int b, int S,
                                         int kv_bound) {
  int kv_len = S;
  if (lens != nullptr) kv_len = min(kv_len, lens[b]);
  if (kv_bound >= 0) kv_len = min(kv_len, kv_bound);
  return kv_len;
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

  // Key tiles [j_begin, j_end) hold every key some row of this block sees;
  // with none, dq is 0 and so is delta.
  const int kv_len = key_count(lens, b, S, kv_bound);
  const int q_last = min(q0 + BQ, S) - 1;
  int end_col = kv_len;
  if (causal) end_col = min(end_col, q_last + 1);
  const int j_begin = window >= 0 ? max(0, q0 - window + 1) / BK : 0;
  const int j_end = (end_col + BK - 1) / BK;

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

  // Query tiles [i_begin, i_end) hold every row that sees some key of this
  // tile; with none (all keys past kv_len), dk and dv are 0.
  const int kv_len = key_count(lens, b, S, kv_bound);
  const int i_begin = causal ? k0 / BQ : 0;
  int i_end = k0 < kv_len ? (S + BQ - 1) / BQ : 0;
  if (window >= 0)
    i_end = min(i_end, (min(S, k0 + BK - 1 + window) + BQ - 1) / BQ);

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

// dtype: 0 = float32, 1 = bfloat16 (qkv, do and dqkv). lse and the delta
// scratch are (B, H, S) fp32. lens may be null (no per-sample lengths);
// window < 0 and kv_bound < 0 mean none. Returns the CUDA error code of the
// launches (0 on success).
int forde_flash_mha_bwd(const void* qkv, const void* dout, const void* lse,
                        const void* lens, void* dqkv, void* delta, int batch,
                        int seq, int heads, int head_dim, int dtype,
                        float scale, int causal, int window, int kv_bound,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FORDE_BWD_LAUNCH(T, D)                                             \
  return launch<T, D>(qkv, dout, lse, lens, dqkv, delta, batch, seq, heads, \
                      scale, causal, window, kv_bound, st)
  if (dtype == 0 && head_dim == 64) FORDE_BWD_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) FORDE_BWD_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) FORDE_BWD_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) FORDE_BWD_LAUNCH(__nv_bfloat16, 128);
#undef FORDE_BWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
