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
// causal, window 512): q, k, v, do read once and dq, dk, dv written once,
// with lse and delta: ~126 MB, ~38 us at 3.35 TB/s; the products are
// 8 * D operations per visible (query, key) pair over ~0.92M pairs per head
// (q k^T, do v^T, ds k, ds^T q, p^T do): ~30 GFLOP, ~31 us at 989 TFLOP/s.
// So bytes and products are close. These simple kernels run the products
// in fp32 on the CUDA cores (67 TFLOP/s) and recompute p and dp in both
// kernels (7 tile products per tile pair where 5 are needed), so they are
// bound by their arithmetic; bf16 tensor cores (mma.sync, then wgmma with
// TMA) are the next step.
//
// Design (right and simple first), FA-2's split, both kernels with one
// block of 16 x 16 threads per (tile of 64, head, sample):
//   * dq: the block owns 64 query rows and walks the key tiles inside the
//     causal / window / kv_len span (as `_loop_bounds` bounds them);
//   * dk/dv: the block owns 64 keys and walks the query tiles from the
//     diagonal (causal) to the one holding k_start + 63 + window - 1, as
//     `_bwd_dkv_kernel` bounds them.
// Each output tile has one owner, so no sum crosses blocks: no atomics, and
// the result is deterministic. Tiles sit in shared memory as fp32 with row
// pitch D + 1 (conflict-free column reads).

#include <math.h>

#include "common.cuh"

namespace {

using forde::from_float;
using forde::load_tile;
using forde::probs;
using forde::round_to;
using forde::tile_dot;
using forde::tile_mac;

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 thread grid
constexpr int LP = BK + 1;    // pitch of a 64 x 64 tile of p or ds

// Both kernels: four 64 x (D + 1) tiles, one 64 x 65 tile, lse and delta.
template <int D>
constexpr size_t smem_bytes() {
  return (4 * 64 * (D + 1) + 64 * LP + 2 * 64) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
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

  // Key tiles [j_begin, j_end) hold every key some row of this block sees.
  const int keys = kv_len >= 0 ? min(kv_len, S) : S;
  int end_col = keys;
  if (causal) end_col = min(end_col, q0 + BQ);
  const int j_begin = window >= 0 ? max(0, q0 - window + 1) / BK : 0;
  const int j_end = (end_col + BK - 1) / BK;

  load_tile<T, D, THREADS>(q_s, q + base, q0, S, D);
  load_tile<T, D, THREADS>(do_s, dout + base, q0, S, D);
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
    load_tile<T, D, THREADS>(k_s, k + base, k0, S, D);
    load_tile<T, D, THREADS>(v_s, v + base, k0, S, D);
    __syncthreads();
    probs<D>(p, q_s, k_s, lse_s, q0, k0, S, keys, causal, window, scale, tx,
             ty);
    tile_dot<D>(dp, do_s, v_s, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ds_s[r * LP + tx + 16 * j] =
            round_to<T>(p[i][j] * (dp[i][j] - delta_s[r]) * scale);
    }
    __syncthreads();
    tile_mac<D, LP, 1>(acc, ds_s, k_s, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* row = dq + base + (long long)(q0 + ty + 16 * i) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = from_float<T>(acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, float scale, int causal,
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

  // Query tiles [i_begin, i_end) hold every row that sees some key of this
  // tile; with none (all keys past kv_len), dk and dv are 0.
  const int keys = kv_len >= 0 ? min(kv_len, S) : S;
  const int i_begin = causal ? k0 / BQ : 0;
  int i_end = k0 < keys ? S / BQ : 0;
  if (window >= 0) i_end = min(i_end, (k0 + BK - 1 + window - 1) / BQ + 1);

  load_tile<T, D, THREADS>(k_s, k + base, k0, S, D);
  load_tile<T, D, THREADS>(v_s, v + base, k0, S, D);

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
    load_tile<T, D, THREADS>(q_s, q + base, q0, S, D);
    load_tile<T, D, THREADS>(do_s, dout + base, q0, S, D);
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
    const long long row = base + (long long)(k0 + ty + 16 * i) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[row + tx + 16 * j] = from_float<T>(acc_dk[i][j]);
      dv[row + tx + 16 * j] = from_float<T>(acc_dv[i][j]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  int batch, heads, seq;
  float scale;
  int causal, window, kv_len;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.seq / BQ, a.heads, a.batch);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dq), a.seq, a.scale, a.causal, a.window, a.kv_len);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.seq / BK, a.heads, a.batch);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dk), static_cast<T*>(dv), a.seq, a.scale, a.causal,
      a.window, a.kv_len);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Both entry points: q, k, v, do (B, H, S, D) of one dtype (0 = float32,
// 1 = bfloat16), head_dim 64 or 128, seq a multiple of 64; lse and delta
// (B, H, S) fp32; window < 0 and kv_len < 0 mean none. Each returns the
// CUDA error code of its launch (0 on success).

int forde_flash_bwd_dq(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int batch, int heads, int seq, int head_dim,
                       int dtype, float scale, int causal, int window,
                       int kv_len, void* stream) {
  if (seq % BQ != 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, batch, heads, seq, scale, causal,
               window, kv_len, static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && head_dim == 64) return launch_dq<float, 64>(a, dq);
  if (dtype == 0 && head_dim == 128) return launch_dq<float, 128>(a, dq);
  if (dtype == 1 && head_dim == 64) return launch_dq<__nv_bfloat16, 64>(a, dq);
  if (dtype == 1 && head_dim == 128) return launch_dq<__nv_bfloat16, 128>(a, dq);
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
  if (dtype == 0 && head_dim == 64) return launch_dkv<float, 64>(a, dk, dv);
  if (dtype == 0 && head_dim == 128) return launch_dkv<float, 128>(a, dk, dv);
  if (dtype == 1 && head_dim == 64)
    return launch_dkv<__nv_bfloat16, 64>(a, dk, dv);
  if (dtype == 1 && head_dim == 128)
    return launch_dkv<__nv_bfloat16, 128>(a, dk, dv);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
