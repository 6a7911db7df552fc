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
// keys (masked scores -1e9, padding and INVALID_KEY_POS keys -inf, w = p /
// sum(p) in fp32), then
//   dv = round(w)^T do, w rounded to the input type;
//   dw = do v^T;  ds = w * (dw - sum_keys(dw * w)), ZEROED where the mask
//        was false (the -1e9 entries too: in a row with no visible key they
//        carry the uniform weight, so such a row adds to dv but not to dq
//        or dk; padding keys get nothing), times scale, rounded to the input
//        type;
//   dq = ds k (written in the input type);  dk = ds^T q.
// Products are fp32 multiplies of the (rounded) values summed in fp32.
//
// dk and dv sum over every query row, and blocks own query tiles. On the
// TPU the sequential grid carried the sum in the output block (`:151-157`);
// Hopper runs blocks in no order, so each block adds its tile's share into
// fp32 dk and dv with atomicAdd (the wrapper zeroes them and casts them to
// the input type at the end, as the TPU code casts its fp32 outputs). The
// order of those fp32 additions changes from run to run: the result is not
// bit-reproducible, and differs from an ordered sum by at most (S / 32)
// fp32 roundings of the terms' magnitude.
//
// Bound on the H100 at the training shapes (B=8, H=8, S=2048, D=64, bf16;
// K = 192 pools or 64 top-k): q and do read once, k, v, key_pos once, dq,
// dk, dv written once: ~34 MB, ~10 us; the products are 8 * D operations
// per visible (query, key) pair (q k^T, do v^T, w^T do, ds k, ds^T q):
// at most ~13 GFLOP at K = 192, ~13 us at 989 TFLOP/s. This simple kernel
// runs them in fp32 on the CUDA cores and computes dw twice (once for the
// row sum, once for ds): 6 products per key tile where 5 are needed, so it
// is bound by its arithmetic and by the atomics (2 * K * D per block).
//
// Design (right and simple first): one block of 16 x 16 threads per (q
// tile of 32 rows, sample * head). The scores of the 32 rows against every
// key stay in shared memory as fp32 weights w (K <= 1024: at most 131 KB),
// the keys stream through one 64-row tile buffer (K, V, V, then K again
// per tile), and the softmax is the TPU kernel's straight one.

#include <math.h>

#include "common.cuh"

namespace {

using forde::from_float;
using forde::round_to;
using forde::to_float;

constexpr int BQ = 32;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 thread grid
constexpr int MAX_KEYS = 1024;
constexpr int INVALID_KEY_POS = 1 << 30;
constexpr float NEG_BIG = -1e9f;
constexpr int LP = BK + 1;    // pitch of the 32 x 64 ds tile

// q, do (BQ x (D+1)), one key tile (BK x (D+1)), the weights (BQ x (kp+1)),
// the ds tile (BQ x LP), the row sums (BQ); then kp thresholds.
template <int D>
size_t smem_bytes(int kp) {
  return (2 * BQ * (D + 1) + BK * (D + 1) + BQ * (kp + 1) + BQ * LP + BQ) *
             sizeof(float) +
         kp * sizeof(int);
}

// Rows [0, ROWS) of a (rows, D) slice into fp32 shared memory with pitch
// D + 1; rows at or past `limit` are zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0,
                                          int limit) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int g = row0 + r;
    dst[r * (D + 1) + d] = g < limit ? to_float(src[(long long)g * D + d]) : 0.f;
  }
}

// dw of rows ty + 16i, keys tx + 16j of the tile in kv_s (V): do_s kv_s^T.
template <int D>
__device__ __forceinline__ void tile_dw(float dw[2][4], const float* do_s,
                                        const float* kv_s, int tx, int ty) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dw[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[2], b[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) a[i] = do_s[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = kv_s[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dw[i][j] = fmaf(a[i], b[j], dw[i][j]);
  }
}

// out[key k0 + ty + 16i][col tx + 16j] += sum_r m(r, ty + 16i) * x[r][col]
// over the block's 32 rows, added into fp32 global memory with atomicAdd;
// m(r, c) = m_s[r * pitch + c], keys at or past K skipped.
template <int D>
__device__ __forceinline__ void add_key_tile(float* out, const float* m_s,
                                             int pitch, const float* x_s,
                                             int k0, int K, int tx, int ty) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int r = 0; r < BQ; ++r) {
    float mv[4], xv[DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) mv[i] = m_s[r * pitch + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < DJ; ++j) xv[j] = x_s[r * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(mv[i], xv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= K) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      atomicAdd(out + (long long)key * D + tx + 16 * j, acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
small_kv_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ key_pos,
                    const T* __restrict__ dout, T* __restrict__ dq,
                    float* __restrict__ dk, float* __restrict__ dv, int H,
                    int S, int K, float scale) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  const int kp = (K + BK - 1) / BK * BK;
  const int LS = kp + 1;  // pitch of weight rows

  extern __shared__ float smem[];
  float* q_s = smem;              // BQ x LD
  float* do_s = q_s + BQ * LD;    // BQ x LD
  float* kv_s = do_s + BQ * LD;   // BK x LD: a K or V tile
  float* w_s = kv_s + BK * LD;    // BQ x LS: scores, then fp32 weights
  float* ds_s = w_s + BQ * LS;    // BQ x LP: rounded ds of one key tile
  float* rsum_s = ds_s + BQ * LP; // BQ: sum_keys(dw * w) per row
  int* pos_s = reinterpret_cast<int*>(rsum_s + BQ);  // kp thresholds

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;

  const T* k_g = k + (long long)bh * K * D;
  const T* v_g = v + (long long)bh * K * D;
  float* dk_g = dk + (long long)bh * K * D;
  float* dv_g = dv + (long long)bh * K * D;

  load_rows<T, D, BQ>(q_s, q + (long long)bh * S * D, q0, S);
  load_rows<T, D, BQ>(do_s, dout + (long long)bh * S * D, q0, S);
  for (int j = tid; j < kp; j += THREADS)
    pos_s[j] = j < K ? key_pos[(long long)b * K + j] : INVALID_KEY_POS;

  // 1. Scores of rows ty + 16i against keys k0 + tx + 16j, every key tile.
  for (int k0 = 0; k0 < kp; k0 += BK) {
    __syncthreads();  // q_s and pos_s written; the previous tile consumed
    load_rows<T, D, BK>(kv_s, k_g, k0, K);
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
      for (int j = 0; j < 4; ++j) kv[j] = kv_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty + 16 * i;
      const int p = q0 + r;  // the query's position
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const int kpos = pos_s[c];
        float s;
        if (c >= K || kpos >= INVALID_KEY_POS) {
          s = -INFINITY;  // padding key: excluded absolutely
        } else {
          s = p >= kpos ? sc[i][j] * scale : NEG_BIG;
        }
        w_s[r * LS + c] = s;
      }
    }
  }
  __syncthreads();

  // 2. Straight softmax over the K keys (fp32 weights kept unrounded): each
  // warp owns 4 rows.
  for (int rr = 0; rr < BQ / 8; ++rr) {
    const int r = warp * (BQ / 8) + rr;
    float* row = w_s + r * LS;
    float mx = -INFINITY;
    for (int c = lane; c < kp; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int c = lane; c < kp; c += 32) {
      const float p = expf(row[c] - mx);
      row[c] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int c = lane; c < kp; c += 32) row[c] = row[c] / sum;
  }

  // 3. Per V tile: dw for the row sums, and dv += round(w)^T do. The ds
  // tile buffer holds the tile's rounded weights for the dv product.
  float rsum[2] = {0.f, 0.f};
  float dw[2][4];
  for (int k0 = 0; k0 < kp; k0 += BK) {
    __syncthreads();  // the weights are written; the previous tile consumed
    load_rows<T, D, BK>(kv_s, v_g, k0, K);
    for (int idx = tid; idx < BQ * BK; idx += THREADS) {
      const int r = idx / BK, c = idx % BK;
      ds_s[r * LP + c] = round_to<T>(w_s[r * LS + k0 + c]);
    }
    __syncthreads();
    tile_dw<D>(dw, do_s, kv_s, tx, ty);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rsum[i] = fmaf(dw[i][j], w_s[(ty + 16 * i) * LS + k0 + tx + 16 * j],
                       rsum[i]);
    add_key_tile<D>(dv_g, ds_s, LP, do_s, k0, K, tx, ty);
  }
  // The 16 threads of a row are lanes tx = 0..15 of one half-warp.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], off);
  if (tx == 0) {
    rsum_s[ty] = rsum[0];
    rsum_s[ty + 16] = rsum[1];
  }

  // 4. Per tile: dw again, ds, then dq += ds K and dk += ds^T q.
  float acc[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < kp; k0 += BK) {
    __syncthreads();  // rsum_s written; the previous tile consumed
    load_rows<T, D, BK>(kv_s, v_g, k0, K);
    __syncthreads();
    tile_dw<D>(dw, do_s, kv_s, tx, ty);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const int kpos = pos_s[c];
        const bool vis = c < K && kpos < INVALID_KEY_POS && q0 + r >= kpos;
        const float w = w_s[r * LS + c];
        const float ds = vis ? w * (dw[i][j] - rsum_s[r]) : 0.f;
        ds_s[r * LP + tx + 16 * j] = round_to<T>(ds * scale);
      }
    }
    __syncthreads();  // ds_s is written and nobody reads V any more
    load_rows<T, D, BK>(kv_s, k_g, k0, K);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[2], kv[DJ];
#pragma unroll
      for (int i = 0; i < 2; ++i) dsv[i] = ds_s[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = kv_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
    add_key_tile<D>(dk_g, ds_s, LP, q_s, k0, K, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = q0 + ty + 16 * i;
    if (p >= S) continue;
    T* row = dq + ((long long)bh * S + p) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = from_float<T>(acc[i][j]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* key_pos, const void* dout, void* dq, void* dk,
                   void* dv, int batch, int heads, int seq, int keys,
                   float scale, cudaStream_t stream) {
  const int kp = (keys + BK - 1) / BK * BK;
  cudaError_t err = cudaFuncSetAttribute(
      small_kv_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<D>(MAX_KEYS));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + BQ - 1) / BQ, batch * heads);
  small_kv_bwd_kernel<T, D><<<grid, THREADS, smem_bytes<D>(kp), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(key_pos),
      static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), heads, seq, keys,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do, dq); dk and dv are fp32
// accumulators of (B, H, K, D) that the caller zeroes; 0 < keys <= 1024.
// Returns the CUDA error code of the launch (0 on success).
int forde_small_kv_bwd(const void* q, const void* k, const void* v,
                       const void* key_pos, const void* dout, void* dq,
                       void* dk, void* dv, int batch, int heads, int seq,
                       int keys, int head_dim, int dtype, float scale,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (keys <= 0 || keys > MAX_KEYS || seq <= 0) return (int)cudaErrorInvalidValue;
#define FORDE_SKV_BWD(T, DIM)                                                 \
  return launch<T, DIM>(q, k, v, key_pos, dout, dq, dk, dv, batch, heads, seq, \
                        keys, scale, st)
  if (dtype == 0 && head_dim == 64) FORDE_SKV_BWD(float, 64);
  if (dtype == 0 && head_dim == 128) FORDE_SKV_BWD(float, 128);
  if (dtype == 1 && head_dim == 64) FORDE_SKV_BWD(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) FORDE_SKV_BWD(__nv_bfloat16, 128);
#undef FORDE_SKV_BWD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
