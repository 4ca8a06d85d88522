// Multi-head attention forward for Hopper (sm_90a): softmax(q k^T / sqrt(d) +
// key bias) v, one block per (batch, head, tile of query rows).
//
// Replaces the TPU kernel vilbert_tpu/ops/pallas_attention_train.py::_fwd_kernel
// (K1), with its in-kernel attention-probability dropout, and serves
// vilbert_tpu/ops/pallas_attention.py::_attn_kernel (K3, K1 at rate 0). Same
// arithmetic: scores and softmax in fp32; with dropout, P times the fp32
// 1/(1 - rate) where _keep_mask keeps (keep_mask.cuh, hashed from the GLOBAL
// query row, the key column and the tile seed of (batch, head)) and 0
// elsewhere; P then rounded to v's dtype before the PV product, PV
// accumulated in fp32, output in q's dtype. Rate 0 compiles the mask out
// (kDrop = false), so evaluation runs the code it ran before dropout existed.
//
// What bounds it on the H100: at the shapes of ViLBERT (S <= 101, d = 64 or
// 128) each (batch, head) moves 3 S d elements in and S d out and does 4 S^2 d
// flops, well below the card's ridge point. The design keeps device-memory
// traffic near that floor: q, k and v are read straight from the [B, S, H]
// output of the projections through strides (no head transposes in device
// memory), the [Sq, Sk] score tile lives only in shared memory, and the
// output is written once in [B, Sq, H]. The products run on the CUDA cores
// in fp32, so what bounds the kernel itself is shared-memory bandwidth: each
// thread keeps a 4 x 4 tile of scores (and a 4 x d/16 tile of the output) in
// registers, so every shared-memory load feeds 2 to 2.7 FMAs.
// Tensor cores (wgmma) are work for a later, faster version.
//
// Keys are walked in tiles of kBlockK rows in two passes (QK^T into the score
// tile, then PV), so shared memory grows only with Sk * kBlockQ and Sk up to
// kMaxKeys fits: 115 KB at Sk = 512, d = 128, above the 48 KB default, hence
// cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "keep_mask.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlockQ = 32;   // query rows per block
constexpr int kBlockK = 64;   // key/value rows per shared-memory tile
constexpr int kMaxKeys = 512;
// thread (ty, tx), ty in [0, 8), tx in [0, 16): query rows 4 ty .. 4 ty + 3,
// keys (and output columns) tx, tx + 16, ...
constexpr int kTx = 16;
constexpr int kRowsPerThread = kBlockQ / (kThreads / kTx);  // 4
constexpr int kKeysPerThread = kBlockK / kTx;              // 4

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [row0, row0 + n) of one head of x ([B, S, H] through strides) into
// dst as fp32 with row stride D + 1, which spreads a column of consecutive
// rows over distinct banks; rows past `rows` are zero
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ x, int row0, int n,
                                          int rows, int64_t rstride) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = row0 + r < rows ? to_float(x[(row0 + r) * rstride + c]) : 0.f;
  }
}

template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ bias, T* __restrict__ out, int num_heads, int sq,
                     int sk, int q_tiles, int64_t q_bstride, int64_t q_rstride,
                     int64_t k_bstride, int64_t k_rstride, int64_t v_bstride,
                     int64_t v_rstride, int64_t bias_bstride, float scale,
                     uint32_t seed, uint32_t threshold, float keep_scale) {
  constexpr int kCols = D / kTx;  // output columns per thread
  extern __shared__ float smem[];
  const int p_stride = (sk + kBlockK - 1) / kBlockK * kBlockK + 1;
  float* q_s = smem;                          // [kBlockQ][D + 1]
  float* kv_s = q_s + kBlockQ * (D + 1);      // [kBlockK][D + 1]
  float* p_s = kv_s + kBlockK * (D + 1);      // [kBlockQ][p_stride] scores, then P

  const int tile = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;
  const int h = bh % num_heads;
  const int64_t b = bh / num_heads;
  const int q0 = tile * kBlockQ;
  const int tid = threadIdx.x;
  const int tx = tid % kTx, ty = tid / kTx;

  const T* qb = q + b * q_bstride + h * D;
  const T* kb = k + b * k_bstride + h * D;
  const T* vb = v + b * v_bstride + h * D;
  const float* bias_b = bias + b * bias_bstride;

  load_rows<T, D>(q_s, qb, q0, kBlockQ, sq, q_rstride);

  // scores: thread -> rows 4 ty + i, keys k0 + tx + 16 j
  for (int k0 = 0; k0 < sk; k0 += kBlockK) {
    __syncthreads();  // q_s written / previous tile consumed
    load_rows<T, D>(kv_s, kb, k0, kBlockK, sk, k_rstride);
    __syncthreads();
    float acc[kRowsPerThread][kKeysPerThread] = {};
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[kRowsPerThread], kk[kKeysPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) a[i] = q_s[(ty * kRowsPerThread + i) * (D + 1) + c];
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) kk[j] = kv_s[(tx + kTx * j) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j) acc[i][j] += a[i] * kk[j];
    }
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const int key = k0 + tx + kTx * j;
      if (key < sk) {
        const float bj = bias_b[key];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          p_s[(ty * kRowsPerThread + i) * p_stride + key] = acc[i][j] * scale + bj;
      }
    }
  }
  __syncthreads();

  // softmax over the sk valid columns of each row, one warp per row, then
  // the dropout mask of the row's global query index
  const int warp = tid / 32, lane = tid % 32;
  const uint32_t tseed = vt::tile_seed(seed, bh);
  for (int r = warp; r < kBlockQ; r += kThreads / 32) {
    float* row = p_s + r * p_stride;
    float m = -INFINITY;
    for (int j = lane; j < sk; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < sk; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int j = lane; j < sk; j += 32) {
      float p = row[j] / l;
      if (kDrop) p = vt::keep(q0 + r, j, tseed, threshold) ? p * keep_scale : 0.f;
      row[j] = to_float(from_float<T>(p));
    }
  }

  // PV: thread -> rows 4 ty + i, output columns tx + 16 m
  float o[kRowsPerThread][kCols] = {};
  for (int k0 = 0; k0 < sk; k0 += kBlockK) {
    __syncthreads();  // softmax done / previous tile consumed
    load_rows<T, D>(kv_s, vb, k0, kBlockK, sk, v_rstride);
    __syncthreads();
    const int kn = min(kBlockK, sk - k0);
    for (int j = 0; j < kn; ++j) {
      float p[kRowsPerThread], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        p[i] = p_s[(ty * kRowsPerThread + i) * p_stride + k0 + j];
#pragma unroll
      for (int m = 0; m < kCols; ++m) vv[m] = kv_s[j * (D + 1) + tx + kTx * m];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int m = 0; m < kCols; ++m) o[i][m] += p[i] * vv[m];
    }
  }
  const int64_t hidden = (int64_t)num_heads * D;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = q0 + ty * kRowsPerThread + i;
    if (row < sq) {
      T* orow = out + (b * sq + row) * hidden + h * D;
#pragma unroll
      for (int m = 0; m < kCols; ++m) orow[tx + kTx * m] = from_float<T>(o[i][m]);
    }
  }
}

size_t smem_bytes(int d, int sk) {
  const int p_stride = (sk + kBlockK - 1) / kBlockK * kBlockK + 1;
  return sizeof(float) * ((size_t)(kBlockQ + kBlockK) * (d + 1) + (size_t)kBlockQ * p_stride);
}

template <typename T, int D, bool kDrop>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                   int batch, int num_heads, int sq, int sk, long long q_bs, long long q_rs,
                   long long k_bs, long long k_rs, long long v_bs, long long v_rs,
                   long long bias_bs, float scale, uint32_t seed, uint32_t threshold,
                   float keep_scale, cudaStream_t stream) {
  const int q_tiles = (sq + kBlockQ - 1) / kBlockQ;
  const long long blocks = (long long)batch * num_heads * q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  // per call, so the cap holds on whichever device is current
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, D, kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(D, kMaxKeys));
  if (err != cudaSuccess) return err;
  attention_fwd_kernel<T, D, kDrop><<<(unsigned)blocks, kThreads, smem_bytes(D, sk), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), num_heads, sq, sk, q_tiles, q_bs,
      q_rs, k_bs, k_rs, v_bs, v_rs, bias_bs, scale, seed, threshold, keep_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Dropout:
// the call's uint32 seed, the uint32 keep threshold and the fp32 keep scale
// 1/(1 - rate), all computed by the caller; threshold 0 and scale 1 mean
// rate 0. Returns a cudaError_t; cudaErrorInvalidValue for a dtype, head_dim
// or key count the kernel does not take (the Python wrapper checks these
// first).
extern "C" int vt_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                                void* out, int dtype, int batch, int num_heads, int head_dim,
                                int sq, int sk, long long q_bstride, long long q_rstride,
                                long long k_bstride, long long k_rstride, long long v_bstride,
                                long long v_rstride, long long bias_bstride, float scale,
                                unsigned int seed, unsigned int threshold, float keep_scale,
                                void* stream) {
  if (sk < 1 || sk > kMaxKeys || sq < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = threshold != 0u || keep_scale != 1.f;
#define VT_LAUNCH(T, D)                                                                        \
  return (int)(drop ? launch<T, D, true>(q, k, v, bias, out, batch, num_heads, sq, sk,         \
                                         q_bstride, q_rstride, k_bstride, k_rstride,           \
                                         v_bstride, v_rstride, bias_bstride, scale, seed,      \
                                         threshold, keep_scale, s)                             \
                    : launch<T, D, false>(q, k, v, bias, out, batch, num_heads, sq, sk,        \
                                          q_bstride, q_rstride, k_bstride, k_rstride,          \
                                          v_bstride, v_rstride, bias_bstride, scale, seed,     \
                                          threshold, keep_scale, s))
  if (dtype == 0 && head_dim == 64) VT_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) VT_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) VT_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) VT_LAUNCH(__nv_bfloat16, 128);
#undef VT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
