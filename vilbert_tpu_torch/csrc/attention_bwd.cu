// Multi-head attention backward for Hopper (sm_90a): dq, dk, dv of
// softmax(q k^T / sqrt(d) + key bias) [dropout] v, one block per (batch, head).
//
// Replaces the TPU kernel vilbert_tpu/ops/pallas_attention_train.py::_bwd_kernel
// (K2), and at rate 0 the XLA backward of vilbert_tpu/ops/pallas_attention.py
// (_folded_bwd, the same math). It saves nothing from the forward: it
// recomputes P in fp32 from q, k and the bias, regenerates the forward's
// dropout mask from the seed (keep_mask.cuh), and follows _bwd_kernel:
//   P_drop = keep ? P / (1 - rate) : 0
//   dv = P_drop^T g
//   dp = keep ? (g v^T) / (1 - rate) : 0
//   ds = P (dp - rowsum(dp P))                  (the undropped P)
//   dq = ds k / sqrt(d),  dk = ds^T q / sqrt(d)
// All products accumulate in fp32; the outputs are in the inputs' dtype.
//
// What bounds it on the H100: memory. A (batch, head) reads 4 S d elements
// and writes 3 S d, and does 10 S^2 d flops: about 1.4 S flop per byte in
// bf16, far below the card's ridge of ~295. At CC image self-attention
// (B 256, h 8, d 128, 37 x 37) the bytes take 0.041 ms. Both variants read
// q, k, v and g through the strides of the [B, S, H] projections (no head
// transposes), keep the [Sq, Sk] tiles on chip and write dq, dk and dv once
// each as [B, S, H]. Every output element is written by one block, so there
// are no atomics and the result is deterministic.
//
// Four variants; the Python wrapper picks one by dtype and shape and counts
// each. Up to 128 queries and keys a block holds a whole (batch, head):
//
// * tensor cores (tc::, bf16, Sq, Sk <= 128). q, k, v and g arrive by
//   16-byte cp.async in bf16 (rows padded by 16 bytes, zero past S). One
//   warp per 16 query rows recomputes S and P on mma.sync.m16n8k16 with the
//   forward's register softmax, gets dP = g v^T on the same mma, forms the
//   mask, dp, the rowsum (quad shuffles) and ds in registers, stages P_drop
//   and ds in shared memory as bf16, and computes dq = ds k from ds in
//   registers. Then one warp per 16 keys computes dv = P_drop^T g and
//   dk = ds^T q, the transposed operands through ldmatrix.trans. The TPU
//   kernel keeps P_drop and ds in fp32; rounding them to bf16 as mma
//   operands is this variant's one departure from it.
// * CUDA cores (cc::, fp32; it takes bf16 too, but the wrapper sends bf16
//   to the tensor cores): the products as fp32 FMAs, each thread a register
//   tile (R x R of P, R x 2 of each output), operand columns staged 32 at a
//   time as fp32, P and ds in fp32 shared memory; at Sq = Sk = 128 and
//   d = 128, 192 KB. It served bf16 too before the tensor-core variant; its
//   bf16 times on an H100 80GB HBM3 at 700 W (B 256, rate 0.1): 0.615 ms at
//   CC image self-attention (37 x 37, h 8, d 128; 5.8 TFLOP/s), 0.476 ms at
//   CC text self-attention (36 x 36, h 12, d 64). chip_smoke.py times it
//   beside the tensor-core variant.
//
// Past 128 (to 1024) the work is cut into tiles of 64 queries and 64 keys
// over two kernels and an fp32 workspace of row statistics [3][B h][Sq],
// which the wrapper sizes: shared memory and registers do not grow with
// the length, so the cap is a constant:
//
// * long, CUDA cores (lk::, fp32; it takes bf16 too), and
// * long, tensor cores (lktc::, bf16), the same two kernels on mma.sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "keep_mask.cuh"
#include "mma_bf16.cuh"

namespace {

// ---- CUDA-core variant ------------------------------------------------------
namespace cc {

constexpr int kThreads = 256;
constexpr int kT = 16;          // threads per side of the 16 x 16 thread grid
constexpr int kChunk = 32;      // operand columns staged at a time
constexpr int kCS = kChunk + 1; // staged row stride: a column spreads over banks
constexpr int kMaxSeq = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// columns [c0, c0 + kChunk) of rows [0, rows) of one head of x ([B, S, H]
// through strides, already offset to the head) into dst as fp32; rows
// [rows, S) are zero
template <typename T, int S>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ x, int rows,
                                      int64_t rstride, int c0) {
  for (int i = threadIdx.x; i < S * kChunk; i += kThreads) {
    const int r = i / kChunk, c = i % kChunk;
    dst[r * kCS + c] = r < rows ? to_float(x[r * rstride + c0 + c]) : 0.f;
  }
}

// acc[i][j] = sum_c a[row_i][c] b[col_j][c] over the head's D columns, for
// rows ty + kT i and columns tx + kT j; a and b are one head of [B, S, H]
template <typename T, int D, int S>
__device__ __forceinline__ void row_products(float (&acc)[S / kT][S / kT], float* a_s,
                                             float* b_s, const T* a, int a_rows,
                                             int64_t a_rstride, const T* b, int b_rows,
                                             int64_t b_rstride, int ty, int tx) {
  constexpr int R = S / kT;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;
  for (int c0 = 0; c0 < D; c0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    stage<T, S>(a_s, a, a_rows, a_rstride, c0);
    stage<T, S>(b_s, b, b_rows, b_rstride, c0);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kChunk; ++c) {
      float av[R], bv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) av[i] = a_s[(ty + kT * i) * kCS + c];
#pragma unroll
      for (int j = 0; j < R; ++j) bv[j] = b_s[(tx + kT * j) * kCS + c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] += av[i] * bv[j];
    }
  }
}

template <typename T, int D, int S>
__global__ void __launch_bounds__(kThreads)
attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ bias, const T* __restrict__ g,
                     T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int num_heads,
                     int sq, int sk, int64_t q_bstride, int64_t q_rstride, int64_t k_bstride,
                     int64_t k_rstride, int64_t v_bstride, int64_t v_rstride, int64_t g_bstride,
                     int64_t g_rstride, int64_t bias_bstride, float scale, bool drop,
                     uint32_t seed, uint32_t threshold, float keep_scale) {
  constexpr int R = S / kT;
  constexpr int PS = S + 1;  // row stride of the [Sq, Sk] tiles
  extern __shared__ float smem[];
  float* p_s = smem;                 // [sq][PS]: P, then P_drop
  float* ds_s = p_s + sq * PS;       // [sq][PS]: ds
  float* a_s = ds_s + sq * PS;       // [S][kCS] staging
  float* b_s = a_s + S * kCS;        // [S][kCS]
  float* c_s = b_s + S * kCS;        // [S][kCS]
  float* part_s = c_s + S * kCS;     // [S][kT + 1] partial row sums
  float* rs_s = part_s + S * (kT + 1);  // [S] row sums of dp P

  const int bh = blockIdx.x;
  const int h = bh % num_heads;
  const int64_t b = bh / num_heads;
  const int tid = threadIdx.x;
  const int tx = tid % kT, ty = tid / kT;
  const T* qb = q + b * q_bstride + h * D;
  const T* kb = k + b * k_bstride + h * D;
  const T* vb = v + b * v_bstride + h * D;
  const T* gb = g + b * g_bstride + h * D;
  const float* bias_b = bias + b * bias_bstride;

  // 1. P = softmax(q k^T * scale + bias), fp32, rows in p_s
  float acc[R][R];
  row_products<T, D, S>(acc, a_s, b_s, qb, sq, q_rstride, kb, sk, k_rstride, ty, tx);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = ty + kT * i;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int col = tx + kT * j;
      if (row < sq && col < sk) p_s[row * PS + col] = acc[i][j] * scale + bias_b[col];
    }
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < sq; r += kThreads / 32) {
    float* prow = p_s + r * PS;
    float m = -INFINITY;
    for (int j = lane; j < sk; j += 32) m = fmaxf(m, prow[j]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int j = lane; j < sk; j += 32) {
      const float e = expf(prow[j] - m);
      prow[j] = e;
      l += e;
    }
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    for (int j = lane; j < sk; j += 32) prow[j] = prow[j] / l;
  }

  // 2. dp = mask(g v^T), kept in registers; row sums of dp P (the syncs
  // inside row_products also complete P)
  row_products<T, D, S>(acc, a_s, b_s, gb, sq, g_rstride, vb, sk, v_rstride, ty, tx);
  const uint32_t tseed = vt::tile_seed(seed, bh);
  uint64_t kept = 0;  // bit i R + j: element (i, j) of this thread is kept
  float part[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = ty + kT * i;
    part[i] = 0.f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int col = tx + kT * j;
      if (row < sq && col < sk) {
        float dp = acc[i][j];
        if (drop) {
          const bool kp = vt::keep(row, col, tseed, threshold);
          kept |= (uint64_t)kp << (i * R + j);
          dp = kp ? dp * keep_scale : 0.f;
        }
        acc[i][j] = dp;
        part[i] += dp * p_s[row * PS + col];
      }
    }
    if (row < sq) part_s[row * (kT + 1) + tx] = part[i];
  }
  __syncthreads();
  if (tid < sq) {
    float s = 0.f;
    for (int t = 0; t < kT; ++t) s += part_s[tid * (kT + 1) + t];
    rs_s[tid] = s;
  }
  __syncthreads();
  // 3. ds = P (dp - rowsum); P becomes P_drop
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = ty + kT * i;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int col = tx + kT * j;
      if (row < sq && col < sk) {
        const float p = p_s[row * PS + col];
        ds_s[row * PS + col] = p * (acc[i][j] - rs_s[row]);
        if (drop) p_s[row * PS + col] = (kept >> (i * R + j)) & 1u ? p * keep_scale : 0.f;
      }
    }
  }

  // 4. dv = P_drop^T g, dk = ds^T q scale, dq = ds k scale, 32 columns at a
  // time: thread -> key / query rows ty + kT i, columns c0 + tx + kT m
  const int64_t hidden = (int64_t)num_heads * D;
  for (int c0 = 0; c0 < D; c0 += kChunk) {
    __syncthreads();  // ds / P_drop written; the previous chunk is consumed
    stage<T, S>(a_s, gb, sq, g_rstride, c0);
    stage<T, S>(b_s, qb, sq, q_rstride, c0);
    stage<T, S>(c_s, kb, sk, k_rstride, c0);
    __syncthreads();
    float dv_acc[R][2] = {}, dk_acc[R][2] = {}, dq_acc[R][2] = {};
    for (int r = 0; r < sq; ++r) {
      float gv[2], qv[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        gv[m] = a_s[r * kCS + tx + kT * m];
        qv[m] = b_s[r * kCS + tx + kT * m];
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int key = min(ty + kT * i, sk - 1);  // rows past sk are discarded
        const float pd = p_s[r * PS + key], d = ds_s[r * PS + key];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          dv_acc[i][m] += pd * gv[m];
          dk_acc[i][m] += d * qv[m];
        }
      }
    }
    for (int key = 0; key < sk; ++key) {
      float kv[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) kv[m] = c_s[key * kCS + tx + kT * m];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float d = ds_s[min(ty + kT * i, sq - 1) * PS + key];
#pragma unroll
        for (int m = 0; m < 2; ++m) dq_acc[i][m] += d * kv[m];
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = ty + kT * i;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int64_t col = h * D + c0 + tx + kT * m;
        if (row < sk) {
          dv[(b * sk + row) * hidden + col] = from_float<T>(dv_acc[i][m]);
          dk[(b * sk + row) * hidden + col] = from_float<T>(dk_acc[i][m] * scale);
        }
        if (row < sq) dq[(b * sq + row) * hidden + col] = from_float<T>(dq_acc[i][m] * scale);
      }
    }
  }
}

size_t smem_bytes(int s, int sq) {
  return sizeof(float) *
         ((size_t)2 * sq * (s + 1) + (size_t)3 * s * kCS + (size_t)s * (kT + 1) + s);
}

template <typename T, int D, int S>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, const void* g,
                   void* dq, void* dk, void* dv, int batch, int num_heads, int sq, int sk,
                   long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                   long long v_bs, long long v_rs, long long g_bs, long long g_rs,
                   long long bias_bs, float scale, bool drop, uint32_t seed, uint32_t threshold,
                   float keep_scale, cudaStream_t stream) {
  const long long blocks = (long long)batch * num_heads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  // per call, so the cap holds on whichever device is current
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel<T, D, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(S, S));
  if (err != cudaSuccess) return err;
  attention_bwd_kernel<T, D, S><<<(unsigned)blocks, kThreads, smem_bytes(S, sq), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const T*>(g), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), num_heads, sq, sk, q_bs, q_rs, k_bs, k_rs, v_bs,
      v_rs, g_bs, g_rs, bias_bs, scale, drop, seed, threshold, keep_scale);
  return cudaGetLastError();
}

}  // namespace cc

// ---- tensor-core variant (bf16) --------------------------------------------
namespace tc {

constexpr int kMaxSeq = 128;
constexpr int kMaxWarps = kMaxSeq / 16;

struct Args {
  const vt::bf16* q;
  const vt::bf16* k;
  const vt::bf16* v;
  const float* bias;
  const vt::bf16* g;
  vt::bf16* dq;
  vt::bf16* dk;
  vt::bf16* dv;
  int num_heads, sq, sk;
  int64_t q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, g_bs, g_rs, bias_bs;  // in elements
  float scale;
  bool drop;
  uint32_t seed, threshold;
  float keep_scale;
};

// q, g [sqp][D + 8], k, v [skp][D + 8], P_drop, ds [sqp][skp + 8] (bf16),
// bias [skp] (fp32)
size_t smem_bytes(int d, int sq, int sk) {
  const size_t sqp = (sq + 15) / 16 * 16, skp = (sk + 15) / 16 * 16;
  return sizeof(vt::bf16) * (2 * (sqp + skp) * (d + 8) + 2 * sqp * (skp + 8)) +
         sizeof(float) * skp;
}

// KT: tiles of 16 (queries and keys) the accumulators are sized for (4 or
// 8); loops run over the call's own counts
template <int D, int KT>
// one block an SM is enough to fill the SM's memory pipe at these sizes:
// minBlocks 1 lets ptxas keep every accumulator in registers (no spills)
__global__ void __launch_bounds__(32 * kMaxWarps, 1) attention_bwd_tc_kernel(const Args a) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int qt = (a.sq + 15) / 16, kt = (a.sk + 15) / 16;
  const int sqp = 16 * qt, skp = 16 * kt, PL = skp + 8;
  vt::bf16* q_s = reinterpret_cast<vt::bf16*>(smem_raw);
  vt::bf16* g_s = q_s + sqp * LD;
  vt::bf16* k_s = g_s + sqp * LD;
  vt::bf16* v_s = k_s + skp * LD;
  vt::bf16* pd_s = v_s + skp * LD;  // P_drop [query][key]
  vt::bf16* ds_s = pd_s + sqp * PL;  // ds [query][key]
  float* bias_s = reinterpret_cast<float*>(ds_s + sqp * PL);

  const int bh = blockIdx.x;
  const int h = bh % a.num_heads;
  const int64_t b = bh / a.num_heads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nthreads = blockDim.x, nwarps = nthreads / 32;

  vt::load_head_rows<D>(q_s, a.q + b * a.q_bs + h * D, a.sq, sqp, a.q_rs, tid, nthreads);
  vt::load_head_rows<D>(g_s, a.g + b * a.g_bs + h * D, a.sq, sqp, a.g_rs, tid, nthreads);
  vt::load_head_rows<D>(k_s, a.k + b * a.k_bs + h * D, a.sk, skp, a.k_rs, tid, nthreads);
  vt::load_head_rows<D>(v_s, a.v + b * a.v_bs + h * D, a.sk, skp, a.v_rs, tid, nthreads);
  for (int j = tid; j < skp; j += nthreads) bias_s[j] = j < a.sk ? a.bias[b * a.bias_bs + j] : 0.f;
  vt::cp_async_commit();
  vt::cp_async_wait<0>();
  __syncthreads();

  const uint32_t tseed = vt::tile_seed(a.seed, bh);
  const int64_t hidden = (int64_t)a.num_heads * D;

  // 1. per 16 query rows: P, dp, ds; P_drop and ds to shared memory; dq
  for (int strip = warp; strip < qt; strip += nwarps) {
    const int r0 = 16 * strip;
    // S = q k^T, then dP = g v^T: two passes, so that only the S and dP
    // accumulators and one pass's fragments are live at a time (no spills
    // at d = 128, Sk = 128)
    float s[2 * KT][4], dp[2 * KT][4];
    vt::products_abt<D, KT>(s, q_s, k_s, r0, kt, lane);
    vt::softmax_strip<KT>(s, kt, a.sk, a.scale, bias_s, lane);
    vt::products_abt<D, KT>(dp, g_s, v_s, r0, kt, lane);
    // P, the mask, dp and the rowsum of dp P (the undropped P)
    const int row = r0 + lane / 4;
    uint64_t kept = 0;  // bit 4 n + e: element e of tile n is kept
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n) {
      if (n < 2 * kt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = s[n][e];
          float d = dp[n][e];
          if (a.drop) {
            const bool kp = vt::keep(row + 8 * (e / 2), 8 * n + 2 * (lane % 4) + e % 2, tseed,
                                     a.threshold);
            kept |= (uint64_t)kp << (4 * n + e);
            d = kp ? d * a.keep_scale : 0.f;
          }
          dp[n][e] = d;
          rs[e / 2] += d * p;
        }
      }
    }
    rs[0] = vt::quad_sum(rs[0]);
    rs[1] = vt::quad_sum(rs[1]);
    // ds into dp, P_drop into s; rows past Sq are zero
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n) {
      if (n < 2 * kt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = row + 8 * (e / 2) < a.sq;
          const float p = s[n][e];
          dp[n][e] = valid ? p * (dp[n][e] - rs[e / 2]) : 0.f;
          float pd = p;
          if (a.drop) pd = (kept >> (4 * n + e)) & 1u ? p * a.keep_scale : 0.f;
          s[n][e] = valid ? pd : 0.f;
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int idx = (row + 8 * half) * PL + 8 * n + 2 * (lane % 4);
          *reinterpret_cast<uint32_t*>(pd_s + idx) =
              vt::pack_bf16(s[n][2 * half], s[n][2 * half + 1]);
          *reinterpret_cast<uint32_t*>(ds_s + idx) =
              vt::pack_bf16(dp[n][2 * half], dp[n][2 * half + 1]);
        }
      }
    }
    // dq = ds k scale, ds straight from the registers
    uint32_t da[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j)
      if (j < kt) vt::c_to_a(da[j], dp[2 * j], dp[2 * j + 1]);
    float acc[D / 8][4];
    vt::products_ab<D, KT>(acc, da, k_s, kt, lane);
    vt::store_strip<D>(a.dq + b * a.sq * hidden + h * D, acc, row, a.sq, hidden, a.scale, lane);
  }
  __syncthreads();

  // 2. per 16 keys: dv = P_drop^T g and dk = ds^T q scale
  for (int strip = warp; strip < kt; strip += nwarps) {
    const int m0 = 16 * strip;
    const int row = m0 + lane / 4;
#pragma unroll 1
    for (int which = 0; which < 2; ++which) {
      const vt::bf16* a_s = which == 0 ? pd_s : ds_s;
      const vt::bf16* b_s = which == 0 ? g_s : q_s;
      float acc[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        if (i < qt) {
          uint32_t ta[4];
          vt::load_a_trans(ta, a_s, PL, 16 * i, m0, lane);
#pragma unroll
          for (int nd = 0; nd < D / 16; ++nd) {
            uint32_t bb[4];
            vt::load_b_kn(bb, b_s, LD, 16 * i, 16 * nd, lane);
            vt::mma_bf16(acc[2 * nd], ta, bb[0], bb[1]);
            vt::mma_bf16(acc[2 * nd + 1], ta, bb[2], bb[3]);
          }
        }
      }
      vt::store_strip<D>((which == 0 ? a.dv : a.dk) + b * a.sk * hidden + h * D, acc, row,
                         a.sk, hidden, which == 0 ? 1.f : a.scale, lane);
    }
  }
}

template <int D, int KT>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const long long blocks = (long long)batch * a.num_heads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_tc_kernel<D, KT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(D, 16 * KT, 16 * KT));
  if (err != cudaSuccess) return err;
  const int warps = (max(a.sq, a.sk) + 15) / 16;
  attention_bwd_tc_kernel<D, KT>
      <<<(unsigned)blocks, 32 * warps, smem_bytes(D, a.sq, a.sk), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc

// ---- long-sequence variant (CUDA cores, 128 < Sq or Sk <= 1024) ----------
//
// A (batch, head) no longer fits one block, so the work is cut into tiles of
// 64 queries and 64 keys and spread over two kernels, each tile walking the
// other axis in a loop (the TPU kernel's sequential grid step becomes that
// loop). No atomics: every output element is written by one block.
//
// 1. rows_dq, one block per (batch, head, 64 queries): walks the key tiles
//    once for the softmax row max m, row sum l and D = rowsum(dp P) (online,
//    rescaled as m grows), writes (m, l, D) to an fp32 workspace
//    [3][B h][Sq], then walks the key tiles again to form
//    ds = P (dp - D) and accumulate dq = ds k / sqrt(d).
// 2. dkdv, one block per (batch, head, 64 keys): walks the query tiles,
//    recomputes P from (m, l), the mask, dp and ds, and accumulates
//    dv = P_drop^T g and dk = ds^T q / sqrt(d).
//
// Products are fp32 FMAs on the 16 x 16 thread grid of the CUDA-core
// variant (each thread 4 x 4 of a 64 x 64 score tile, operand columns
// staged 32 at a time: cc::row_products), ds and P_drop staged in fp32
// shared memory. S and dP are computed three times over (stats, dq, dk/dv):
// the price of no atomics and no [Sq, Sk] buffer in device memory. It is
// bound by bytes on paper (about 1.4 S flop per byte) but by these fp32
// products in practice; chip_smoke.py times it against its bound.
namespace lk {

constexpr int kTile = 64;            // queries and keys a tile
constexpr int kR = kTile / cc::kT;   // rows (and columns) of a tile per thread
constexpr int kPS = kTile + 1;       // row stride of the staged ds / P_drop tiles
constexpr int kMaxSeq = 1024;

// reductions over the 16 threads of one tile row (tx = lane % 16)
__device__ __forceinline__ float row_max16(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const void* g;
  void* dq;
  void* dk;
  void* dv;
  float* stats;  // [3][B h][Sq]: row max, row sum, D
  int num_heads, sq, sk;
  int64_t q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, g_bs, g_rs, bias_bs;  // in elements
  float scale;
  bool drop;
  uint32_t seed, threshold;
  float keep_scale;
};

// the score of one element, q.k scale + bias, rounded after the product and
// after the sum as the plain version rounds it: near the -10000 of a padded
// key fp32 spacing is 2^-10, so one fused rounding would move P by ~1e-3
__device__ __forceinline__ float score(float qk, float scale, float bias) {
  return __fadd_rn(__fmul_rn(qk, scale), bias);
}

// dp of one element: the dropped, rescaled g v^T
__device__ __forceinline__ float dropped(float dp, const Args& a, int row, int col,
                                         uint32_t tseed, bool* kept) {
  *kept = true;
  if (!a.drop) return dp;
  *kept = vt::keep(row, col, tseed, a.threshold);
  return *kept ? dp * a.keep_scale : 0.f;
}

template <typename T, int D>
__global__ void __launch_bounds__(cc::kThreads) attention_bwd_rows_dq_kernel(const Args a) {
  extern __shared__ float smem[];
  float* a_s = smem;                     // [kTile][kCS] staging
  float* b_s = a_s + kTile * cc::kCS;    // [kTile][kCS]
  float* ds_s = b_s + kTile * cc::kCS;   // [kTile][kPS]: ds of the key tile

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int h = bh % a.num_heads;
  const int64_t b = bh / a.num_heads;
  const int tx = threadIdx.x % cc::kT, ty = threadIdx.x / cc::kT;
  const int rows = min(kTile, a.sq - q0);
  const T* qb = static_cast<const T*>(a.q) + b * a.q_bs + q0 * a.q_rs + h * D;
  const T* gb = static_cast<const T*>(a.g) + b * a.g_bs + q0 * a.g_rs + h * D;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_bs + h * D;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_bs + h * D;
  const float* bias_b = a.bias + b * a.bias_bs;
  const uint32_t tseed = vt::tile_seed(a.seed, bh);

  // 1. row max, row sum and D = sum_j p dp, online over the key tiles
  float s[kR][kR], dp[kR][kR];
  float mx[kR], l[kR], dsum[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) mx[i] = -INFINITY, l[i] = 0.f, dsum[i] = 0.f;
  for (int k0 = 0; k0 < a.sk; k0 += kTile) {
    const int keys = min(kTile, a.sk - k0);
    cc::row_products<T, D, kTile>(s, a_s, b_s, qb, rows, a.q_rs, kb + k0 * a.k_rs, keys,
                                  a.k_rs, ty, tx);
    cc::row_products<T, D, kTile>(dp, a_s, b_s, gb, rows, a.g_rs, vb + k0 * a.v_rs, keys,
                                  a.v_rs, ty, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int row = ty + cc::kT * i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int col = tx + cc::kT * j;
        s[i][j] = col < keys ? score(s[i][j], a.scale, bias_b[k0 + col]) : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      // every tile holds a valid key (col 0), so the new max is finite
      const float mn = fmaxf(mx[i], row_max16(tmax));
      float ls = 0.f, dl = 0.f;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int col = tx + cc::kT * j;
        if (col < keys) {
          bool kept;
          const float e = expf(s[i][j] - mn);
          ls += e;
          dl += e * dropped(dp[i][j], a, q0 + row, k0 + col, tseed, &kept);
        }
      }
      const float c = expf(mx[i] - mn);  // 0 at the first tile (mx = -inf)
      l[i] = l[i] * c + row_sum16(ls);
      dsum[i] = dsum[i] * c + row_sum16(dl);
      mx[i] = mn;
    }
  }
  float dd[kR];
  const int64_t n = (int64_t)gridDim.x * a.sq;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = ty + cc::kT * i;
    dd[i] = dsum[i] / l[i];
    if (tx == 0 && row < rows) {
      const int64_t at = (int64_t)bh * a.sq + q0 + row;
      a.stats[at] = mx[i];
      a.stats[n + at] = l[i];
      a.stats[2 * n + at] = dd[i];
    }
  }

  // 2. dq = ds k scale over the key tiles; thread -> query rows ty + kT i,
  // columns tx + kT c
  float acc[kR][D / cc::kT];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < D / cc::kT; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < a.sk; k0 += kTile) {
    const int keys = min(kTile, a.sk - k0);
    cc::row_products<T, D, kTile>(s, a_s, b_s, qb, rows, a.q_rs, kb + k0 * a.k_rs, keys,
                                  a.k_rs, ty, tx);
    cc::row_products<T, D, kTile>(dp, a_s, b_s, gb, rows, a.g_rs, vb + k0 * a.v_rs, keys,
                                  a.v_rs, ty, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int row = ty + cc::kT * i;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int col = tx + cc::kT * j;
        float ds = 0.f;  // zero past Sk: those staged k rows are zero too
        if (col < keys) {
          bool kept;
          const float p = expf(score(s[i][j], a.scale, bias_b[k0 + col]) - mx[i]) / l[i];
          ds = p * (dropped(dp[i][j], a, q0 + row, k0 + col, tseed, &kept) - dd[i]);
        }
        ds_s[row * kPS + col] = ds;
      }
    }
    const T* kt = kb + k0 * a.k_rs;
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += cc::kChunk) {
      __syncthreads();  // ds written; the previous chunk is consumed
      cc::stage<T, kTile>(b_s, kt, keys, a.k_rs, c0);
      __syncthreads();
#pragma unroll 8
      for (int j = 0; j < kTile; ++j) {
        const float k_lo = b_s[j * cc::kCS + tx], k_hi = b_s[j * cc::kCS + tx + cc::kT];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const float d = ds_s[(ty + cc::kT * i) * kPS + j];
          acc[i][c0 / cc::kT] += d * k_lo;
          acc[i][c0 / cc::kT + 1] += d * k_hi;
        }
      }
    }
  }
  const int64_t hidden = (int64_t)a.num_heads * D;
  T* dq = static_cast<T*>(a.dq) + (b * a.sq + q0) * hidden + h * D;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = ty + cc::kT * i;
    if (row < rows)
#pragma unroll
      for (int c = 0; c < D / cc::kT; ++c)
        dq[row * hidden + tx + cc::kT * c] = cc::from_float<T>(acc[i][c] * a.scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(cc::kThreads) attention_bwd_dkdv_kernel(const Args a) {
  extern __shared__ float smem[];
  float* a_s = smem;                     // [kTile][kCS] staging
  float* b_s = a_s + kTile * cc::kCS;    // [kTile][kCS]
  float* ds_s = b_s + kTile * cc::kCS;   // [kTile][kPS]: ds [query][key]
  float* pd_s = ds_s + kTile * kPS;      // [kTile][kPS]: P_drop [query][key]
  float* st_s = pd_s + kTile * kPS;      // [3][kTile]: the query tile's m, l, D

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int h = bh % a.num_heads;
  const int64_t b = bh / a.num_heads;
  const int tid = threadIdx.x, tx = tid % cc::kT, ty = tid / cc::kT;
  const int keys = min(kTile, a.sk - k0);
  const T* kb = static_cast<const T*>(a.k) + b * a.k_bs + k0 * a.k_rs + h * D;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_bs + k0 * a.v_rs + h * D;
  const T* qh = static_cast<const T*>(a.q) + b * a.q_bs + h * D;
  const T* gh = static_cast<const T*>(a.g) + b * a.g_bs + h * D;
  const float* bias_b = a.bias + b * a.bias_bs + k0;
  const uint32_t tseed = vt::tile_seed(a.seed, bh);
  const int64_t n = (int64_t)gridDim.x * a.sq;

  // thread -> key rows ty + kT i, columns tx + kT c
  float dk_acc[kR][D / cc::kT], dv_acc[kR][D / cc::kT];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < D / cc::kT; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  float s[kR][kR], dp[kR][kR];
  for (int q0 = 0; q0 < a.sq; q0 += kTile) {
    const int rows = min(kTile, a.sq - q0);
    const T* qt = qh + q0 * a.q_rs;
    const T* gt = gh + q0 * a.g_rs;
    // the previous tile read st_s before the syncs of its chunk loop
    for (int r = tid; r < kTile; r += cc::kThreads) {
      const int64_t at = (int64_t)bh * a.sq + q0 + r;
      st_s[r] = r < rows ? a.stats[at] : 0.f;
      st_s[kTile + r] = r < rows ? a.stats[n + at] : 1.f;
      st_s[2 * kTile + r] = r < rows ? a.stats[2 * n + at] : 0.f;
    }
    // S = q k^T and dP = g v^T, rows = queries; the syncs inside publish st_s
    cc::row_products<T, D, kTile>(s, a_s, b_s, qt, rows, a.q_rs, kb, keys, a.k_rs, ty, tx);
    cc::row_products<T, D, kTile>(dp, a_s, b_s, gt, rows, a.g_rs, vb, keys, a.v_rs, ty, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int row = ty + cc::kT * i;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int col = tx + cc::kT * j;
        float ds = 0.f, pd = 0.f;  // zero past Sq and Sk
        if (row < rows && col < keys) {
          bool kept;
          const float p =
              expf(score(s[i][j], a.scale, bias_b[col]) - st_s[row]) / st_s[kTile + row];
          const float d = dropped(dp[i][j], a, q0 + row, k0 + col, tseed, &kept);
          ds = p * (d - st_s[2 * kTile + row]);
          pd = a.drop ? (kept ? p * a.keep_scale : 0.f) : p;
        }
        ds_s[row * kPS + col] = ds;
        pd_s[row * kPS + col] = pd;
      }
    }
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += cc::kChunk) {
      __syncthreads();  // ds / P_drop written; the previous chunk is consumed
      cc::stage<T, kTile>(a_s, gt, rows, a.g_rs, c0);
      cc::stage<T, kTile>(b_s, qt, rows, a.q_rs, c0);
      __syncthreads();
#pragma unroll 8
      for (int r = 0; r < kTile; ++r) {
        const float g_lo = a_s[r * cc::kCS + tx], g_hi = a_s[r * cc::kCS + tx + cc::kT];
        const float q_lo = b_s[r * cc::kCS + tx], q_hi = b_s[r * cc::kCS + tx + cc::kT];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const float pd = pd_s[r * kPS + ty + cc::kT * i];
          const float ds = ds_s[r * kPS + ty + cc::kT * i];
          dv_acc[i][c0 / cc::kT] += pd * g_lo;
          dv_acc[i][c0 / cc::kT + 1] += pd * g_hi;
          dk_acc[i][c0 / cc::kT] += ds * q_lo;
          dk_acc[i][c0 / cc::kT + 1] += ds * q_hi;
        }
      }
    }
  }
  const int64_t hidden = (int64_t)a.num_heads * D;
  T* dk = static_cast<T*>(a.dk) + (b * a.sk + k0) * hidden + h * D;
  T* dv = static_cast<T*>(a.dv) + (b * a.sk + k0) * hidden + h * D;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int key = ty + cc::kT * i;
    if (key < keys)
#pragma unroll
      for (int c = 0; c < D / cc::kT; ++c) {
        dk[key * hidden + tx + cc::kT * c] = cc::from_float<T>(dk_acc[i][c] * a.scale);
        dv[key * hidden + tx + cc::kT * c] = cc::from_float<T>(dv_acc[i][c]);
      }
  }
}

constexpr size_t kRowsDqSmem = sizeof(float) * (2 * kTile * cc::kCS + kTile * kPS);
constexpr size_t kDkDvSmem = sizeof(float) * (2 * kTile * cc::kCS + 2 * kTile * kPS + 3 * kTile);

template <typename T, int D>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const long long bhs = (long long)batch * a.num_heads;
  if (bhs > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  // per call, so the caps hold on whichever device is current
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_rows_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kRowsDqSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDkDvSmem);
  if (err != cudaSuccess) return err;
  const dim3 q_grid((unsigned)bhs, (a.sq + kTile - 1) / kTile);
  const dim3 k_grid((unsigned)bhs, (a.sk + kTile - 1) / kTile);
  attention_bwd_rows_dq_kernel<T, D><<<q_grid, cc::kThreads, kRowsDqSmem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_kernel<T, D><<<k_grid, cc::kThreads, kDkDvSmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace lk

// ---- long-sequence variant on the tensor cores (bf16) ------------------------
//
// The same two kernels as lk::, with the products on mma.sync.m16n8k16
// (bf16 operands, fp32 accumulators) from the PR 3 helpers: 4 warps a
// block, tiles of 64 queries and 64 keys in bf16 shared memory (rows padded
// by 16 bytes, loaded by 16-byte cp.async, zero past the sequence).
// rows_dq: a warp owns 16 query rows; per key tile S = q k^T and dP = g v^T
// (products_abt) feed the online row max, sum and D in registers; the second
// walk forms ds and accumulates dq = ds k from ds packed straight into A
// fragments. dkdv: a warp owns 16 keys; per query tile it computes S^T =
// k q^T and dP^T = v g^T, so that P_drop^T and ds^T come out as C tiles whose
// rows are its keys and pack into the A fragments of dv = P_drop^T g and
// dk = ds^T q: no shared-memory staging of P or ds, no atomics. P_drop and
// ds are rounded to bf16 as mma operands, as in the tensor-core variant.
namespace lktc {

constexpr int kWarps = lk::kTile / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kKT = lk::kTile / 16;  // k16 tiles in a 64 tile

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(vt::bf16) * 4 * lk::kTile * (D + 8) + sizeof(float) * 4 * lk::kTile;
}

template <int D>
__global__ void __launch_bounds__(kThreads) attention_bwd_long_tc_rows_dq_kernel(const lk::Args a) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  vt::bf16* q_s = reinterpret_cast<vt::bf16*>(smem_raw);
  vt::bf16* g_s = q_s + lk::kTile * LD;
  vt::bf16* k_s = g_s + lk::kTile * LD;
  vt::bf16* v_s = k_s + lk::kTile * LD;
  float* bias_s = reinterpret_cast<float*>(v_s + lk::kTile * LD);

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * lk::kTile;
  const int h = bh % a.num_heads;
  const int64_t b = bh / a.num_heads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = min(lk::kTile, a.sq - q0);
  const int r0 = 16 * warp;
  const vt::bf16* kb = static_cast<const vt::bf16*>(a.k) + b * a.k_bs + h * D;
  const vt::bf16* vb = static_cast<const vt::bf16*>(a.v) + b * a.v_bs + h * D;
  const float* bias_b = a.bias + b * a.bias_bs;
  const uint32_t tseed = vt::tile_seed(a.seed, bh);
  vt::load_head_rows<D>(q_s, static_cast<const vt::bf16*>(a.q) + b * a.q_bs + q0 * a.q_rs + h * D,
                        rows, lk::kTile, a.q_rs, tid, kThreads);
  vt::load_head_rows<D>(g_s, static_cast<const vt::bf16*>(a.g) + b * a.g_bs + q0 * a.g_rs + h * D,
                        rows, lk::kTile, a.g_rs, tid, kThreads);

  // one key tile into k_s, v_s, bias_s; returns its valid keys
  auto load_keys = [&](int k0) {
    const int keys = min(lk::kTile, a.sk - k0);
    __syncthreads();  // the previous tile is consumed
    vt::load_head_rows<D>(k_s, kb + k0 * a.k_rs, keys, lk::kTile, a.k_rs, tid, kThreads);
    vt::load_head_rows<D>(v_s, vb + k0 * a.v_rs, keys, lk::kTile, a.v_rs, tid, kThreads);
    for (int j = tid; j < lk::kTile; j += kThreads) bias_s[j] = j < keys ? bias_b[k0 + j] : 0.f;
    vt::cp_async_commit();
    vt::cp_async_wait<0>();
    __syncthreads();
    return keys;
  };

  // element e of C tile n: row r0 + lane/4 + 8 (e/2), key 8 n + 2 (lane%4) + e%2
  const int qrow = q0 + r0 + lane / 4;
  float s[2 * kKT][4], dp[2 * kKT][4];
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  // 1. row max, sum and D, online over the key tiles
  for (int k0 = 0; k0 < a.sk; k0 += lk::kTile) {
    const int keys = load_keys(k0), kt = (keys + 15) / 16;
    vt::products_abt<D, kKT>(s, q_s, k_s, r0, kt, lane);
    vt::products_abt<D, kKT>(dp, g_s, v_s, r0, kt, lane);
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2 * kKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * (lane % 4) + e % 2;
        s[n][e] = col < keys ? lk::score(s[n][e], a.scale, bias_s[col]) : -INFINITY;
        tmax[e / 2] = fmaxf(tmax[e / 2], s[n][e]);
      }
    float ls[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f}, mn[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) mn[r] = fmaxf(mx[r], vt::quad_max(tmax[r]));
#pragma unroll
    for (int n = 0; n < 2 * kKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * (lane % 4) + e % 2;
        if (col < keys) {
          bool kept;
          const float ex = expf(s[n][e] - mn[e / 2]);
          ls[e / 2] += ex;
          dl[e / 2] += ex * lk::dropped(dp[n][e], a, qrow + 8 * (e / 2), k0 + col, tseed, &kept);
        }
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float c = expf(mx[r] - mn[r]);  // 0 at the first tile (mx = -inf)
      l[r] = l[r] * c + vt::quad_sum(ls[r]);
      dsum[r] = dsum[r] * c + vt::quad_sum(dl[r]);
      mx[r] = mn[r];
    }
  }
  float dd[2];
  const int64_t n_rows = (int64_t)gridDim.x * a.sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dd[r] = dsum[r] / l[r];
    const int row = r0 + lane / 4 + 8 * r;
    if (lane % 4 == 0 && row < rows) {
      const int64_t at = (int64_t)bh * a.sq + q0 + row;
      a.stats[at] = mx[r];
      a.stats[n_rows + at] = l[r];
      a.stats[2 * n_rows + at] = dd[r];
    }
  }

  // 2. dq = ds k scale over the key tiles, ds from the registers
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int k0 = 0; k0 < a.sk; k0 += lk::kTile) {
    const int keys = load_keys(k0), kt = (keys + 15) / 16;
    vt::products_abt<D, kKT>(s, q_s, k_s, r0, kt, lane);
    vt::products_abt<D, kKT>(dp, g_s, v_s, r0, kt, lane);
#pragma unroll
    for (int n = 0; n < 2 * kKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * (lane % 4) + e % 2;
        float ds = 0.f;  // zero past Sk
        if (col < keys) {
          bool kept;
          const float p = expf(lk::score(s[n][e], a.scale, bias_s[col]) - mx[e / 2]) / l[e / 2];
          ds = p * (lk::dropped(dp[n][e], a, qrow + 8 * (e / 2), k0 + col, tseed, &kept) -
                    dd[e / 2]);
        }
        dp[n][e] = ds;
      }
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      if (j < kt) {
        uint32_t da[4];
        vt::c_to_a(da, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          uint32_t fb[4];
          vt::load_b_kn(fb, k_s, LD, 16 * j, 16 * nd, lane);
          vt::mma_bf16(acc[2 * nd], da, fb[0], fb[1]);
          vt::mma_bf16(acc[2 * nd + 1], da, fb[2], fb[3]);
        }
      }
    }
  }
  const int64_t hidden = (int64_t)a.num_heads * D;
  vt::store_strip<D>(static_cast<vt::bf16*>(a.dq) + (b * a.sq + q0) * hidden + h * D, acc,
                     r0 + lane / 4, rows, hidden, a.scale, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads) attention_bwd_long_tc_dkdv_kernel(const lk::Args a) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  vt::bf16* k_s = reinterpret_cast<vt::bf16*>(smem_raw);
  vt::bf16* v_s = k_s + lk::kTile * LD;
  vt::bf16* q_s = v_s + lk::kTile * LD;
  vt::bf16* g_s = q_s + lk::kTile * LD;
  float* st_s = reinterpret_cast<float*>(g_s + lk::kTile * LD);  // [3][kTile]: m, l, D
  float* bias_s = st_s + 3 * lk::kTile;                            // [kTile]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * lk::kTile;
  const int h = bh % a.num_heads;
  const int64_t b = bh / a.num_heads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int keys = min(lk::kTile, a.sk - k0);
  const int m0 = 16 * warp;  // this warp's keys, tile-local
  const vt::bf16* qh = static_cast<const vt::bf16*>(a.q) + b * a.q_bs + h * D;
  const vt::bf16* gh = static_cast<const vt::bf16*>(a.g) + b * a.g_bs + h * D;
  const uint32_t tseed = vt::tile_seed(a.seed, bh);
  const int64_t n_rows = (int64_t)gridDim.x * a.sq;
  vt::load_head_rows<D>(k_s, static_cast<const vt::bf16*>(a.k) + b * a.k_bs + k0 * a.k_rs + h * D,
                        keys, lk::kTile, a.k_rs, tid, kThreads);
  vt::load_head_rows<D>(v_s, static_cast<const vt::bf16*>(a.v) + b * a.v_bs + k0 * a.v_rs + h * D,
                        keys, lk::kTile, a.v_rs, tid, kThreads);
  for (int j = tid; j < lk::kTile; j += kThreads)
    bias_s[j] = j < keys ? a.bias[b * a.bias_bs + k0 + j] : 0.f;

  // element e of C tile n: key m0 + lane/4 + 8 (e/2), query 8 n + 2 (lane%4) + e%2
  const int key = m0 + lane / 4;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  float st[2 * kKT][4], dpt[2 * kKT][4];
  for (int q0 = 0; q0 < a.sq; q0 += lk::kTile) {
    const int rows = min(lk::kTile, a.sq - q0), qt = (rows + 15) / 16;
    __syncthreads();  // the previous query tile is consumed
    vt::load_head_rows<D>(q_s, qh + q0 * a.q_rs, rows, lk::kTile, a.q_rs, tid, kThreads);
    vt::load_head_rows<D>(g_s, gh + q0 * a.g_rs, rows, lk::kTile, a.g_rs, tid, kThreads);
    for (int r = tid; r < lk::kTile; r += kThreads) {
      const int64_t at = (int64_t)bh * a.sq + q0 + r;
      st_s[r] = r < rows ? a.stats[at] : 0.f;
      st_s[lk::kTile + r] = r < rows ? a.stats[n_rows + at] : 1.f;
      st_s[2 * lk::kTile + r] = r < rows ? a.stats[2 * n_rows + at] : 0.f;
    }
    vt::cp_async_commit();
    vt::cp_async_wait<0>();
    __syncthreads();
    // S^T = k q^T and dP^T = v g^T: rows are this warp's keys
    vt::products_abt<D, kKT>(st, k_s, q_s, m0, qt, lane);
    vt::products_abt<D, kKT>(dpt, v_s, g_s, m0, qt, lane);
#pragma unroll
    for (int n = 0; n < 2 * kKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = key + 8 * (e / 2), qc = 8 * n + 2 * (lane % 4) + e % 2;
        float ds = 0.f, pd = 0.f;  // zero past Sq and Sk
        if (kr < keys && qc < rows) {
          bool kept;
          const float p =
              expf(lk::score(st[n][e], a.scale, bias_s[kr]) - st_s[qc]) / st_s[lk::kTile + qc];
          const float d = lk::dropped(dpt[n][e], a, q0 + qc, k0 + kr, tseed, &kept);
          ds = p * (d - st_s[2 * lk::kTile + qc]);
          pd = a.drop ? (kept ? p * a.keep_scale : 0.f) : p;
        }
        st[n][e] = pd;
        dpt[n][e] = ds;
      }
    // dv += P_drop^T g, dk += ds^T q over this tile's queries
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      if (j < qt) {
        uint32_t pa[4], da[4];
        vt::c_to_a(pa, st[2 * j], st[2 * j + 1]);
        vt::c_to_a(da, dpt[2 * j], dpt[2 * j + 1]);
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          uint32_t fg[4], fq[4];
          vt::load_b_kn(fg, g_s, LD, 16 * j, 16 * nd, lane);
          vt::load_b_kn(fq, q_s, LD, 16 * j, 16 * nd, lane);
          vt::mma_bf16(dv[2 * nd], pa, fg[0], fg[1]);
          vt::mma_bf16(dv[2 * nd + 1], pa, fg[2], fg[3]);
          vt::mma_bf16(dk[2 * nd], da, fq[0], fq[1]);
          vt::mma_bf16(dk[2 * nd + 1], da, fq[2], fq[3]);
        }
      }
    }
  }
  const int64_t hidden = (int64_t)a.num_heads * D;
  const int64_t out = (b * a.sk + k0) * hidden + h * D;
  vt::store_strip<D>(static_cast<vt::bf16*>(a.dv) + out, dv, key, keys, hidden, 1.f, lane);
  vt::store_strip<D>(static_cast<vt::bf16*>(a.dk) + out, dk, key, keys, hidden, a.scale, lane);
}

template <int D>
cudaError_t launch(const lk::Args& a, int batch, cudaStream_t stream) {
  const long long bhs = (long long)batch * a.num_heads;
  if (bhs > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_long_tc_rows_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_long_tc_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 q_grid((unsigned)bhs, (a.sq + lk::kTile - 1) / lk::kTile);
  const dim3 k_grid((unsigned)bhs, (a.sk + lk::kTile - 1) / lk::kTile);
  attention_bwd_long_tc_rows_dq_kernel<D><<<q_grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_long_tc_dkdv_kernel<D><<<k_grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace lktc

}  // namespace

// The CUDA-core variant. dtype: 0 = float32, 1 = bfloat16. q, k, v, g are read through their batch
// and row strides (in elements, unit stride along H); dq [B, Sq, H] and dk,
// dv [B, Sk, H] are written contiguous. seed, threshold and keep_scale as
// for vt_attention_fwd (threshold 0 and scale 1: rate 0). Returns a
// cudaError_t; cudaErrorInvalidValue for a dtype, head_dim or length the
// kernel does not take (the Python wrapper checks these first).
extern "C" int vt_attention_bwd(const void* q, const void* k, const void* v, const void* bias,
                                const void* g, void* dq, void* dk, void* dv, int dtype,
                                int batch, int num_heads, int head_dim, int sq, int sk,
                                long long q_bstride, long long q_rstride, long long k_bstride,
                                long long k_rstride, long long v_bstride, long long v_rstride,
                                long long g_bstride, long long g_rstride,
                                long long bias_bstride, float scale, unsigned int seed,
                                unsigned int threshold, float keep_scale, void* stream) {
  if (sq < 1 || sk < 1 || sq > cc::kMaxSeq || sk > cc::kMaxSeq || batch < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = threshold != 0u || keep_scale != 1.f;
  const bool small = sq <= 64 && sk <= 64;
#define VT_LAUNCH(T, D)                                                                        \
  return (int)(small ? cc::launch<T, D, 64>(q, k, v, bias, g, dq, dk, dv, batch, num_heads,    \
                                            sq, sk, q_bstride, q_rstride, k_bstride,           \
                                            k_rstride, v_bstride, v_rstride, g_bstride,        \
                                            g_rstride, bias_bstride, scale, drop, seed,        \
                                            threshold, keep_scale, s)                          \
                     : cc::launch<T, D, 128>(q, k, v, bias, g, dq, dk, dv, batch, num_heads,   \
                                             sq, sk, q_bstride, q_rstride, k_bstride,          \
                                             k_rstride, v_bstride, v_rstride, g_bstride,       \
                                             g_rstride, bias_bstride, scale, drop, seed,       \
                                             threshold, keep_scale, s))
  if (dtype == 0 && head_dim == 64) VT_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) VT_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) VT_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) VT_LAUNCH(__nv_bfloat16, 128);
#undef VT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The tensor-core variant: bf16 q, k, v, g and outputs, fp32 bias,
// 1 <= Sq, Sk <= 128, head_dim 64 or 128; q, k, v and g 16-byte aligned
// with batch and row strides that are multiples of 8 elements. Arguments
// otherwise as for vt_attention_bwd; cudaErrorInvalidValue for what it does
// not take (the Python wrapper checks these first).
extern "C" int vt_attention_bwd_tc(const void* q, const void* k, const void* v, const void* bias,
                                   const void* g, void* dq, void* dk, void* dv, int batch,
                                   int num_heads, int head_dim, int sq, int sk,
                                   long long q_bstride, long long q_rstride, long long k_bstride,
                                   long long k_rstride, long long v_bstride, long long v_rstride,
                                   long long g_bstride, long long g_rstride,
                                   long long bias_bstride, float scale, unsigned int seed,
                                   unsigned int threshold, float keep_scale, void* stream) {
  if (sq < 1 || sk < 1 || sq > tc::kMaxSeq || sk > tc::kMaxSeq || batch < 1)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g)) % 16 ||
      (q_bstride | q_rstride | k_bstride | k_rstride | v_bstride | v_rstride | g_bstride |
       g_rstride) % 8)
    return (int)cudaErrorInvalidValue;
  tc::Args a{static_cast<const vt::bf16*>(q), static_cast<const vt::bf16*>(k),
             static_cast<const vt::bf16*>(v), static_cast<const float*>(bias),
             static_cast<const vt::bf16*>(g), static_cast<vt::bf16*>(dq),
             static_cast<vt::bf16*>(dk), static_cast<vt::bf16*>(dv), num_heads, sq, sk,
             q_bstride, q_rstride, k_bstride, k_rstride, v_bstride, v_rstride, g_bstride,
             g_rstride, bias_bstride, scale, threshold != 0u || keep_scale != 1.f, seed,
             threshold, keep_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = sq <= 64 && sk <= 64;
  if (head_dim == 64)
    return (int)(small ? tc::launch<64, 4>(a, batch, s) : tc::launch<64, 8>(a, batch, s));
  if (head_dim == 128)
    return (int)(small ? tc::launch<128, 4>(a, batch, s) : tc::launch<128, 8>(a, batch, s));
  return (int)cudaErrorInvalidValue;
}

// The long-sequence variant: 1 <= Sq, Sk <= 1024, fp32 or bf16 (dtype as for
// vt_attention_bwd), head_dim 64 or 128. stats is an fp32 workspace of
// 3 * batch * num_heads * sq elements that the caller allocates; it holds
// each row's softmax max, sum and D between the two kernels. Other
// arguments as for vt_attention_bwd; cudaErrorInvalidValue for what it does
// not take (the Python wrapper checks these first).
extern "C" int vt_attention_bwd_long(const void* q, const void* k, const void* v,
                                     const void* bias, const void* g, void* dq, void* dk,
                                     void* dv, void* stats, int dtype, int batch, int num_heads,
                                     int head_dim, int sq, int sk, long long q_bstride,
                                     long long q_rstride, long long k_bstride,
                                     long long k_rstride, long long v_bstride,
                                     long long v_rstride, long long g_bstride,
                                     long long g_rstride, long long bias_bstride, float scale,
                                     unsigned int seed, unsigned int threshold, float keep_scale,
                                     void* stream) {
  if (sq < 1 || sk < 1 || sq > lk::kMaxSeq || sk > lk::kMaxSeq || batch < 1)
    return (int)cudaErrorInvalidValue;
  const lk::Args a{q, k, v, static_cast<const float*>(bias), g, dq, dk, dv,
                   static_cast<float*>(stats), num_heads, sq, sk, q_bstride, q_rstride,
                   k_bstride, k_rstride, v_bstride, v_rstride, g_bstride, g_rstride,
                   bias_bstride, scale, threshold != 0u || keep_scale != 1.f, seed, threshold,
                   keep_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return (int)lk::launch<float, 64>(a, batch, s);
  if (dtype == 0 && head_dim == 128) return (int)lk::launch<float, 128>(a, batch, s);
  if (dtype == 1 && head_dim == 64) return (int)lk::launch<__nv_bfloat16, 64>(a, batch, s);
  if (dtype == 1 && head_dim == 128) return (int)lk::launch<__nv_bfloat16, 128>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}

// The long-sequence variant on the tensor cores: bf16 q, k, v, g and
// outputs, fp32 bias and workspace, 1 <= Sq, Sk <= 1024, head_dim 64 or 128;
// q, k, v and g 16-byte aligned with batch and row strides that are
// multiples of 8 elements. Arguments as for vt_attention_bwd_long without
// the dtype; cudaErrorInvalidValue for what it does not take (the Python
// wrapper checks these first).
extern "C" int vt_attention_bwd_long_tc(const void* q, const void* k, const void* v,
                                        const void* bias, const void* g, void* dq, void* dk,
                                        void* dv, void* stats, int batch, int num_heads,
                                        int head_dim, int sq, int sk, long long q_bstride,
                                        long long q_rstride, long long k_bstride,
                                        long long k_rstride, long long v_bstride,
                                        long long v_rstride, long long g_bstride,
                                        long long g_rstride, long long bias_bstride, float scale,
                                        unsigned int seed, unsigned int threshold,
                                        float keep_scale, void* stream) {
  if (sq < 1 || sk < 1 || sq > lk::kMaxSeq || sk > lk::kMaxSeq || batch < 1)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g)) % 16 ||
      (q_bstride | q_rstride | k_bstride | k_rstride | v_bstride | v_rstride | g_bstride |
       g_rstride) % 8)
    return (int)cudaErrorInvalidValue;
  const lk::Args a{q, k, v, static_cast<const float*>(bias), g, dq, dk, dv,
                   static_cast<float*>(stats), num_heads, sq, sk, q_bstride, q_rstride,
                   k_bstride, k_rstride, v_bstride, v_rstride, g_bstride, g_rstride,
                   bias_bstride, scale, threshold != 0u || keep_scale != 1.f, seed, threshold,
                   keep_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return (int)lktc::launch<64>(a, batch, s);
  if (head_dim == 128) return (int)lktc::launch<128>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}
