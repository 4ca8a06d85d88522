// Multi-head attention forward for Hopper (sm_90a): softmax(q k^T / sqrt(d) +
// key bias) [dropout] v over [B, S, H] projections.
//
// Replaces the TPU kernel vilbert_tpu/ops/pallas_attention_train.py::_fwd_kernel
// (K1), with its in-kernel attention-probability dropout, and serves
// vilbert_tpu/ops/pallas_attention.py::_attn_kernel (K3, K1 at rate 0). Same
// arithmetic: scores and softmax in fp32; with dropout, P times the fp32
// 1/(1 - rate) where _keep_mask keeps (keep_mask.cuh, hashed from the GLOBAL
// query row, the key column and the tile seed seed + (b heads + h) 7919)
// and 0 elsewhere; the normalized, dropped P rounded to v's dtype before the
// PV product (_fwd_kernel:75-76), PV accumulated in fp32, output in q's
// dtype. Rate 0 compiles the mask out (kDrop = false).
//
// What bounds it on the H100: by the bound, memory. A (batch, head) reads
// 3 S d elements and writes S d, and does 4 S^2 d flops: about Sk flop per
// byte in bf16, against the card's ridge of ~295 at 989 TFLOP/s and 3.35
// TB/s. At VQA image self-attention (B 1024, h 8, d 128, 101 x 101) the
// bytes take 0.253 ms. But these variants wait on their loads and their
// warps' mma.sync chains, and read 13-73% of the bound: the wgmma variant
// (attention_fwd_wg.cu), which streams the keys from the first tile on,
// takes 0.349 ms there against tc::'s 0.673 (H100 80GB HBM3, 700 W,
// chip_smoke.py), so the wrapper routes bf16 by shape among tc::,
// ltc:: and it (ops/attention.py::fwd_variant). The variants read q, k and
// v straight from the [B, S, H] projections through strides (no head
// transposes in device memory; a stride-0 batch, retrieval's fast_mode,
// passes), keep the [Sq, Sk] scores on chip and write the output once in
// [B, Sq, H].
//
// Each variant can also write the attention probabilities (the
// `visualization` maps), P after dropout in the output dtype, into a
// [B, h, Sq, Sk] array when the caller passes one (null: none, and nothing
// else changes): tc:: and cc:: from the row they hold, ltc:: in a second
// sweep over the key tiles once the row's max and sum are final. The bf16
// variants (tc::, ltc::) can likewise write each query row's log-sum-exp of
// the scaled, biased scores, m + log l in fp32, into a [B, h, Sq] array: the
// row statistics of the wgmma backward (attention_bwd_wg.cu), which then
// recomputes P without a walk over the row first.
//
// Three variants here; the Python wrapper picks one of them or the wgmma
// variant by dtype and shape and counts each:
//
// * tensor cores (tc::, bf16, Sk <= 128: every shape of the VQA and CC
//   paths). A block is one (batch, head) and up to 128 query rows, one
//   warp per 16 rows, so that K and V are loaded once per head: 1.65x
//   faster than 64-row blocks at VQA image self-attention (101 x 101), and
//   within 3% of them at the other shapes (scripts/ab_kernels.py on an H100
//   80GB HBM3 at 700 W). q, k and v rows arrive by 16-byte cp.async in
//   bf16 (rows padded by 16 bytes, zero past S), V in a second group that
//   lands while S and the softmax run.
//   S = Q K^T on mma.sync.m16n8k16 (bf16 -> fp32) with ldmatrix operands;
//   the softmax runs on the accumulators in registers (quad shuffles), keys
//   past Sk set to -inf; the mask is hashed at each accumulator element's
//   own (row, col); the normalized, dropped P is packed to bf16 in
//   registers as the A operand of P V on the same mma.
// * tensor cores past 128 keys (ltc::, bf16, 128 < Sk <= 1024: Visual7w's
//   200 regions, GuessWhatPointing's 257 tokens and 306 regions, and the
//   single-stream baseline's 256 + 306 = 562 tokens and regions). The
//   whole key axis no longer fits beside the query tile, so K and V stream
//   through shared memory in tiles of 64 keys, two stages deep: tile t + 1
//   lands by cp.async while tile t's S, softmax and P V run, one barrier a
//   tile (about 105 KB a block at d = 128, so two blocks share an SM): the
//   shared memory does not grow with Sk, and the cap is a constant. A
//   block is one (batch, head) and as few strips of 16 query rows, at most
//   8, as cover Sq in evenly filled blocks. Per step of a key tile (the
//   whole 64 keys at
//   d = 64; 32 at d = 128, where 64 O accumulators a thread leave no room
//   for 64 keys of S within the 128 registers that two blocks an SM allow)
//   a warp computes S = Q K^T with products_abt, scales it and adds the
//   bias in one fused multiply-add (-inf past Sk, not -10000), keeps an
//   online softmax in registers (running row max m by quad shuffles; each
//   lane's share of the row sum l of the UNDROPPED exps, as the TPU kernel
//   normalizes before it drops; exponentials by ex2.approx), rescales O by
//   exp(m_old - m_new), hashes the mask at each accumulator element's global
//   (row, key), packs the kept exp(s - m) to bf16 in registers (c_to_a) and
//   accumulates P V (accumulate_ab). O keep_scale / l is written once.
//   Its one departure from the TPU kernel: that kernel rounds the
//   normalized, dropped P to bf16 (_fwd_kernel:76); this variant rounds
//   exp(s - m) against the running max and divides by l after P V. The
//   relative rounding is the same size (one bf16 rounding of each P), and
//   K2 recomputes P itself, so only the output has to stay within the bf16
//   bound; exact normalization before P V would take a second walk over
//   the keys and a third product. It takes Sk <= 128 too, and the wrapper
//   sends it the shapes at or under 128 keys where it beat tc:: and the
//   wgmma variant (d = 64 past 32 keys, image->text at d = 128: up to
//   0.54x tc::'s time at 73 keys).
// * CUDA cores (cc::, fp32 at any Sk <= 1024): one block per (batch, head,
//   32 query rows), fp32 FMAs from fp32 tiles in shared memory, 4 x 4
//   register tiles; keys walked in tiles of 64 rows. What grows with Sk is
//   the fp32 score block [32][Sk + 1] beside the q tile and one key tile:
//   at Sk = 1024 and d = 128, 32.8 + 16.5 + 33.0 K floats = 181 KB of the
//   227 KB a block may take (hence cudaFuncSetAttribute), which is what
//   caps it; one block an SM there. It takes bf16 too and
//   served it before the tensor-core variants; its bf16 times on an H100
//   80GB HBM3 at 700 W: 5.210 ms at VQA image self-attention (B 1024,
//   101 x 101, h 8, d 128, rate 0), 0.327 ms at CC image self-attention
//   (B 256, 37 x 37, rate 0.1), 0.201 ms at CC text self-attention (B 256,
//   36 x 36, h 12, d 64), 5.299 ms at Visual7w image self-attention (B 256,
//   200 x 200, rate 0). chip_smoke.py times it beside the tensor-core
//   variants.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "keep_mask.cuh"
#include "mma_bf16.cuh"

namespace {

// ---- CUDA-core variant (fp32; bf16 when named) ------------------------------
namespace cc {

constexpr int kThreads = 128;
constexpr int kBlockQ = 32;   // query rows per block
constexpr int kBlockK = 64;   // key/value rows per shared-memory tile
constexpr int kMaxKeys = 1024;  // the [32][Sk + 1] fp32 scores fill shared memory
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
                     const float* __restrict__ bias, T* __restrict__ out,
                     T* __restrict__ probs, int num_heads, int sq, int sk, int q_tiles,
                     int64_t q_bstride, int64_t q_rstride,
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
  // the dropout mask of the row's global query index; with `probs`, the
  // row's P as the PV product takes it into [B, h, Sq, Sk]
  const int warp = tid / 32, lane = tid % 32;
  const uint32_t tseed = vt::tile_seed(seed, bh);
  for (int r = warp; r < kBlockQ; r += kThreads / 32) {
    float* row = p_s + r * p_stride;
    T* prow =
        probs != nullptr && q0 + r < sq ? probs + ((int64_t)bh * sq + q0 + r) * sk : nullptr;
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
      if (prow != nullptr) prow[j] = from_float<T>(p);
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
                   void* probs, int batch, int num_heads, int sq, int sk, long long q_bs,
                   long long q_rs,
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
      static_cast<const float*>(bias), static_cast<T*>(out), static_cast<T*>(probs), num_heads,
      sq, sk, q_tiles, q_bs,
      q_rs, k_bs, k_rs, v_bs, v_rs, bias_bs, scale, seed, threshold, keep_scale);
  return cudaGetLastError();
}

}  // namespace cc

// ---- tensor-core variant (bf16, Sk <= 128) ---------------------------------
namespace tc {

constexpr int kMaxWarps = 8;
constexpr int kBlockQ = 16 * kMaxWarps;  // most query rows per block, 16 per warp
constexpr int kMaxKeys = 128;

struct Args {
  const vt::bf16* q;
  const vt::bf16* k;
  const vt::bf16* v;
  const float* bias;
  vt::bf16* out;
  vt::bf16* probs;  // [B, h, Sq, Sk], or null: no probabilities
  float* lse;       // [B, h, Sq], or null: no row log-sum-exps
  int num_heads, sq, sk;
  int q_rows, q_tiles;  // query rows per block (a multiple of 16), blocks per head
  int64_t q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, bias_bs;  // strides in elements
  float scale;
  uint32_t seed, threshold;
  float keep_scale;
};

// q tile [q_rows][D + 8], k and v [skp][D + 8] (bf16), bias [skp] (fp32)
size_t smem_bytes(int d, int q_rows, int sk) {
  const int skp = (sk + 15) / 16 * 16;
  return sizeof(vt::bf16) * (size_t)(q_rows + 2 * skp) * (d + 8) + sizeof(float) * skp;
}

// KT: key tiles of 16 the accumulators are sized for (the launch picks the
// smallest of 2, 4, 8 that covers Sk); loops run over the Sk's own count
template <int D, int KT, bool kDrop>
__global__ void __launch_bounds__(32 * kMaxWarps) attention_fwd_tc_kernel(const Args a) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kt = (a.sk + 15) / 16;
  const int skp = 16 * kt;
  vt::bf16* q_s = reinterpret_cast<vt::bf16*>(smem_raw);
  vt::bf16* k_s = q_s + a.q_rows * LD;
  vt::bf16* v_s = k_s + skp * LD;
  float* bias_s = reinterpret_cast<float*>(v_s + skp * LD);

  const int tile = blockIdx.x % a.q_tiles;
  const int bh = blockIdx.x / a.q_tiles;
  const int h = bh % a.num_heads;
  const int64_t b = bh / a.num_heads;
  const int q0 = tile * a.q_rows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, nthreads = blockDim.x;

  // two groups of copies: q and k, then v, which lands while S and the
  // softmax run
  vt::load_head_rows<D>(q_s, a.q + b * a.q_bs + q0 * a.q_rs + h * D, min(a.q_rows, a.sq - q0),
                        a.q_rows, a.q_rs, tid, nthreads);
  vt::load_head_rows<D>(k_s, a.k + b * a.k_bs + h * D, a.sk, skp, a.k_rs, tid, nthreads);
  vt::cp_async_commit();
  vt::load_head_rows<D>(v_s, a.v + b * a.v_bs + h * D, a.sk, skp, a.v_rs, tid, nthreads);
  vt::cp_async_commit();
  for (int j = tid; j < skp; j += nthreads) bias_s[j] = j < a.sk ? a.bias[b * a.bias_bs + j] : 0.f;
  vt::cp_async_wait<1>();
  __syncthreads();

  const int r0 = 16 * warp;  // the warp's strip of the tile
  const bool active = q0 + r0 < a.sq;
  const int row = q0 + r0 + lane / 4;  // global query row of elements 0, 1
  // the normalized, dropped P in bf16: the A fragments of P V
  uint32_t pa[KT][4];
  if (active) {
    // S = Q K^T: s[n] is the C tile of keys [8 n, 8 n + 8)
    float s[2 * KT][4];
    vt::products_abt<D, KT>(s, q_s, k_s, r0, kt, lane);
    // P in registers, then the mask at each element's global (row, key)
    float lse[2];
    vt::softmax_strip<KT>(s, kt, a.sk, a.scale, bias_s, lane, lse);
    if (a.lse != nullptr && lane % 4 == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row + 8 * r < a.sq) a.lse[(int64_t)bh * a.sq + row + 8 * r] = lse[r];
    if (kDrop) {
      const uint32_t tseed = vt::tile_seed(a.seed, bh);
#pragma unroll
      for (int n = 0; n < 2 * KT; ++n)
        if (n < 2 * kt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = vt::keep(row + 8 * (e / 2), 8 * n + 2 * (lane % 4) + e % 2, tseed,
                               a.threshold)
                          ? s[n][e] * a.keep_scale
                          : 0.f;
    }
    // the normalized, dropped P as P V takes it (bf16), into [B, h, Sq, Sk]
    if (a.probs != nullptr)
      vt::store_probs<2 * KT>(a.probs + (int64_t)bh * a.sq * a.sk, s, 2 * kt, row, 0, a.sq,
                              a.sk, lane);
#pragma unroll
    for (int j = 0; j < KT; ++j)
      if (j < kt) vt::c_to_a(pa[j], s[2 * j], s[2 * j + 1]);
  }
  vt::cp_async_wait<0>();
  __syncthreads();  // v is in
  if (!active) return;

  // O = P V, written once in [B, Sq, H]
  float o[D / 8][4];
  vt::products_ab<D, KT>(o, pa, v_s, kt, lane);
  const int64_t hidden = (int64_t)a.num_heads * D;
  vt::store_strip<D>(a.out + b * a.sq * hidden + h * D, o, row, a.sq, hidden, 1.f, lane);
}

template <int D, int KT, bool kDrop>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const long long blocks = (long long)batch * a.num_heads * a.q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_tc_kernel<D, KT, kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(D, kBlockQ, 16 * KT));
  if (err != cudaSuccess) return err;
  attention_fwd_tc_kernel<D, KT, kDrop>
      <<<(unsigned)blocks, 2 * a.q_rows, smem_bytes(D, a.q_rows, a.sk), stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool kDrop>
cudaError_t launch_keys(const Args& a, int batch, cudaStream_t stream) {
  if (a.sk <= 32) return launch<D, 2, kDrop>(a, batch, stream);
  if (a.sk <= 64) return launch<D, 4, kDrop>(a, batch, stream);
  return launch<D, 8, kDrop>(a, batch, stream);
}

}  // namespace tc

// ---- tensor-core variant past 128 keys (bf16, Sk <= 1024) ------------------
namespace ltc {

constexpr int kMaxQWarps = 8;              // most warps a block, 16 query rows each
constexpr int kBlockQ = 16 * kMaxQWarps;   // most query rows a block
constexpr int kBlockK = 64;                // keys a streamed tile
constexpr int kStages = 2;                 // key tiles in shared memory: in use, landing
constexpr int kMaxKeys = 1024;
constexpr float kLog2e = 1.4426950408889634f;

// q tile [q_rows][D + 8], then kStages of k [kBlockK][D + 8], of v (bf16)
// and of the bias [kBlockK] (fp32)
size_t smem_bytes(int d, int q_rows) {
  return sizeof(vt::bf16) * ((size_t)q_rows + 2 * kStages * kBlockK) * (d + 8) +
         sizeof(float) * kStages * kBlockK;
}

// 2^x on the special-function unit (-inf -> 0); about 2 ulp, far inside the
// bf16 rounding of P
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(32 * kMaxQWarps) attention_fwd_long_tc_kernel(const tc::Args a) {
  constexpr int LD = D + 8;
  // keys a softmax step takes of a tile: at d = 128 the O accumulators hold
  // 64 registers a thread, so S is computed 32 keys at a time, which keeps
  // the kernel within 128 registers and two blocks on an SM; at d = 64 the
  // whole tile at once
  constexpr int kStep = D == 128 ? 32 : 64;
  constexpr int kST = kStep / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  vt::bf16* q_s = reinterpret_cast<vt::bf16*>(smem_raw);
  vt::bf16* k_s = q_s + a.q_rows * LD;
  vt::bf16* v_s = k_s + kStages * kBlockK * LD;
  float* bias_s = reinterpret_cast<float*>(v_s + kStages * kBlockK * LD);

  const int tile = blockIdx.x % a.q_tiles;
  const int bh = blockIdx.x / a.q_tiles;
  const int h = bh % a.num_heads;
  const int64_t b = bh / a.num_heads;
  const int q0 = tile * a.q_rows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, nthreads = blockDim.x;
  const vt::bf16* kb = a.k + b * a.k_bs + h * D;
  const vt::bf16* vb = a.v + b * a.v_bs + h * D;
  const float* bias_b = a.bias + b * a.bias_bs;
  const int n_tiles = (a.sk + kBlockK - 1) / kBlockK;

  // key tile t into stage t % kStages by cp.async: k and v rows (zero past
  // Sk, to the tile's last k16 tile) and the bias (-inf past Sk)
  auto load_tile = [&](int t) {
    const int k0 = t * kBlockK, keys = min(kBlockK, a.sk - k0), st = t % kStages;
    const int rows = (keys + 15) / 16 * 16;
    vt::load_head_rows<D>(k_s + st * kBlockK * LD, kb + k0 * a.k_rs, keys, rows, a.k_rs, tid,
                          nthreads);
    vt::load_head_rows<D>(v_s + st * kBlockK * LD, vb + k0 * a.v_rs, keys, rows, a.v_rs, tid,
                          nthreads);
    for (int j = tid; j < rows; j += nthreads) {
      float* dst = bias_s + st * kBlockK + j;
      if (j < keys)
        vt::cp_async4(dst, bias_b + k0 + j);
      else
        *dst = -INFINITY;
    }
  };

  vt::load_head_rows<D>(q_s, a.q + b * a.q_bs + q0 * a.q_rs + h * D, min(a.q_rows, a.sq - q0),
                        a.q_rows, a.q_rs, tid, nthreads);
  load_tile(0);
  vt::cp_async_commit();

  const int r0 = 16 * warp;  // the warp's strip of the tile
  const bool active = q0 + r0 < a.sq;
  const int row = q0 + r0 + lane / 4;  // global query row of elements 0, 1
  const uint32_t tseed = vt::tile_seed(a.seed, bh);
  // O, the running row max m and this lane's share of the row sum l of the
  // undropped exps, for rows lane / 4 and lane / 4 + 8 of the strip
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    vt::cp_async_wait<0>();  // q and tile t are in
    __syncthreads();  // ... for every thread; and stage (t + 1) % 2 was consumed at t - 1
    if (t + 1 < n_tiles) {  // lands while tile t runs
      load_tile(t + 1);
      vt::cp_async_commit();
    }
    if (!active) continue;
    const int k0 = t * kBlockK, kt = (min(kBlockK, a.sk - k0) + 15) / 16;
#pragma unroll
    for (int j0 = 0; j0 < kBlockK; j0 += kStep) {
      const int st = kt - j0 / 16;  // k16 tiles of this step that hold keys
      if (st <= 0) break;
      const vt::bf16* k_t = k_s + ((t % kStages) * kBlockK + j0) * LD;
      const vt::bf16* v_t = v_s + ((t % kStages) * kBlockK + j0) * LD;
      const float* bias_t = bias_s + (t % kStages) * kBlockK + j0;

      // S = Q K^T of the step: s[n] is the C tile of keys k0 + j0 + [8 n, 8 n + 8)
      float s[2 * kST][4];
      vt::products_abt<D, kST>(s, q_s, k_t, r0, st, lane);
      float mn[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 2 * kST; ++n)
        if (n < 2 * st)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] = fmaf(s[n][e], a.scale, bias_t[8 * n + 2 * (lane % 4) + e % 2]);
            mn[e / 2] = fmaxf(mn[e / 2], s[n][e]);
          }
      float c[2], ml[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mn[r] = vt::quad_max(mn[r]);
        ml[r] = mn[r] * kLog2e;
        c[r] = exp2_approx(fmaf(m[r], kLog2e, -ml[r]));  // 0 at the first step (m = -inf)
        m[r] = mn[r];
        l[r] *= c[r];
      }
      // P = exp(s - m) into l undropped, then the mask at each element's
      // global (row, key), packed to bf16 as the A fragments of P V
#pragma unroll
      for (int n = 0; n < 2 * kST; ++n)
        if (n < 2 * st)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2_approx(fmaf(s[n][e], kLog2e, -ml[e / 2]));
            l[e / 2] += p;
            s[n][e] = !kDrop || vt::keep(row + 8 * (e / 2),
                                         k0 + j0 + 8 * n + 2 * (lane % 4) + e % 2, tseed,
                                         a.threshold)
                          ? p
                          : 0.f;
          }
      uint32_t pa[kST][4];
#pragma unroll
      for (int j = 0; j < kST; ++j)
        if (j < st) vt::c_to_a(pa[j], s[2 * j], s[2 * j + 1]);
      vt::scale_rows<D / 8>(o, c[0], c[1]);
      vt::accumulate_ab<D, kST>(o, pa, v_t, st, lane);
    }
  }
  // O keep_scale / l, written once in [B, Sq, H]; with `lse`, m + log l
  const float ls[2] = {vt::quad_sum(l[0]), vt::quad_sum(l[1])};
  const float f[2] = {a.keep_scale / ls[0], a.keep_scale / ls[1]};
  if (active) {
    vt::scale_rows<D / 8>(o, f[0], f[1]);
    const int64_t hidden = (int64_t)a.num_heads * D;
    vt::store_strip<D>(a.out + b * a.sq * hidden + h * D, o, row, a.sq, hidden, 1.f, lane);
    if (a.lse != nullptr && lane % 4 == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row + 8 * r < a.sq) a.lse[(int64_t)bh * a.sq + row + 8 * r] = m[r] + logf(ls[r]);
  }
  if (a.probs == nullptr) return;

  // With `probs`: a second sweep over the key tiles, now that the row's max
  // m and sum l are final. S is recomputed as above, P = exp(s - m)
  // keep_scale / l where the mask keeps and 0 elsewhere, rounded to bf16
  // into [B, h, Sq, Sk]. (The sweep above rounded the unnormalized exp to
  // bf16 for P V; these are the normalized probabilities, as the TPU kernel
  // rounds them.)
  vt::bf16* probs = a.probs + (int64_t)bh * a.sq * a.sk;
  const float ml[2] = {m[0] * kLog2e, m[1] * kLog2e};
  __syncthreads();  // every warp is done with the last tile's stage
  load_tile(0);
  vt::cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    vt::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_tiles) {
      load_tile(t + 1);
      vt::cp_async_commit();
    }
    if (!active) continue;
    const int k0 = t * kBlockK, kt = (min(kBlockK, a.sk - k0) + 15) / 16;
#pragma unroll
    for (int j0 = 0; j0 < kBlockK; j0 += kStep) {
      const int st = kt - j0 / 16;
      if (st <= 0) break;
      const vt::bf16* k_t = k_s + ((t % kStages) * kBlockK + j0) * LD;
      const float* bias_t = bias_s + (t % kStages) * kBlockK + j0;
      float s[2 * kST][4];
      vt::products_abt<D, kST>(s, q_s, k_t, r0, st, lane);
#pragma unroll
      for (int n = 0; n < 2 * kST; ++n)
        if (n < 2 * st)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + j0 + 8 * n + 2 * (lane % 4) + e % 2;
            const float x = fmaf(s[n][e], a.scale, bias_t[8 * n + 2 * (lane % 4) + e % 2]);
            const float p = exp2_approx(fmaf(x, kLog2e, -ml[e / 2])) * f[e / 2];
            s[n][e] = !kDrop || vt::keep(row + 8 * (e / 2), key, tseed, a.threshold) ? p : 0.f;
          }
      vt::store_probs<2 * kST>(probs, s, 2 * st, row, k0 + j0, a.sq, a.sk, lane);
    }
  }
}

template <int D, bool kDrop>
cudaError_t launch(const tc::Args& a, int batch, cudaStream_t stream) {
  const long long blocks = (long long)batch * a.num_heads * a.q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_long_tc_kernel<D, kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(D, kBlockQ));
  if (err != cudaSuccess) return err;
  attention_fwd_long_tc_kernel<D, kDrop>
      <<<(unsigned)blocks, 2 * a.q_rows, smem_bytes(D, a.q_rows), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace ltc

}  // namespace

// The CUDA-core variant. dtype: 0 = float32, 1 = bfloat16. Strides are in
// elements. Dropout: the call's uint32 seed, the uint32 keep threshold and
// the fp32 keep scale 1/(1 - rate), all computed by the caller; threshold 0
// and scale 1 mean rate 0. probs: null, or a contiguous [B, h, Sq, Sk] of the
// dtype that receives P after dropout (as the PV product takes it).
// Returns a cudaError_t; cudaErrorInvalidValue for a dtype, head_dim or key
// count the kernel does not take (the Python wrapper checks these first).
extern "C" int vt_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                                void* out, int dtype, int batch, int num_heads, int head_dim,
                                int sq, int sk, long long q_bstride, long long q_rstride,
                                long long k_bstride, long long k_rstride, long long v_bstride,
                                long long v_rstride, long long bias_bstride, float scale,
                                unsigned int seed, unsigned int threshold, float keep_scale,
                                void* probs, void* stream) {
  if (sk < 1 || sk > cc::kMaxKeys || sq < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = threshold != 0u || keep_scale != 1.f;
#define VT_LAUNCH(T, D)                                                                        \
  return (int)(drop ? cc::launch<T, D, true>(q, k, v, bias, out, probs, batch, num_heads, sq,  \
                                             sk, q_bstride, q_rstride, k_bstride, k_rstride,   \
                                             v_bstride, v_rstride, bias_bstride, scale, seed,  \
                                             threshold, keep_scale, s)                         \
                    : cc::launch<T, D, false>(q, k, v, bias, out, probs, batch, num_heads, sq, \
                                              sk, q_bstride, q_rstride, k_bstride, k_rstride,  \
                                              v_bstride, v_rstride, bias_bstride, scale, seed, \
                                              threshold, keep_scale, s))
  if (dtype == 0 && head_dim == 64) VT_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) VT_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) VT_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) VT_LAUNCH(__nv_bfloat16, 128);
#undef VT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The tensor-core variant: bf16 q, k, v and out, fp32 bias, 1 <= Sk <= 128,
// head_dim 64 or 128; q, k and v 16-byte aligned with batch and row strides
// that are multiples of 8 elements (16 bytes); lse null or an fp32
// [B, h, Sq] that receives each row's log-sum-exp; probs null or bf16.
// Arguments otherwise as for vt_attention_fwd; cudaErrorInvalidValue for what it does not take (the
// Python wrapper checks these first).
extern "C" int vt_attention_fwd_tc(const void* q, const void* k, const void* v, const void* bias,
                                   void* out, int batch, int num_heads, int head_dim, int sq,
                                   int sk, long long q_bstride, long long q_rstride,
                                   long long k_bstride, long long k_rstride, long long v_bstride,
                                   long long v_rstride, long long bias_bstride, float scale,
                                   unsigned int seed, unsigned int threshold, float keep_scale,
                                   void* lse, void* probs, void* stream) {
  if (sk < 1 || sk > tc::kMaxKeys || sq < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 ||
      (q_bstride | q_rstride | k_bstride | k_rstride | v_bstride | v_rstride) % 8)
    return (int)cudaErrorInvalidValue;
  // up to 128 query rows a block, so that K and V are loaded once per head
  // at Sq <= 128; fewer where Sq is shorter
  const int q_rows = min(tc::kBlockQ, (sq + 15) / 16 * 16);
  tc::Args a{static_cast<const vt::bf16*>(q), static_cast<const vt::bf16*>(k),
             static_cast<const vt::bf16*>(v), static_cast<const float*>(bias),
             static_cast<vt::bf16*>(out), static_cast<vt::bf16*>(probs),
             static_cast<float*>(lse), num_heads, sq, sk,
             q_rows, (sq + q_rows - 1) / q_rows,
             q_bstride, q_rstride, k_bstride, k_rstride,
             v_bstride, v_rstride, bias_bstride, scale, seed, threshold, keep_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = threshold != 0u || keep_scale != 1.f;
  if (head_dim == 64)
    return (int)(drop ? tc::launch_keys<64, true>(a, batch, s)
                      : tc::launch_keys<64, false>(a, batch, s));
  if (head_dim == 128)
    return (int)(drop ? tc::launch_keys<128, true>(a, batch, s)
                      : tc::launch_keys<128, false>(a, batch, s));
  return (int)cudaErrorInvalidValue;
}

// The tensor-core variant past 128 keys: bf16 q, k, v and out, fp32 bias,
// 1 <= Sk <= 1024 (Sk <= 128 too, for comparing it with vt_attention_fwd_tc),
// head_dim 64 or 128; the alignment and stride rules and the arguments of
// vt_attention_fwd_tc; cudaErrorInvalidValue for what it does not take (the
// Python wrapper checks these first).
extern "C" int vt_attention_fwd_long_tc(const void* q, const void* k, const void* v,
                                        const void* bias, void* out, int batch, int num_heads,
                                        int head_dim, int sq, int sk, long long q_bstride,
                                        long long q_rstride, long long k_bstride,
                                        long long k_rstride, long long v_bstride,
                                        long long v_rstride, long long bias_bstride, float scale,
                                        unsigned int seed, unsigned int threshold,
                                        float keep_scale, void* lse, void* probs,
                                        void* stream) {
  if (sk < 1 || sk > ltc::kMaxKeys || sq < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 ||
      (q_bstride | q_rstride | k_bstride | k_rstride | v_bstride | v_rstride) % 8)
    return (int)cudaErrorInvalidValue;
  // as few blocks of up to 128 query rows as cover Sq, their rows evened out
  // (200 queries: two blocks of 112, not 128 and 72)
  const int q_tiles = (sq + ltc::kBlockQ - 1) / ltc::kBlockQ;
  const int q_rows = ((sq + q_tiles - 1) / q_tiles + 15) / 16 * 16;
  tc::Args a{static_cast<const vt::bf16*>(q), static_cast<const vt::bf16*>(k),
             static_cast<const vt::bf16*>(v), static_cast<const float*>(bias),
             static_cast<vt::bf16*>(out), static_cast<vt::bf16*>(probs),
             static_cast<float*>(lse), num_heads, sq, sk,
             q_rows, q_tiles,
             q_bstride, q_rstride, k_bstride, k_rstride,
             v_bstride, v_rstride, bias_bstride, scale, seed, threshold, keep_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = threshold != 0u || keep_scale != 1.f;
  if (head_dim == 64)
    return (int)(drop ? ltc::launch<64, true>(a, batch, s) : ltc::launch<64, false>(a, batch, s));
  if (head_dim == 128)
    return (int)(drop ? ltc::launch<128, true>(a, batch, s)
                      : ltc::launch<128, false>(a, batch, s));
  return (int)cudaErrorInvalidValue;
}
