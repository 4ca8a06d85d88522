// Multi-head attention forward for Hopper on wgmma (sm_90a), bf16: the "wg"
// variant of K1, beside the three of attention.cu.
//
// Replaces the TPU kernel vilbert_tpu/ops/pallas_attention_train.py::_fwd_kernel
// (K1), with its in-kernel attention-probability dropout, and serves
// vilbert_tpu/ops/pallas_attention.py::_attn_kernel (K3, K1 at rate 0), for
// bf16 q, k, v at 1 <= Sq, 1 <= Sk <= 1024, d 64 or 128. The function is
// tc::'s and ltc::'s: softmax(q k^T / sqrt(d) + key bias) in fp32; with
// dropout, P times the fp32 1/(1 - rate) where _keep_mask keeps
// (keep_mask.cuh, hashed at each element's GLOBAL (query row, key) with the
// tile seed of (batch, head)) and 0 elsewhere; P V accumulated in fp32 and
// written once in [B, Sq, H]; optionally each row's log-sum-exp m + log l of
// the scaled, biased scores (fp32 [B, h, Sq]), which the wgmma backward
// (attention_bwd_wg.cu) reads; optionally the probabilities (the
// `visualization` maps), P after dropout in bf16 [B, h, Sq, Sk]: in the
// exact branch P as P V takes it, in the online branch from a second sweep
// over the key tiles with the row's final max and sum, as ltc:: writes
// them. Asking for them changes nothing else.
//
// What bounds it on the H100: at the paths' shapes neither rate. A (batch,
// head) reads 3 S d bf16 elements, writes S d and does 4 Sq Sk d flops:
// about Sk flop a byte, under the card's ridge of ~295 at 989 TFLOP/s and
// 3.35 TB/s, so the bound is bytes; tc:: and ltc:: (mma.sync) read 13-73% of
// it. Both wait on their loads: tc:: takes q and all of K in one cp.async
// group before the first product (at 101 keys, d = 128, a block holds
// 91 KB and two fit an SM), and each of its warps runs its 16 rows'
// mma.sync chain alone. This design streams the keys from the first tile
// on, puts the products on wgmma and buys blocks an SM against latency, as
// the wgmma backward does; latency still bounds it (it reads 13-73% of the
// bound at the shapes it is routed to; chip_smoke.py, H100 80GB HBM3,
// 700 W):
//
// * A block is one (batch, head) and up to 128 query rows: two consumer
//   warpgroups of 64 rows, which share the key and value tiles, so that K
//   and V are read once per head at Sq <= 128 (d = 128: 1.4x faster than
//   blocks of 64 rows at 101 x 101). One warpgroup where Sq <= 64, and at
//   d = 64 below 129 keys, where blocks of 128 threads and 41 KB pack an SM
//   tighter (5-7% faster at 121-128 keys in an A/B, when the block held
//   96-103 registers, five an SM; the probabilities output took it to
//   108-110, four an SM); the second read of K and V hits L2.
// * Q stays resident in 128-byte-swizzled [64][D] tiles, one a warpgroup.
//   K and V stream through a ring of shared-memory stages of 64 keys (two
//   stages; three past 128 keys at d = 64), filled by 16-byte cp.async from
//   the caller's strides (zero-filled past Sk; the bias -inf there). Tile
//   t + stages - 1 is in flight while tile t's products run; at or under
//   128 keys the k tiles go first and v after them (4-19% faster than each
//   v with its k). cp.async, not TMA: a tensor map cannot encode the
//   stride-0 batch that retrieval's fast_mode hands K1.
// * S = Q K^T on wgmma.m64nNk16, both operands from shared memory
//   (K-major); the last tile of the key axis does only its keys rounded up
//   to 16 (N 16 to 64). O += P V on wgmma with P packed to bf16 as the
//   register A operand and V read MN-major from its tile.
// * The softmax runs on the accumulators: the row max by quad shuffles,
//   2^(s scale log2(e) + bias log2(e) - m) by one fused multiply-add and
//   ex2.approx, -inf past Sk. l sums the UNDROPPED exps, as the TPU kernel
//   normalizes before it drops.
// * Rounding. Where the ring holds the whole key axis (Sk <= 128: every
//   shape of the VQA and CC paths), the row is complete before P V: P is
//   normalized and dropped BEFORE it is rounded to bf16, as the TPU kernel
//   (_fwd_kernel:75-76) and tc:: do ("exact" branch). Past 128 keys, an
//   online softmax: exp(s - m) against the running max m is rounded to bf16
//   for P V, O rescaled by exp(m_old - m_new) a tile, and O keep_scale / l
//   written at the end, as ltc:: does ("online" branch; the relative
//   rounding of each P is the same size, and the backward recomputes P).
// * Registers and shared memory are sized for two blocks of two
//   warpgroups an SM (__launch_bounds__: 128 registers; about 98 KB a block
//   at d = 128). The exact branch holds S of both key tiles (122 registers
//   at d = 128, 108-110 at d = 64); the online branch takes 32 keys a
//   softmax step at d = 128, where O holds 64 registers a thread (128
//   registers, a few spilled; 64 keys a step needed 195 and one block an
//   SM: 1.2x slower at 200 x 200).
//
// Every output element is written by one block: no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "keep_mask.cuh"
#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {
namespace wgf {

using namespace vt::wgmma;  // the wgmma helpers (wgmma_bf16.cuh)

constexpr int kRows = 64;              // query rows a warpgroup
constexpr int kKeys = 64;              // keys a streamed tile
constexpr int kExactKeys = 2 * kKeys;  // up to here the ring holds the whole key axis
constexpr int kMaxKeys = 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const vt::bf16 *q, *k, *v;
  const float* bias;
  vt::bf16* out;
  vt::bf16* probs;  // [B h][Sq][Sk], or null: no probabilities
  float* lse;       // [B h][Sq], or null: no row log-sum-exps
  int num_heads, sq, sk, q_tiles;
  int64_t q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, bias_bs;  // strides in elements
  float scale;
  uint32_t seed, threshold;
  float keep_scale;
};

// Shared memory of a block of WG warpgroups: the WG q tiles, then each
// stage's k and v tiles ([64][D] bf16, swizzled, kTile bytes each), then
// each stage's bias [64] (fp32); 1024 bytes of slack to align the tiles.
template <int D, bool kExact>
struct Smem {
  static constexpr int kStages = kExact || D == 128 ? 2 : 3;
  static constexpr int kTile = kKeys * 128 * (D / 64);
  __host__ __device__ static constexpr int bias(int wg) { return (wg + 2 * kStages) * kTile; }
  __host__ __device__ static constexpr int bytes(int wg) {
    return bias(wg) + 4 * kStages * kKeys + 1024;
  }
};

// S (+)= Q K^T of one key tile for a warpgroup: N keys (a multiple of 16, at
// most 64) of the [64][D] k tile at k_t against the [64][D] q tile at q_t,
// into the first N / 2 elements of s. Issued and committed, not waited for.
template <int D, int N, int M>
__device__ __forceinline__ void qk(float (&s)[M], uint32_t q_t, uint32_t k_t) {
  float(&d)[N / 2] = *reinterpret_cast<float(*)[N / 2]>(&s);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) Mma<N>::ss(d, desc_k<kRows>(q_t, kk), desc_k<kKeys>(k_t, kk), kk);
}

template <int D, int M>
__device__ __forceinline__ void issue_qk(float (&s)[M], uint32_t q_t, uint32_t k_t, int n) {
  fence_regs(s);
  fence();
  if constexpr (M == 32) {
    if (n == 64)
      qk<D, 64>(s, q_t, k_t);
    else if (n == 48)
      qk<D, 48>(s, q_t, k_t);
    else if (n == 32)
      qk<D, 32>(s, q_t, k_t);
    else
      qk<D, 16>(s, q_t, k_t);
  } else {
    static_assert(M == 16, "S of 32 or 64 keys");
    if (n == 32)
      qk<D, 32>(s, q_t, k_t);
    else
      qk<D, 16>(s, q_t, k_t);
  }
  commit();
}

// x = s scale log2(e) + bias log2(e) in place for the first nj column groups
// of 8 of a key tile (bias_t: the tile's bias, -inf past Sk); the running
// max of this thread's two rows into m
template <int M>
__device__ __forceinline__ void scores(float (&s)[M], int nj, const float* bias_t, float sl2,
                                       float (&m)[2], int lane) {
#pragma unroll
  for (int j = 0; j < M / 4; ++j)
    if (j < nj) {
      const float2 b = *reinterpret_cast<const float2*>(bias_t + 8 * j + 2 * (lane % 4));
      const float b2[2] = {b.x * kLog2e, b.y * kLog2e};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = fmaf(s[4 * j + e], sl2, b2[e % 2]);
        m[e / 2] = fmaxf(m[e / 2], s[4 * j + e]);
      }
    }
}

// p = 2^(x - m) in place for the first nj column groups; this lane's share
// of the row sums into l
template <int M>
__device__ __forceinline__ void exps(float (&s)[M], int nj, const float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int j = 0; j < M / 4; ++j)
    if (j < nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = exp2_approx(s[4 * j + e] - m[e / 2]);
        l[e / 2] += s[4 * j + e];
      }
}

// p f[row] in place where the mask keeps (at the element's global row and
// key k0 + column) and 0 elsewhere, for the first nj column groups
template <bool kDrop, int M>
__device__ __forceinline__ void drop(float (&s)[M], int nj, const float (&f)[2], int row, int k0,
                                     uint32_t tseed, uint32_t threshold, int lane) {
#pragma unroll
  for (int j = 0; j < M / 4; ++j)
    if (j < nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[4 * j + e] * f[e / 2];
        s[4 * j + e] = !kDrop || vt::keep(row + 8 * (e / 2), k0 + 8 * j + 2 * (lane % 4) + e % 2,
                                          tseed, threshold)
                           ? p
                           : 0.f;
      }
}

// P packed to bf16 as the A operands of P V: pa[kk] holds the tile's keys
// [16 kk, 16 kk + 16) (nj column groups of 8 hold keys)
template <int M>
__device__ __forceinline__ void pack(uint32_t (&pa)[M / 8][4], const float (&s)[M], int nj) {
#pragma unroll
  for (int kk = 0; kk < M / 8; ++kk)
    if (kk < (nj + 1) / 2) acc_to_a(pa[kk], s, kk);
}

// the first nj column groups of P, each element rounded to bf16 (as P V
// takes it), into the [Sq][Sk] probabilities of a (batch, head) at the
// global row `row` (+ 8) and keys k0 + column, inside Sq and Sk
template <int M>
__device__ __forceinline__ void store_p(vt::bf16* probs, const float (&s)[M], int nj, int row,
                                        int k0, int sq, int sk, int lane) {
  vt::store_probs<M / 4>(probs, *reinterpret_cast<const float(*)[M / 4][4]>(&s), nj, row, k0, sq,
                         sk, lane);
}

// O += P V over the first nk k-steps of 16 keys of the v tile at v_t.
// Issued and committed, not waited for.
template <int D, int KK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[KK][4],
                                         uint32_t v_t, int nk) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
    if (kk < nk) MmaRs<D>::rs(o, pa[kk], desc_mn<kKeys>(v_t, kk));
}

// O, already normalized, written once in bf16 [B, Sq, H] (out: the
// warpgroup's first row and the head); with `lse`, each row's (m + log2 l)
// ln 2 = m' + log l in the scores' own units
template <int D>
__device__ __forceinline__ void store_out(const Args& a, vt::bf16* out, const float (&o)[D / 2],
                                          const float (&m)[2], const float (&l)[2], int rows,
                                          int row, int bh, int warp, int lane) {
  store_acc<D>(out, o, rows, (int64_t)a.num_heads * D, 1.f, warp, lane);
  if (a.lse != nullptr && lane % 4 == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row + 8 * r < a.sq)
        a.lse[(int64_t)bh * a.sq + row + 8 * r] = (m[r] + log2f(l[r])) * kLn2;
}

template <int D, int WG, bool kExact, bool kDrop>
__global__ void __launch_bounds__(128 * WG, 4 / WG) attention_fwd_wg_kernel(const Args a) {
  using L = Smem<D, kExact>;
  constexpr int kThreads = 128 * WG, kStages = L::kStages;
  // keys a softmax step of the online branch takes: 32 at d = 128, where O
  // holds 64 registers a thread, so that S, P and O fit the 128 registers
  // that two blocks of two warpgroups an SM leave
  constexpr int kStep = D == 128 ? 32 : kKeys;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (vt::smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - vt::smem_addr(smem_raw));
  auto k_stage = [&](int st) { return base + (WG + 2 * st) * L::kTile; };
  auto v_stage = [&](int st) { return k_stage(st) + L::kTile; };
  float* bias_s = reinterpret_cast<float*>(smem + L::bias(WG));  // [kStages][kKeys]

  const int tile = blockIdx.x % a.q_tiles;
  const int bh = blockIdx.x / a.q_tiles;
  const int h = bh % a.num_heads;
  const int64_t b = bh / a.num_heads;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int q0 = tile * kRows * WG;  // the block's first query row
  const int qw = q0 + kRows * wg;    // this warpgroup's
  const bool active = qw < a.sq;
  const uint32_t q_t = base + wg * L::kTile;
  const vt::bf16* kb = a.k + b * a.k_bs + h * D;
  const vt::bf16* vb = a.v + b * a.v_bs + h * D;
  const float* bias_b = a.bias + b * a.bias_bs;
  const int n_tiles = (a.sk + kKeys - 1) / kKeys;

  // key tile t into its stage: the k rows to the tile's last 16 (zero past
  // Sk) and the bias (-inf past Sk); then, apart, the v rows
  auto tile_rows = [&](int t) { return (min(kKeys, a.sk - t * kKeys) + 15) / 16 * 16; };
  auto load_k = [&](int t) {
    const int k0 = t * kKeys, keys = min(kKeys, a.sk - k0), st = t % kStages;
    load_tile<D, kKeys, kThreads>(k_stage(st), kb + k0 * a.k_rs, keys, tile_rows(t), a.k_rs, tid);
    for (int j = tid; j < tile_rows(t); j += kThreads) {
      float* dst = bias_s + st * kKeys + j;
      if (j < keys)
        cp_async4(vt::smem_addr(dst), bias_b + k0 + j);
      else
        *dst = -INFINITY;
    }
  };
  auto load_v = [&](int t) {
    const int k0 = t * kKeys;
    load_tile<D, kKeys, kThreads>(v_stage(t % kStages), vb + k0 * a.v_rs,
                                  min(kKeys, a.sk - k0), tile_rows(t), a.v_rs, tid);
  };

  // the warpgroups' q tiles (rows past Sq zero; none for a warpgroup wholly
  // past Sq) in the first group of copies, with key tile 0
#pragma unroll
  for (int w = 0; w < WG; ++w) {
    const int r0 = q0 + kRows * w;
    if (r0 < a.sq)
      load_tile<D, kRows, kThreads>(base + w * L::kTile, a.q + b * a.q_bs + r0 * a.q_rs + h * D,
                                    min(kRows, a.sq - r0), kRows, a.q_rs, tid);
  }

  const int row = qw + 16 * warp + lane / 4;  // global query row of elements 0, 1
  const int rows = min(kRows, a.sq - qw);     // this warpgroup's rows below Sq
  const uint32_t tseed = vt::tile_seed(a.seed, bh);
  const float sl2 = a.scale * kLog2e;
  const int64_t hidden = (int64_t)a.num_heads * D;
  vt::bf16* out = a.out + (b * a.sq + qw) * hidden + h * D;
  vt::bf16* probs = a.probs == nullptr ? nullptr : a.probs + (int64_t)bh * a.sq * a.sk;
  float o[D / 2];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  if constexpr (kExact) {
    // three groups of copies: q and k tile 0, k tile 1, then v (4-19%
    // faster than each v with its k tile). S of each key tile (keys
    // [0, 64), [64, 128)) is issued as its tile lands; the softmax runs
    // while v lands; the row is complete, so P is normalized and dropped
    // before it is rounded.
    load_k(0);
    vt::cp_async_commit();
    if (n_tiles > 1) load_k(1);
    vt::cp_async_commit();
    load_v(0);
    if (n_tiles > 1) load_v(1);
    vt::cp_async_commit();
    const int n0 = tile_rows(0), n1 = n_tiles > 1 ? tile_rows(1) : 0;
    float s0[kKeys / 2], s1[kKeys / 2];
    uint32_t pa0[kKeys / 16][4], pa1[kKeys / 16][4];
    vt::cp_async_wait<2>();  // q and k tile 0 are in
    fence_proxy_async();
    __syncthreads();
    if (active) issue_qk<D>(s0, q_t, k_stage(0), n0);
    vt::cp_async_wait<1>();  // k tile 1 is in
    fence_proxy_async();
    __syncthreads();
    if (active) {
      if (n1) issue_qk<D>(s1, q_t, k_stage(1), n1);
      wait<0>();
      fence_regs(s0);
      fence_regs(s1);
      scores(s0, n0 / 8, bias_s, sl2, m, lane);
      scores(s1, n1 / 8, bias_s + kKeys, sl2, m, lane);
      m[0] = vt::quad_max(m[0]);
      m[1] = vt::quad_max(m[1]);
      exps(s0, n0 / 8, m, l);
      exps(s1, n1 / 8, m, l);
      l[0] = vt::quad_sum(l[0]);
      l[1] = vt::quad_sum(l[1]);
      const float f[2] = {a.keep_scale / l[0], a.keep_scale / l[1]};
      drop<kDrop>(s0, n0 / 8, f, row, 0, tseed, a.threshold, lane);
      drop<kDrop>(s1, n1 / 8, f, row, kKeys, tseed, a.threshold, lane);
      if (probs != nullptr) {  // P as P V takes it, before the packing frees s
        store_p(probs, s0, n0 / 8, row, 0, a.sq, a.sk, lane);
        store_p(probs, s1, n1 / 8, row, kKeys, a.sq, a.sk, lane);
      }
      pack(pa0, s0, n0 / 8);
      pack(pa1, s1, n1 / 8);
    }
    vt::cp_async_wait<0>();  // v is in
    fence_proxy_async();
    __syncthreads();
    if (!active) return;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    fence_regs(o);
    fence();
    issue_pv<D>(o, pa0, v_stage(0), n0 / 16);
    issue_pv<D>(o, pa1, v_stage(1), n1 / 16);
    commit();
    wait<0>();
    fence_regs(o);
    fence_regs(pa0);
    fence_regs(pa1);
  } else {
    // the tiles the ring holds ahead of tile 0, one group each
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < n_tiles) {
        load_k(t);
        load_v(t);
      }
      vt::cp_async_commit();
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      vt::cp_async_wait<kStages - 2>();  // q and tile t are in
      fence_proxy_async();
      __syncthreads();  // ... for every thread; the stage loaded next was consumed at t - 1
      if (t + kStages - 1 < n_tiles) {
        load_k(t + kStages - 1);
        load_v(t + kStages - 1);
      }
      vt::cp_async_commit();
      if (!active) continue;
      const int st = t % kStages, k0 = t * kKeys, keys = min(kKeys, a.sk - k0);
#pragma unroll
      for (int j0 = 0; j0 < kKeys; j0 += kStep) {
        if (j0 >= keys) break;
        const int n = (min(kStep, keys - j0) + 15) / 16 * 16;
        float s[kStep / 2];
        issue_qk<D>(s, q_t, k_stage(st) + j0 * 128, n);
        wait<0>();
        fence_regs(s);
        float mn[2] = {m[0], m[1]};
        scores(s, n / 8, bias_s + st * kKeys + j0, sl2, mn, lane);
        float c[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mn[r] = vt::quad_max(mn[r]);
          c[r] = exp2_approx(m[r] - mn[r]);  // 0 at the first step (m = -inf)
          m[r] = mn[r];
          l[r] *= c[r];
        }
        exps(s, n / 8, m, l);
        uint32_t pa[kStep / 16][4];
        const float one[2] = {1.f, 1.f};
        drop<kDrop>(s, n / 8, one, row, k0 + j0, tseed, a.threshold, lane);
        pack(pa, s, n / 8);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= c[(i % 4) / 2];
        fence_regs(o);
        fence();
        issue_pv<D>(o, pa, v_stage(st) + j0 * 128, n / 16);
        commit();
        wait<0>();
        fence_regs(o);
        fence_regs(pa);
      }
    }
    l[0] = vt::quad_sum(l[0]);
    l[1] = vt::quad_sum(l[1]);
    const float f[2] = {a.keep_scale / l[0], a.keep_scale / l[1]};
    if (active) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= f[(i % 4) / 2];
      store_out<D>(a, out, o, m, l, rows, row, bh, warp, lane);
    }
    if (probs == nullptr) return;

    // With `probs`: a second sweep over the key tiles, now that each row's
    // max m and sum l are final, as ltc:: does. S is recomputed, P =
    // 2^(x - m) keep_scale / l where the mask keeps and 0 elsewhere,
    // rounded to bf16 into [B, h, Sq, Sk]: the normalized probabilities, as
    // the TPU kernel rounds them (the sweep above rounded the unnormalized
    // exps for P V).
    __syncthreads();  // every warpgroup is done with the ring's stages
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < n_tiles) load_k(t);
      vt::cp_async_commit();
    }
    for (int t = 0; t < n_tiles; ++t) {
      vt::cp_async_wait<kStages - 2>();
      fence_proxy_async();
      __syncthreads();
      if (t + kStages - 1 < n_tiles) load_k(t + kStages - 1);
      vt::cp_async_commit();
      if (!active) continue;
      const int st = t % kStages, k0 = t * kKeys, keys = min(kKeys, a.sk - k0);
#pragma unroll
      for (int j0 = 0; j0 < kKeys; j0 += kStep) {
        if (j0 >= keys) break;
        const int n = (min(kStep, keys - j0) + 15) / 16 * 16;
        float s[kStep / 2];
        issue_qk<D>(s, q_t, k_stage(st) + j0 * 128, n);
        wait<0>();
        fence_regs(s);
        float mx[2] = {m[0], m[1]}, lx[2] = {0.f, 0.f};  // not kept: m and l are final
        scores(s, n / 8, bias_s + st * kKeys + j0, sl2, mx, lane);
        exps(s, n / 8, m, lx);
        drop<kDrop>(s, n / 8, f, row, k0 + j0, tseed, a.threshold, lane);
        store_p(probs, s, n / 8, row, k0 + j0, a.sq, a.sk, lane);
      }
    }
    return;
  }
  store_out<D>(a, out, o, m, l, rows, row, bh, warp, lane);
}

template <int D, int WG, bool kExact, bool kDrop>
cudaError_t launch(Args a, int batch, cudaStream_t stream) {
  a.q_tiles = (a.sq + kRows * WG - 1) / (kRows * WG);
  const long long blocks = (long long)batch * a.num_heads * a.q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int smem = Smem<D, kExact>::bytes(WG);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_wg_kernel<D, WG, kExact, kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attention_fwd_wg_kernel<D, WG, kExact, kDrop><<<(unsigned)blocks, 128 * WG, smem, stream>>>(a);
  return cudaGetLastError();
}

// the exact branch where the ring holds the whole key axis; blocks of one
// warpgroup where Sq <= 64 and, at d = 64, in the exact branch (blocks of
// 128 threads and 41 KB: faster at 121-128 keys than two warpgroups
// sharing K and V, whose second read of K and V is served by L2), else two
template <int D, bool kDrop>
cudaError_t launch_shape(const Args& a, int batch, cudaStream_t stream) {
  const bool exact = a.sk <= kExactKeys;
  if (a.sq <= kRows || (D == 64 && exact))
    return exact ? launch<D, 1, true, kDrop>(a, batch, stream)
                 : launch<D, 1, false, kDrop>(a, batch, stream);
  return exact ? launch<D, 2, true, kDrop>(a, batch, stream)
               : launch<D, 2, false, kDrop>(a, batch, stream);
}

}  // namespace wgf
}  // namespace

// The wgmma variant: bf16 q, k, v and out, fp32 bias, 1 <= Sk <= 1024,
// head_dim 64 or 128; q, k and v 16-byte aligned with batch and row strides
// that are multiples of 8 elements (16 bytes); lse null or an fp32
// [B, h, Sq] that receives each row's log-sum-exp; probs null or a bf16
// [B, h, Sq, Sk] that receives P after dropout. The arguments of vt_attention_fwd_tc
// (attention.cu); cudaErrorInvalidValue for what it does not take (the
// Python wrapper checks these first).
extern "C" int vt_attention_fwd_wg(const void* q, const void* k, const void* v, const void* bias,
                                   void* out, int batch, int num_heads, int head_dim, int sq,
                                   int sk, long long q_bstride, long long q_rstride,
                                   long long k_bstride, long long k_rstride, long long v_bstride,
                                   long long v_rstride, long long bias_bstride, float scale,
                                   unsigned int seed, unsigned int threshold, float keep_scale,
                                   void* lse, void* probs, void* stream) {
  if (sk < 1 || sk > wgf::kMaxKeys || sq < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 ||
      (q_bstride | q_rstride | k_bstride | k_rstride | v_bstride | v_rstride) % 8)
    return (int)cudaErrorInvalidValue;
  const wgf::Args a{static_cast<const vt::bf16*>(q), static_cast<const vt::bf16*>(k),
                    static_cast<const vt::bf16*>(v), static_cast<const float*>(bias),
                    static_cast<vt::bf16*>(out), static_cast<vt::bf16*>(probs),
                    static_cast<float*>(lse), num_heads, sq, sk, 0,
                    q_bstride, q_rstride, k_bstride, k_rstride, v_bstride, v_rstride,
                    bias_bstride, scale, seed, threshold, keep_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = threshold != 0u || keep_scale != 1.f;
  if (head_dim == 64)
    return (int)(drop ? wgf::launch_shape<64, true>(a, batch, s)
                      : wgf::launch_shape<64, false>(a, batch, s));
  if (head_dim == 128)
    return (int)(drop ? wgf::launch_shape<128, true>(a, batch, s)
                      : wgf::launch_shape<128, false>(a, batch, s));
  return (int)cudaErrorInvalidValue;
}
