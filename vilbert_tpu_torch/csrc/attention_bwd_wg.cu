// Multi-head attention backward for Hopper on wgmma (sm_90a), bf16: the "wg"
// variant of K2, beside the four of attention_bwd.cu.
//
// Replaces the TPU kernel vilbert_tpu/ops/pallas_attention_train.py::_bwd_kernel
// (K2) for bf16 q, k, v and g at 1 <= Sq, Sk <= 1024, d 64 or 128, rate 0 or
// the _keep_mask hash (keep_mask.cuh, bit-identical to the forward's):
//   P_drop = keep ? P / (1 - rate) : 0
//   dv = P_drop^T g
//   dp = keep ? (g v^T) / (1 - rate) : 0
//   ds = P (dp - rowsum(dp P))                  (the undropped P)
//   dq = ds k / sqrt(d),  dk = ds^T q / sqrt(d)
// It takes two things from the forward (K1's bf16 variants, attention.cu):
// the output O and each query row's log-sum-exp L = m + log l of the scaled,
// biased scores. Then P = exp(s - L) needs no walk over the row first, and
// rowsum(dp P) = rowsum(g O), since O = P_drop v. So it runs seven products
// (dq kernel: S, dP, dQ; dkdv kernel: S^T, dP^T, dV, dK), where the mma.sync
// long variant (attention_bwd.cu lktc::) runs nine: it computes S and dP
// twice for the row statistics and dq, and once more transposed for dk, dv.
//
// What bounds it on the H100: at the paths' long shapes the operations.
// A (batch, head) does 10 Sq Sk d flops (the five products counted once)
// against 2 (4 Sq + 3 Sk) d bytes in bf16; at the baseline's 562 keys, d 64,
// that is ~400 flop a byte, past the card's ridge of ~295 at 989 TFLOP/s and
// 3.35 TB/s. The design goes after the tensor-core rate: the products run on
// wgmma (the only way to it on Hopper), from 128-byte-swizzled shared memory
// tiles, and the elementwise work between them in registers.
//
// Two kernels, one warpgroup (128 threads) a block, 64 rows of the owned
// axis a block; the other axis streams through shared memory in tiles (of
// 64 queries; of 64 keys at d = 64 and 32 at d = 128):
//
// * dq kernel: a block owns 64 query rows (q and g resident). Its prologue
//   computes D = rowsum(g O) of its rows and writes L log2(e) to the fp32
//   workspace for the dkdv kernel. Per key tile: S = Q K^T and dP = G V^T
//   on wgmma.m64nNk16 (both operands from shared memory, K-major), P =
//   2^(s scale log2(e) + bias log2(e) - L log2(e)) (one fused multiply-add
//   and ex2.approx), dp dropped and rescaled by the mask at each element's
//   global (query, key), ds = P (dp - D) in registers, packed to bf16 as the
//   register A operand of dQ += ds K (wgmma with K read MN-major from the
//   same tile). dq = dQ / sqrt(d), written once. The walk also sums
//   rowsum(dp P) from its fp32 P and dp, and writes that D for the dkdv
//   kernel: rowsum(g O) differs from it by O's bf16 rounding, up to 2^-9
//   |g| |O| a row, which is most of ds where the softmax puts nearly all of
//   a row on one key (ds -> 0) and would reach dk there; dq keeps rowsum(g O)
//   (its share of that error is 2^-9 |dp| times the P-weighted mean of k).
// * dkdv kernel: a block owns 64 keys (k and v resident). Per query tile,
//   in steps of 32 queries: S^T = K Q^T and dP^T = V G^T on wgmma, so that
//   P^T and ds^T come out with this block's keys as rows; P_drop^T and ds^T
//   are packed in registers as the A operands of dV += P_drop^T G and dK +=
//   ds^T Q (G and Q read MN-major from their tiles). dK and dV stay in
//   registers; written once.
//
// What bounds the kernels on the card is latency more than any rate: each
// warpgroup waits on its own wgmma chains, so the design buys blocks an SM.
// The dq kernel's key tiles (32 at d = 128), its two stages and the dkdv
// kernel's 32-query steps keep a block within 75 KB of shared memory and
// 170 registers at d = 64 (dq also at d = 128), so three or four share an
// SM: at the paths' shapes 10-17% faster at d = 64 than 64-row tiles
// throughout and three dq stages, 0-12% at d = 128 (scripts/ab_kernels.py
// --kernel attention_bwd, H100 80GB HBM3, 700 W).
// The streamed tiles arrive through a ring of shared-memory stages filled
// by 16-byte cp.async (zero-filled past the sequence; dq two stages, dkdv
// three at d = 64 and two at d = 128): tile t + kStages - 1 is in flight
// while tile t's products run. cp.async, not TMA: the [B, S, H] operands
// are read through the caller's strides, a stride-0 batch included, which
// a tensor map cannot encode, and the loads cost the 128 threads a few
// instructions a tile. Within a tile the two products from shared memory
// go out as two wgmma groups, and the elementwise work on the first (P)
// runs while the second (dP) is on the tensor cores; in the dkdv kernel ds
// is formed while dV's product runs. The last tile of the streamed axis
// does only its rows rounded up to 16, through the wgmma N of that width
// (16 to 64), so 131 keys cost about 131/128 of 128 on that axis.
//
// P_drop and ds are rounded to bf16 as wgmma operands (the TPU kernel keeps
// them in fp32), as in the mma.sync variants. D from the bf16 O differs
// from rowsum(dp P) by up to a bf16 rounding of O; at Sk = 1, where P = 1
// and the exact ds is 0, that difference would be all of ds, so there ds
// is 0. Every output element is written by one block: no atomics, and the
// result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "keep_mask.cuh"
#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {
namespace wg {

using namespace vt::wgmma;  // the wgmma helpers (wgmma_bf16.cuh)

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = 64;      // rows of the owned axis a block, and of a streamed query tile
constexpr int kMaxSeq = 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTileBytes = kRows * 128;  // one 64-column panel of a [64][D] bf16 tile

template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return kTileBytes * (D / 64);
}

struct Args {
  const vt::bf16 *q, *k, *v, *g, *o;
  const float* bias;
  const float* lse;  // [B h][Sq]: each row's log-sum-exp, from the forward
  vt::bf16 *dq, *dk, *dv;
  float* ws;  // [2][B h][Sq]: L log2(e) and D, written by the dq kernel
  int num_heads, sq, sk;
  int64_t q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, g_bs, g_rs, bias_bs;  // strides in elements
  float scale;
  uint32_t seed, threshold;
  float keep_scale;
};

// ---- dq kernel --------------------------------------------------------------

template <int D>
struct DqSmem {
  // keys a streamed tile: 32 at d = 128, which keeps the block within 75 KB
  // of shared memory and 170 registers, so that three blocks share an SM
  static constexpr int kKeys = D == 128 ? 32 : 64;
  static constexpr int kStages = 2;
  static constexpr int kKeyTile = kKeys * 128 * (D / 64);  // bytes of a [kKeys][D] tile
  // q and g (tile_bytes each), each stage's k and v (kKeyTile each), then
  // fp32: each stage's bias [kKeys], the block's L log2(e) [64] and D [64]
  static constexpr int kBias = 2 * tile_bytes<D>() + 2 * kStages * kKeyTile;
  static constexpr int kRowStats = kBias + 4 * kStages * kKeys;
  static constexpr int kBytes = kRowStats + 4 * 2 * kRows + 1024;  // + alignment slack
};

// one key tile of N keys (N the rows the tile holds, a multiple of 16) in
// stage tiles of KR rows. S and dP go out as two wgmma groups; P is formed
// while dP runs.
template <int D, int KR, int N, bool kDrop>
__device__ __forceinline__ void dq_tile(float (&dq)[D / 2], uint32_t q_t, uint32_t g_t,
                                        uint32_t k_t, uint32_t v_t, const float* bias_t,
                                        const float (&lse2)[2], const float (&dd)[2],
                                        float (&dsum)[2], const Args& a, int row, int k0,
                                        uint32_t tseed, int lane) {
  float s[N / 2], dp[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] = dp[i] = 0.f;
  fence_regs(s);
  fence_regs(dp);
  fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Mma<N>::ss(s, desc_k<kRows>(q_t, kk), desc_k<KR>(k_t, kk), 1);
  commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Mma<N>::ss(dp, desc_k<kRows>(g_t, kk), desc_k<KR>(v_t, kk), 1);
  commit();
  wait<1>();  // S is in, dP still running
  fence_regs(s);
  // P = 2^(s scale log2(e) + bias log2(e) - L log2(e)) in place of S; keys
  // past Sk have bias -inf, so P = 0
  const float sl2 = a.scale * kLog2e;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias_t + 8 * j + 2 * (lane % 4));
    const float b2[2] = {b.x * kLog2e, b.y * kLog2e};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * j + e] = exp2_approx(fmaf(s[4 * j + e], sl2, b2[e % 2]) - lse2[e / 2]);
  }
  wait<0>();
  fence_regs(dp);
  // ds in place of P; this lane's share of rowsum(dp P) into dsum
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * (lane % 4) + e % 2, r = e / 2;
      float d = dp[4 * j + e];
      if (kDrop) d = vt::keep(row + 8 * r, k0 + col, tseed, a.threshold) ? d * a.keep_scale : 0.f;
      dsum[r] = fmaf(s[4 * j + e], d, dsum[r]);
      s[4 * j + e] = a.sk == 1 ? 0.f : s[4 * j + e] * (d - dd[r]);
    }
  uint32_t ds[N / 16][4];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) acc_to_a(ds[kk], s, kk);
  fence_regs(dq);
  fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) MmaRs<D>::rs(dq, ds[kk], desc_mn<KR>(k_t, kk));
  commit();
  wait<0>();
  fence_regs(dq);
  fence_regs(ds);
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_wg_dq_kernel(const Args a, int q_tiles) {
  using L = DqSmem<D>;
  constexpr int kStages = L::kStages, kKeys = L::kKeys;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (vt::smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - vt::smem_addr(smem_raw));
  const uint32_t q_t = base, g_t = base + tile_bytes<D>();
  auto k_stage = [&](int st) { return base + 2 * tile_bytes<D>() + 2 * st * L::kKeyTile; };
  auto v_stage = [&](int st) { return k_stage(st) + L::kKeyTile; };
  float* bias_s = reinterpret_cast<float*>(smem + L::kBias);  // [kStages][kKeys]
  float* lse2_s = reinterpret_cast<float*>(smem + L::kRowStats);
  float* dd_s = lse2_s + kRows;

  const int tile = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;
  const int h = bh % a.num_heads;
  const int64_t b = bh / a.num_heads;
  const int q0 = tile * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = min(kRows, a.sq - q0);
  const vt::bf16* kb = a.k + b * a.k_bs + h * D;
  const vt::bf16* vb = a.v + b * a.v_bs + h * D;
  const float* bias_b = a.bias + b * a.bias_bs;
  const int n_tiles = (a.sk + kKeys - 1) / kKeys;

  // key tile t into its stage: k and v rows to the tile's last 16 (zero past
  // Sk), the bias (-inf past Sk)
  auto load_keys = [&](int t) {
    const int k0 = t * kKeys, keys = min(kKeys, a.sk - k0), st = t % kStages;
    const int n_rows = (keys + 15) / 16 * 16;
    load_tile<D, kKeys>(k_stage(st), kb + k0 * a.k_rs, keys, n_rows, a.k_rs, tid);
    load_tile<D, kKeys>(v_stage(st), vb + k0 * a.v_rs, keys, n_rows, a.v_rs, tid);
    for (int j = tid; j < n_rows; j += kThreads) {
      float* dst = bias_s + st * kKeys + j;
      if (j < keys)
        cp_async4(vt::smem_addr(dst), bias_b + k0 + j);
      else
        *dst = -INFINITY;
    }
  };

  load_tile<D, kRows>(q_t, a.q + b * a.q_bs + q0 * a.q_rs + h * D, rows, kRows, a.q_rs, tid);
  load_tile<D, kRows>(g_t, a.g + b * a.g_bs + q0 * a.g_rs + h * D, rows, kRows, a.g_rs, tid);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_keys(t);
    vt::cp_async_commit();
  }

  // D = rowsum(g O) of the block's rows, two threads a row, for this
  // kernel's ds; L log2(e) to the workspace for the dkdv kernel
  {
    const int r = tid / 2, half = tid % 2;
    float sum = 0.f;
    if (r < rows) {
      const int64_t hidden = (int64_t)a.num_heads * D;
      const vt::bf16* gr = a.g + b * a.g_bs + (q0 + r) * a.g_rs + h * D + half * (D / 2);
      const vt::bf16* orow = a.o + (b * a.sq + q0 + r) * hidden + h * D + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 gv = *reinterpret_cast<const uint4*>(gr + c);
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 gf = __bfloat1622float2(g2[i]), of = __bfloat1622float2(o2[i]);
          sum = fmaf(gf.x, of.x, sum);
          sum = fmaf(gf.y, of.y, sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      float l2 = 0.f;
      if (r < rows) {
        const int64_t at = (int64_t)bh * a.sq + q0 + r;
        l2 = a.lse[at] * kLog2e;
        a.ws[at] = l2;
      }
      lse2_s[r] = l2;
      dd_s[r] = sum;
    }
  }
  __syncthreads();
  // this thread's rows of the accumulators: 16 warp + lane / 4 and + 8
  const int r_lo = 16 * warp + lane / 4;
  const float lse2[2] = {lse2_s[r_lo], lse2_s[r_lo + 8]};
  const float dd[2] = {dd_s[r_lo], dd_s[r_lo + 8]};
  const int row = q0 + r_lo;
  const uint32_t tseed = vt::tile_seed(a.seed, bh);

  float dq[D / 2], dsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    vt::cp_async_wait<kStages - 2>();  // q, g and tile t are in
    fence_proxy_async();
    __syncthreads();  // ... for every thread; the stage loaded next was consumed at t - 1
    if (t + kStages - 1 < n_tiles) load_keys(t + kStages - 1);
    vt::cp_async_commit();
    const int st = t % kStages, k0 = t * kKeys;
    const int n = (min(kKeys, a.sk - k0) + 15) / 16 * 16;
    const float* bias_t = bias_s + st * kKeys;
#define VT_DQ_TILE(N)                                                                        \
  dq_tile<D, kKeys, N, kDrop>(dq, q_t, g_t, k_stage(st), v_stage(st), bias_t, lse2, dd, dsum, \
                              a, row, k0, tseed, lane)
    if constexpr (kKeys == 64) {
      if (n == 64)
        VT_DQ_TILE(64);
      else if (n == 48)
        VT_DQ_TILE(48);
      else if (n == 32)
        VT_DQ_TILE(32);
      else
        VT_DQ_TILE(16);
    } else {
      if (n == 32)
        VT_DQ_TILE(32);
      else
        VT_DQ_TILE(16);
    }
#undef VT_DQ_TILE
  }
  const int64_t hidden = (int64_t)a.num_heads * D;
  store_acc<D>(a.dq + (b * a.sq + q0) * hidden + h * D, dq, rows, hidden, a.scale, warp, lane);
  // D = rowsum(dp P) from the walk's fp32 P and dp, for the dkdv kernel:
  // exact where rowsum(g O) carries O's bf16 rounding
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = vt::quad_sum(dsum[r]);
    if (lane % 4 == 0 && r_lo + 8 * r < rows)
      a.ws[(int64_t)gridDim.x / q_tiles * a.sq + (int64_t)bh * a.sq + row + 8 * r] = sum;
  }
}

// ---- dkdv kernel ------------------------------------------------------------

template <int D>
struct DkDvSmem {
  static constexpr int kStages = D == 64 ? 3 : 2;
  // k, v, then each stage's q and g (tile_bytes each), then fp32: each
  // stage's L log2(e) [64] and D [64]
  static constexpr int kRowStats = (2 + 2 * kStages) * tile_bytes<D>();
  static constexpr int kBytes = kRowStats + 4 * 2 * kStages * kRows + 1024;
};

// one step of N queries: rows [0, N) of the q and g tiles at q_t and g_t
// (a stage's tiles offset by a multiple of 16 rows, which keeps the swizzle
// phase), their L log2(e) and D at lse2_t and dd_t; b2 = bias log2(e) of
// this thread's two keys. S^T and dP^T go out as two wgmma groups: P^T is
// formed while dP^T runs, and ds^T while dV += P_drop^T G runs.
template <int D, int N, bool kDrop>
__device__ __forceinline__ void dkdv_tile(float (&dk)[D / 2], float (&dv)[D / 2], uint32_t k_t,
                                          uint32_t v_t, uint32_t q_t, uint32_t g_t,
                                          const float* lse2_t, const float* dd_t,
                                          const float (&b2)[2], const Args& a, int key,
                                          int q0, uint32_t tseed, int lane) {
  static_assert(N / 2 <= 32, "one mask bit an element");
  float st[N / 2], dpt[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) st[i] = dpt[i] = 0.f;
  fence_regs(st);
  fence_regs(dpt);
  fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Mma<N>::ss(st, desc_k<kRows>(k_t, kk), desc_k<kRows>(q_t, kk), 1);
  commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Mma<N>::ss(dpt, desc_k<kRows>(v_t, kk), desc_k<kRows>(g_t, kk), 1);
  commit();
  wait<1>();  // S^T is in, dP^T still running
  fence_regs(st);
  // P^T in place of S^T (queries past Sq have L = +inf, so P = 0), the mask
  // at each element's global (query, key) as one bit an element
  const float sl2 = a.scale * kLog2e;
  uint32_t kept = ~0u;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse2_t + 8 * j + 2 * (lane % 4));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      st[4 * j + e] = exp2_approx(fmaf(st[4 * j + e], sl2, b2[e / 2]) - (e % 2 ? l.y : l.x));
      if (kDrop && !vt::keep(q0 + 8 * j + 2 * (lane % 4) + e % 2, key + 8 * (e / 2), tseed,
                             a.threshold))
        kept &= ~(1u << (4 * j + e));
    }
  }
  // dV += P_drop^T G, P_drop packed as the A operand
  uint32_t pa[N / 16][4];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    float pd[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int el = 8 * kk + i;
      pd[i] = !kDrop ? st[el] : (kept >> el) & 1u ? st[el] * a.keep_scale : 0.f;
    }
    pa[kk][0] = vt::pack_bf16(pd[0], pd[1]);
    pa[kk][1] = vt::pack_bf16(pd[2], pd[3]);
    pa[kk][2] = vt::pack_bf16(pd[4], pd[5]);
    pa[kk][3] = vt::pack_bf16(pd[6], pd[7]);
  }
  fence_regs(dv);
  fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) MmaRs<D>::rs(dv, pa[kk], desc_mn<kRows>(g_t, kk));
  commit();
  wait<1>();  // dP^T is in, dV still running
  fence_regs(dpt);
  // ds^T in place of dP^T, packed as the A operand of dK += ds^T Q
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 dd = *reinterpret_cast<const float2*>(dd_t + 8 * j + 2 * (lane % 4));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float d = dpt[4 * j + e];
      if (kDrop) d = (kept >> (4 * j + e)) & 1u ? d * a.keep_scale : 0.f;
      dpt[4 * j + e] = a.sk == 1 ? 0.f : st[4 * j + e] * (d - (e % 2 ? dd.y : dd.x));
    }
  }
  uint32_t da[N / 16][4];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) acc_to_a(da[kk], dpt, kk);
  fence_regs(dk);
  fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) MmaRs<D>::rs(dk, da[kk], desc_mn<kRows>(q_t, kk));
  commit();
  wait<0>();
  fence_regs(dv);
  fence_regs(dk);
  fence_regs(pa);
  fence_regs(da);
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_wg_dkdv_kernel(const Args a, int k_tiles) {
  using L = DkDvSmem<D>;
  constexpr int kStages = L::kStages;
  // queries a step of the products takes: S^T and dP^T 32 queries at a
  // time (32 registers a thread, not 64). At d = 128, where dK and dV hold
  // 128 registers a thread, that keeps the kernel within 255 registers
  // without spills; at d = 64 within 170, so that three blocks share an SM
  constexpr int kStep = 32;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (vt::smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - vt::smem_addr(smem_raw));
  const uint32_t k_t = base, v_t = base + tile_bytes<D>();
  auto q_stage = [&](int st) { return base + (2 + 2 * st) * tile_bytes<D>(); };
  auto g_stage = [&](int st) { return base + (3 + 2 * st) * tile_bytes<D>(); };
  float* stats_s = reinterpret_cast<float*>(smem + L::kRowStats);  // [kStages][2][64]

  const int tile = blockIdx.x % k_tiles;
  const int bh = blockIdx.x / k_tiles;
  const int h = bh % a.num_heads;
  const int64_t b = bh / a.num_heads;
  const int k0 = tile * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int keys = min(kRows, a.sk - k0);
  const vt::bf16* qh = a.q + b * a.q_bs + h * D;
  const vt::bf16* gh = a.g + b * a.g_bs + h * D;
  const int64_t n_rows_all = (int64_t)(gridDim.x / k_tiles) * a.sq;
  const float* lse2_b = a.ws + (int64_t)bh * a.sq;
  const float* dd_b = a.ws + n_rows_all + (int64_t)bh * a.sq;
  const int n_tiles = (a.sq + kRows - 1) / kRows;

  // query tile t into its stage: q and g rows to the tile's last 16 (zero
  // past Sq), L log2(e) (+inf past Sq) and D (0 past Sq)
  auto load_queries = [&](int t) {
    const int q0 = t * kRows, rows = min(kRows, a.sq - q0), st = t % kStages;
    const int n_rows = (rows + 15) / 16 * 16;
    load_tile<D, kRows>(q_stage(st), qh + q0 * a.q_rs, rows, n_rows, a.q_rs, tid);
    load_tile<D, kRows>(g_stage(st), gh + q0 * a.g_rs, rows, n_rows, a.g_rs, tid);
    float* lse2_s = stats_s + st * 2 * kRows;
    for (int j = tid; j < 2 * n_rows; j += kThreads) {
      const int r = j % n_rows, which = j / n_rows;
      float* dst = lse2_s + which * kRows + r;
      if (r < rows)
        cp_async4(vt::smem_addr(dst), (which ? dd_b : lse2_b) + q0 + r);
      else
        *dst = which ? 0.f : INFINITY;
    }
  };

  load_tile<D, kRows>(k_t, a.k + b * a.k_bs + k0 * a.k_rs + h * D, keys, kRows, a.k_rs, tid);
  load_tile<D, kRows>(v_t, a.v + b * a.v_bs + k0 * a.v_rs + h * D, keys, kRows, a.v_rs, tid);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_queries(t);
    vt::cp_async_commit();
  }

  // this thread's keys (rows of the accumulators): 16 warp + lane / 4 and + 8
  const int kr = 16 * warp + lane / 4;
  float b2[2];  // bias log2(e)
#pragma unroll
  for (int r = 0; r < 2; ++r)
    b2[r] = kr + 8 * r < keys ? a.bias[b * a.bias_bs + k0 + kr + 8 * r] * kLog2e : 0.f;
  const uint32_t tseed = vt::tile_seed(a.seed, bh);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    vt::cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    if (t + kStages - 1 < n_tiles) load_queries(t + kStages - 1);
    vt::cp_async_commit();
    const int st = t % kStages, q0 = t * kRows;
    const int n = (min(kRows, a.sq - q0) + 15) / 16 * 16;
    const float* lse2_t = stats_s + st * 2 * kRows;
    // the tile in steps of kStep queries (rows j0.. of its q and g tiles)
    for (int j0 = 0; j0 < n; j0 += kStep) {
      const int m = min(kStep, n - j0);
#define VT_DKDV_STEP(N)                                                                     \
  dkdv_tile<D, N, kDrop>(dk, dv, k_t, v_t, q_stage(st) + j0 * 128, g_stage(st) + j0 * 128, \
                         lse2_t + j0, lse2_t + kRows + j0, b2, a, k0 + kr, q0 + j0, tseed, lane)
      if (m == 32)
        VT_DKDV_STEP(32);
      else
        VT_DKDV_STEP(16);
#undef VT_DKDV_STEP
    }
  }
  const int64_t hidden = (int64_t)a.num_heads * D;
  const int64_t out = (b * a.sk + k0) * hidden + h * D;
  store_acc<D>(a.dv + out, dv, keys, hidden, 1.f, warp, lane);
  store_acc<D>(a.dk + out, dk, keys, hidden, a.scale, warp, lane);
}

template <int D, bool kDrop>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const long long bhs = (long long)batch * a.num_heads;
  const int q_tiles = (a.sq + kRows - 1) / kRows, k_tiles = (a.sk + kRows - 1) / kRows;
  if (bhs * q_tiles > 0x7fffffffLL || bhs * k_tiles > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_wg_dq_kernel<D, kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DqSmem<D>::kBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_wg_dkdv_kernel<D, kDrop>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, DkDvSmem<D>::kBytes);
  if (err != cudaSuccess) return err;
  // the dq kernel first: it writes the workspace the dkdv kernel reads
  attention_bwd_wg_dq_kernel<D, kDrop>
      <<<(unsigned)(bhs * q_tiles), kThreads, DqSmem<D>::kBytes, stream>>>(a, q_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_wg_dkdv_kernel<D, kDrop>
      <<<(unsigned)(bhs * k_tiles), kThreads, DkDvSmem<D>::kBytes, stream>>>(a, k_tiles);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace

// The wgmma variant: bf16 q, k, v, g and outputs, fp32 bias, 1 <= Sq, Sk <=
// 1024, head_dim 64 or 128; q, k, v and g 16-byte aligned with batch and row
// strides that are multiples of 8 elements. o is the forward's output, a
// contiguous bf16 [B, Sq, H], and lse its fp32 [B, h, Sq] row log-sum-exps
// (attention.cu's bf16 variants write both); ws an fp32 workspace of
// 2 * batch * num_heads * sq elements that the caller allocates. Other
// arguments as for vt_attention_bwd_tc; cudaErrorInvalidValue for what it
// does not take (the Python wrapper checks these first).
extern "C" int vt_attention_bwd_wg(const void* q, const void* k, const void* v, const void* bias,
                                   const void* g, const void* o, const void* lse, void* dq,
                                   void* dk, void* dv, void* ws, int batch, int num_heads,
                                   int head_dim, int sq, int sk, long long q_bstride,
                                   long long q_rstride, long long k_bstride, long long k_rstride,
                                   long long v_bstride, long long v_rstride, long long g_bstride,
                                   long long g_rstride, long long bias_bstride, float scale,
                                   unsigned int seed, unsigned int threshold, float keep_scale,
                                   void* stream) {
  if (sq < 1 || sk < 1 || sq > wg::kMaxSeq || sk > wg::kMaxSeq || batch < 1 || o == nullptr ||
      lse == nullptr || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g) |
       reinterpret_cast<uintptr_t>(o)) % 16 ||
      (q_bstride | q_rstride | k_bstride | k_rstride | v_bstride | v_rstride | g_bstride |
       g_rstride) % 8)
    return (int)cudaErrorInvalidValue;
  const wg::Args a{static_cast<const vt::bf16*>(q), static_cast<const vt::bf16*>(k),
                   static_cast<const vt::bf16*>(v), static_cast<const vt::bf16*>(g),
                   static_cast<const vt::bf16*>(o), static_cast<const float*>(bias),
                   static_cast<const float*>(lse), static_cast<vt::bf16*>(dq),
                   static_cast<vt::bf16*>(dk), static_cast<vt::bf16*>(dv),
                   static_cast<float*>(ws), num_heads, sq, sk, q_bstride, q_rstride,
                   k_bstride, k_rstride, v_bstride, v_rstride, g_bstride, g_rstride,
                   bias_bstride, scale, seed, threshold, keep_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = threshold != 0u || keep_scale != 1.f;
  if (head_dim == 64)
    return (int)(drop ? wg::launch<64, true>(a, batch, s) : wg::launch<64, false>(a, batch, s));
  if (head_dim == 128)
    return (int)(drop ? wg::launch<128, true>(a, batch, s) : wg::launch<128, false>(a, batch, s));
  return (int)cudaErrorInvalidValue;
}
