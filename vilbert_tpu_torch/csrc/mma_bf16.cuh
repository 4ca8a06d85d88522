// Building blocks of the bf16 tensor-core attention kernels
// (attention.cu, attention_bwd.cu): 16-byte cp.async loads of one head's
// rows into padded shared memory, ldmatrix, and mma.sync.m16n8k16 with bf16
// operands and fp32 accumulators.
//
// Fragment ownership of mma.m16n8k16 (lane = thread % 32, as PTX defines it):
//   A 16x16 (row-major): a0 = (lane/4, 2(lane%4) + {0,1}), a1 = row + 8,
//                        a2 = column + 8, a3 = row + 8 and column + 8
//   B 16x8 (k x n):      b0 = (k = 2(lane%4) + {0,1}, n = lane/4), b1 = k + 8
//   C 16x8:              c0, c1 = (lane/4, 2(lane%4) + {0,1}), c2, c3 = row + 8
// So two C tiles of 8 columns (n-tiles 2j and 2j + 1) are, packed to bf16,
// the A fragment of k-step j of the next product: no trip through shared
// memory between S = Q K^T and P V.
//
// Shared-memory rows hold one head's row of D bf16 values padded by 8 (an
// odd number of 16-byte units), so the eight row addresses of one ldmatrix
// fall on eight distinct bank groups.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace vt {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, cached in L2 only
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// 4 bytes global -> shared (cp.async takes 4- and 8-byte copies through L1
// only)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n committed groups are still in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b over one m16n8k16 tile
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// C tiles 2j and 2j + 1 of a 16-row strip as the A fragment of k-step j
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of a row-major
// tile with row stride ld
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int ld, int r0, int c0,
                                       int lane) {
  ldmatrix_x4(a, s + (r0 + lane % 16) * ld + c0 + (lane / 16) * 8);
}

// A fragment of the TRANSPOSE of a row-major tile: rows of A are columns
// [m0, m0 + 16) of s, its k are rows [k0, k0 + 16)
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4], const bf16* s, int ld, int k0,
                                             int m0, int lane) {
  ldmatrix_x4_trans(a, s + (k0 + lane % 8 + (lane / 16) * 8) * ld + m0 + ((lane / 8) % 2) * 8);
}

// B fragments of two n-tiles (n0 and n0 + 8) over k [k0, k0 + 16), where s
// holds B transposed, row n = column of B (b[0..1] for n0, b[2..3] for n0 + 8)
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* s, int ld, int n0, int k0,
                                          int lane) {
  ldmatrix_x4(b, s + (n0 + lane % 8 + (lane / 16) * 8) * ld + k0 + ((lane / 8) % 2) * 8);
}

// the same, where s holds B as it is, row k
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* s, int ld, int k0, int n0,
                                          int lane) {
  ldmatrix_x4_trans(b, s + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * ld + n0 + (lane / 16) * 8);
}

// c = a b^T over one warp's 16 rows [r0, r0 + 16) of a and the first kt
// tiles of 16 rows of b (both [rows][D + 8] bf16); c[n] is the C tile of
// b's rows [8 n, 8 n + 8). KT sizes the accumulators, kt <= KT is the count
// the call runs.
template <int D, int KT>
__device__ __forceinline__ void products_abt(float (&c)[2 * KT][4], const bf16* a_s,
                                             const bf16* b_s, int r0, int kt, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int n = 0; n < 2 * KT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa[4];
    load_a(fa, a_s, LD, r0, 16 * kk, lane);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j < kt) {
        uint32_t fb[4];
        load_b_nk(fb, b_s, LD, 16 * j, 16 * kk, lane);
        mma_bf16(c[2 * j], fa, fb[0], fb[1]);
        mma_bf16(c[2 * j + 1], fa, fb[2], fb[3]);
      }
    }
  }
}

// c += a b for one warp's 16-row strip, a given as bf16 A fragments in
// registers over kt k-tiles of 16 (c_to_a), b [k rows][D + 8] bf16 in
// shared memory; c[n] is the C tile of columns [8 n, 8 n + 8)
template <int D, int KT>
__device__ __forceinline__ void accumulate_ab(float (&c)[D / 8][4], const uint32_t (&a)[KT][4],
                                              const bf16* b_s, int kt, int lane) {
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    if (j < kt) {
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t fb[4];
        load_b_kn(fb, b_s, D + 8, 16 * j, 16 * nd, lane);
        mma_bf16(c[2 * nd], a[j], fb[0], fb[1]);
        mma_bf16(c[2 * nd + 1], a[j], fb[2], fb[3]);
      }
    }
  }
}

// c = a b (accumulate_ab from zero)
template <int D, int KT>
__device__ __forceinline__ void products_ab(float (&c)[D / 8][4], const uint32_t (&a)[KT][4],
                                            const bf16* b_s, int kt, int lane) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
  accumulate_ab<D, KT>(c, a, b_s, kt, lane);
}

// each row of a 16-row strip of C tiles times its own factor: elements 0, 1
// (row lane / 4) by f0, elements 2, 3 (row lane / 4 + 8) by f1
template <int N>
__device__ __forceinline__ void scale_rows(float (&c)[N][4], float f0, float f1) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    c[n][0] *= f0;
    c[n][1] *= f0;
    c[n][2] *= f1;
    c[n][3] *= f1;
  }
}

// c times f in bf16 to rows [row, row + 8) and [row + 8, ...) of dst (row
// stride ld elements, already offset to the head), where the row is below
// rows; row = the strip's first row + lane / 4
template <int D>
__device__ __forceinline__ void store_strip(bf16* dst, const float (&c)[D / 8][4], int row,
                                            int rows, int64_t ld, float f, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r < rows) {
      bf16* out = dst + r * ld + 2 * (lane % 4);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(out + 8 * n) =
            pack_bf16(c[n][2 * half] * f, c[n][2 * half + 1] * f);
    }
  }
}

// the first n_valid C tiles of a 16-row strip, each element rounded to bf16,
// into dst (row-major, row stride cols, already offset to the head): element
// e of tile n goes to row `row` + 8 (e / 2) and column col0 + 8 n +
// 2 (lane % 4) + e % 2, where that row is below rows and that column below
// cols; row = the strip's first row + lane / 4
template <int N>
__device__ __forceinline__ void store_probs(bf16* dst, const float (&s)[N][4], int n_valid,
                                            int row, int col0, int rows, int cols, int lane) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n < n_valid)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + 8 * (e / 2), c = col0 + 8 * n + 2 * (lane % 4) + e % 2;
        if (r < rows && c < cols) dst[(int64_t)r * cols + c] = __float2bfloat16(s[n][e]);
      }
}

// rows [0, rows_pad) of one head into dst (row stride D + 8): rows below
// n_valid from src (row stride rstride elements, 16-byte aligned) by
// cp.async, the rest zero. The caller commits, waits and syncs.
template <int D>
__device__ __forceinline__ void load_head_rows(bf16* dst, const bf16* __restrict__ src,
                                               int n_valid, int rows_pad, int64_t rstride,
                                               int tid, int nthreads) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < rows_pad * kChunks; i += nthreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    bf16* d = dst + r * (D + 8) + c;
    if (r < n_valid)
      cp_async16(d, src + r * rstride + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// max and sum over the four lanes that share a row of a C fragment
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// In place, the raw products q.k of a warp's 16-row strip (products_abt)
// become P = softmax(q.k scale + bias) in fp32, row by row over the sk valid
// keys; keys past sk get P = 0. Element e of tile n is row lane/4 + 8 (e/2)
// of the strip and key 8 n + 2 (lane % 4) + e % 2. With `lse`, each of the
// two rows' log-sum-exp of the scores (max + log sum) into lse[0], lse[1].
template <int KT>
__device__ __forceinline__ void softmax_strip(float (&s)[2 * KT][4], int kt, int sk,
                                              float scale, const float* bias_s, int lane,
                                              float* lse = nullptr) {
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 2 * KT; ++n) {
    if (n < 2 * kt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * (lane % 4) + e % 2;
        const float x = col < sk ? s[n][e] * scale + bias_s[col] : -INFINITY;
        s[n][e] = x;
        m[e / 2] = fmaxf(m[e / 2], x);
      }
    }
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 2 * KT; ++n) {
    if (n < 2 * kt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = expf(s[n][e] - m[e / 2]);
        s[n][e] = x;
        l[e / 2] += x;
      }
    }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  if (lse != nullptr) {
    lse[0] = m[0] + logf(l[0]);
    lse[1] = m[1] + logf(l[1]);
  }
#pragma unroll
  for (int n = 0; n < 2 * KT; ++n)
    if (n < 2 * kt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = s[n][e] / l[e / 2];
}

}  // namespace vt
