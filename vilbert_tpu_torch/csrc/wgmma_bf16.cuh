// wgmma building blocks of the bf16 attention kernels for Hopper (sm_90a):
// the forward (attention_fwd_wg.cu) and the backward (attention_bwd_wg.cu).
// Shared-memory matrix descriptors of 128-byte-swizzled tiles, the
// asynchronous wgmma.mma_async products (both operands from shared memory,
// or A from registers), the fences that order them against the registers
// and shared memory they touch, 16-byte cp.async tile loads into the
// swizzled layout, and the accumulator-to-A-operand packing.
//
// Accumulator layout of a 64 x N wgmma (four warps, 16 rows each): element
// 4 j + e of a thread is row 16 warp + lane / 4 + 8 (e / 2), column 8 j +
// 2 (lane % 4) + e % 2, as mma.sync's C fragments (mma_bf16.cuh) side by
// side; so a row's max and sum reduce over the four lanes of a quad.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace vt {
namespace wgmma {

// ---- wgmma (PTX ISA: wgmma.mma_async, the shared-memory matrix descriptor) ---

// Descriptor of a 128-byte-swizzled operand at shared address `addr`: SBO 1024
// bytes (eight rows of 128 bytes), LBO `lbo` bytes, layout type 1 (B128).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// A [R][D] bf16 tile is stored as D / 64 panels of [R][64] (R rows of 128
// bytes each), the 16-byte chunk c of row r at chunk c ^ (r % 8) of its row:
// the layout of the B128 descriptors. The tile starts 1024-byte aligned.
// K-major operand (rows of the tile are M or N, its columns K): k-step kk
// covers columns [16 kk, 16 kk + 16), 32 bytes into a panel's rows.
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + (kk / 4) * (R * 128) + (kk % 4) * 32, 16);
}

// MN-major B operand (rows of the tile are K, its D columns N): k-step kk
// covers rows [16 kk, 16 kk + 16); the panels of 64 columns are LBO apart.
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * 128, R * 128);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most n committed wgmma groups are still running
template <int n>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}

// keeps the compiler from moving accumulator reads and writes across the
// asynchronous wgmma that owns the registers, and from reusing the
// registers of an A operand before the wgmma that reads them is done
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// generic-proxy writes to shared memory (cp.async, stores) made visible to
// wgmma's reads, which go through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
struct Mma;
template <int N>
struct MmaRs;

template <>
struct Mma<16> {
  // d (+)= a b, a [64 x 16] and b [16 x 16] from shared memory, both K-major
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Mma<32> {
  // d (+)= a b, a [64 x 16] and b [16 x 32] from shared memory, both K-major
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Mma<48> {
  // d (+)= a b, a [64 x 16] and b [16 x 48] from shared memory, both K-major
  static __device__ __forceinline__ void ss(float (&d)[24], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Mma<64> {
  // d (+)= a b, a [64 x 16] and b [16 x 64] from shared memory, both K-major
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct MmaRs<64> {
  // d += a b, a [64 x 16] in registers (bf16 pairs), b [16 x 64] from shared
  // memory, MN-major (trans-b)
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct MmaRs<128> {
  // d += a b, a [64 x 16] in registers (bf16 pairs), b [16 x 128] from shared
  // memory, MN-major (trans-b)
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// ---- shared-memory tiles ----------------------------------------------------

// 16 bytes global -> shared by cp.async, or 16 zero bytes when !valid (src is
// not read then)
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// rows [0, n_rows) of one head into a swizzled [R][D] tile at shared address
// `tile`, by the kThreads threads of the block: rows below n_valid from src
// (row stride rs elements, 16-byte aligned), the rest zero
template <int D, int R, int kThreads = 128>
__device__ __forceinline__ void load_tile(uint32_t tile, const vt::bf16* __restrict__ src,
                                          int n_valid, int n_rows, int64_t rs, int tid) {
  constexpr int kChunks = D / 8;
  for (int i = tid; i < n_rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const uint32_t dst = tile + (c / 8) * (R * 128) + r * 128 + (((c % 8) ^ (r % 8)) * 16);
    const bool valid = r < n_valid;
    cp_async16_zfill(dst, valid ? src + r * rs + c * 8 : src, valid);
  }
}

// 4 bytes global -> shared by cp.async
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// 2^x on the special-function unit (-inf -> 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the accumulator of a 64 x N wgmma as the register A operand of k-step kk
// of the next: elements 8 kk .. 8 kk + 7 (columns [16 kk, 16 kk + 16))
template <int M>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[M], int kk) {
  a[0] = vt::pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
  a[1] = vt::pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = vt::pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = vt::pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
}

// a 64 x D accumulator times f in bf16 to rows [0, rows) of dst (row stride
// ld elements, already offset to the block's first row and the head).
// Element 4 j + e is row 16 warp + lane / 4 + 8 (e / 2), column 8 j +
// 2 (lane % 4) + e % 2.
template <int D>
__device__ __forceinline__ void store_acc(vt::bf16* dst, const float (&c)[D / 2], int rows,
                                          int64_t ld, float f, int warp, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = 16 * warp + lane / 4 + 8 * half;
    if (r < rows) {
      vt::bf16* out = dst + r * ld + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j) =
            vt::pack_bf16(c[4 * j + 2 * half] * f, c[4 * j + 2 * half + 1] * f);
    }
  }
}

}  // namespace wgmma
}  // namespace vt
