// Vectors of fp32 or bf16 elements, 8 or 16 bytes, loaded and stored as
// one access and widened to fp32 in registers, narrowed back with one
// round-to-nearest-even: the accesses of the memory-bound elementwise
// kernels (layernorm.cu, gelu.cu, dropout.cu).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace vt {
namespace vectors {

template <int kBytes> struct RawOf;
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<16> { using type = uint4; };
// N elements of T as one vector register operand
template <typename T, int N>
using Raw = typename RawOf<sizeof(T) * N>::type;

template <typename T, int N>
__device__ __forceinline__ Raw<T, N> load_raw(const T* p) {
  return *reinterpret_cast<const Raw<T, N>*>(p);
}

// the N elements of a raw vector, as fp32
template <typename T, int N>
__device__ __forceinline__ void widen(const Raw<T, N>& r, float* v) {
  if constexpr (sizeof(T) == 4) {
    const float* f = reinterpret_cast<const float*>(&r);
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = f[e];
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      const float2 t = __bfloat1622float2(h[e]);
      v[2 * e] = t.x;
      v[2 * e + 1] = t.y;
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  Raw<T, N> r;
  if constexpr (sizeof(T) == 4) {
    float* f = reinterpret_cast<float*>(&r);
#pragma unroll
    for (int e = 0; e < N; ++e) f[e] = v[e];
  } else {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  }
  *reinterpret_cast<Raw<T, N>*>(p) = r;
}

// the elements of a 16-byte vector of T
template <typename T>
constexpr int kPerVec = 16 / sizeof(T);

// one element of T as fp32, for the scalar tail past the last whole vector;
// round: to T and back, with one round-to-nearest-even
template <typename T> struct Elt;
template <> struct Elt<float> {
  static __device__ float load(const float* p) { return *p; }
  static __device__ float round(float v) { return v; }
  static __device__ void store(float* p, float v) { *p = v; }
};
template <> struct Elt<__nv_bfloat16> {
  static __device__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  static __device__ float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
  static __device__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
};

// blocks of kThreads threads, kVecs 16-byte vectors a thread, covering n
// elements of T; at least one, for the scalar tail
template <typename T, int kThreads, int kVecs>
unsigned int blocks_for(int64_t n) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * kVecs * kPerVec<T>;
  const int64_t blocks = (n + per_block - 1) / per_block;
  return static_cast<unsigned int>(blocks > 0 ? blocks : 1);
}

}  // namespace vectors
}  // namespace vt
