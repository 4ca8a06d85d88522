// The rational gelu's forward and custom derivative for Hopper (sm_90a).
//
// Replaces no TPU kernel: vilbert_tpu/models/layers.py::gelu_rational is
// plain jnp, which XLA fuses into one pass over the activation. On the card
// the same arithmetic in eager PyTorch (ops/gelu.py::gelu_rational_ref and
// gelu_rational_bwd_ref) runs about 22 launches forward and 20 backward,
// each a pass over an fp32 copy of the FFN activation. These two kernels
// each make one pass: read x (and dy), compute in fp32 registers, write
// once in x's dtype.
//
// The arithmetic is the plain chain's, operation for operation and in its
// order, each operation rounded to fp32 as an eager kernel rounds it:
// __fmul_rn, __fadd_rn and __fdiv_rn, which nvcc never contracts into a
// fused multiply-add. So each kernel is bit-equal to the plain chain run on
// the card (chip_smoke.py checks every bf16 pattern):
//   forward  z = clamp(x * sqrt(1/2), +-3.2), u = z * z,
//            erf = (z * P(u)) / Q(u), y = (0.5 * x) * (erf + 1);
//   backward s = clamp(x, +-5), u = s * s,
//            dgelu = (s * DP(u)) / DQ(u) + 0.5,
//            dx = round(round(dgelu) * dy), rounding to x's dtype;
// each polynomial by Horner's rule from its highest coefficient, a
// multiply then an add a step. The coefficients are ops/gelu.py's, written
// out in full (tests/test_torch_ops.py holds each literal to them).
//
// What bounds it on the H100: bytes. A bf16 element takes 4 bytes forward
// (x in, y out) and 6 backward (x and dy in, dx out) against about 30 fp32
// operations, one of them a correctly rounded division, so the forward sits
// near the line where the CUDA cores' rate would bound it too. The design:
// - every access is a 16-byte vector (8 bf16 or 4 fp32, vectors.cuh),
//   neighbouring threads on neighbouring vectors;
// - a thread issues the loads of its kVecs vectors before it computes any,
//   so that each thread has that many requests to device memory in flight;
// - the grid covers the tensor once, a block of kThreads threads to every
//   kThreads * kVecs vectors, sized from n: tens of thousands of blocks at
//   the paths' largest activations keep every SM's warps loaded;
// - the n % (elements a vector) elements past the last whole vector take
//   one scalar pass in the first block's first threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vectors.cuh"

namespace {

using namespace vt::vectors;

// erf(z) ~ z P(z^2) / Q(z^2) on |z| <= kErfClamp (ops/gelu.py _ERF_P, _ERF_Q)
constexpr float kSqrtHalf = 0.7071067811865476f;
constexpr float kErfClamp = 3.2f;
constexpr float kErfP0 = 1.1283621227654328f;
constexpr float kErfP1 = 0.15780611964408517f;
constexpr float kErfP2 = 0.043127602475218844f;
constexpr float kErfP3 = 0.0007360894735171213f;
constexpr float kErfQ0 = 1.0f;
constexpr float kErfQ1 = 0.47307127867236537f;
constexpr float kErfQ2 = 0.09602493287758253f;
constexpr float kErfQ3 = 0.009191308867243501f;
// gelu'(x) ~ 0.5 + s DP(s^2) / DQ(s^2), s = x on |x| <= kDgeluClamp
// (ops/gelu.py _DGELU_P, _DGELU_Q)
constexpr float kDgeluClamp = 5.0f;
constexpr float kDgeluP0 = 0.7986929677932244f;
constexpr float kDgeluP1 = -0.03807846651247695f;
constexpr float kDgeluP2 = 0.015090213881573151f;
constexpr float kDgeluP3 = 0.00019122776191594145f;
constexpr float kDgeluQ0 = 1.0f;
constexpr float kDgeluQ1 = 0.2926936920714664f;
constexpr float kDgeluQ2 = 0.03245537653061185f;
constexpr float kDgeluQ3 = 0.006019591148099333f;

constexpr int kThreads = 256;
constexpr int kVecs = 2;  // 16-byte vectors a thread

// c0 + u (c1 + u (c2 + u c3)), rounded after every operation
__device__ __forceinline__ float horner(float c0, float c1, float c2, float c3, float u) {
  float acc = __fadd_rn(__fmul_rn(c3, u), c2);
  acc = __fadd_rn(__fmul_rn(acc, u), c1);
  return __fadd_rn(__fmul_rn(acc, u), c0);
}

// torch.clamp(v, -lim, lim): NaN stays NaN
__device__ __forceinline__ float clamp_nan(float v, float lim) {
  return isnan(v) ? v : fminf(fmaxf(v, -lim), lim);
}

__device__ __forceinline__ float gelu_fwd(float x) {
  // a NaN x clamps to a bound here, unlike in torch.clamp, and 0.5 * x
  // still makes y NaN: the forward, nearer the CUDA cores' bound, skips the test
  const float z = fminf(fmaxf(__fmul_rn(x, kSqrtHalf), -kErfClamp), kErfClamp);
  const float u = __fmul_rn(z, z);
  const float erf_z = __fdiv_rn(__fmul_rn(z, horner(kErfP0, kErfP1, kErfP2, kErfP3, u)),
                                horner(kErfQ0, kErfQ1, kErfQ2, kErfQ3, u));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(erf_z, 1.0f));
}

__device__ __forceinline__ float dgelu(float x) {
  const float s = clamp_nan(x, kDgeluClamp);
  const float u = __fmul_rn(s, s);
  return __fadd_rn(__fdiv_rn(__fmul_rn(s, horner(kDgeluP0, kDgeluP1, kDgeluP2, kDgeluP3, u)),
                             horner(kDgeluQ0, kDgeluQ1, kDgeluQ2, kDgeluQ3, u)),
                   0.5f);
}

// y = gelu_rational(x) over n elements
template <typename T>
__global__ void __launch_bounds__(kThreads)
gelu_rational_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n) {
  constexpr int kN = kPerVec<T>;
  const int64_t vecs = n / kN;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads * kVecs + threadIdx.x;
  Raw<T, kN> xr[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int64_t i = first + j * kThreads;
    if (i < vecs) xr[j] = load_raw<T, kN>(x + i * kN);
  }
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int64_t i = first + j * kThreads;
    if (i < vecs) {
      float v[kN];
      widen<T, kN>(xr[j], v);
#pragma unroll
      for (int e = 0; e < kN; ++e) v[e] = gelu_fwd(v[e]);
      store_vec<T, kN>(y + i * kN, v);
    }
  }
  const int64_t tail = vecs * kN + threadIdx.x;
  if (blockIdx.x == 0 && tail < n) Elt<T>::store(y + tail, gelu_fwd(Elt<T>::load(x + tail)));
}

// dx = (dgelu(x) rounded to T) * dy, rounded to T, over n elements
template <typename T>
__global__ void __launch_bounds__(kThreads)
gelu_rational_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         T* __restrict__ dx, int64_t n) {
  constexpr int kN = kPerVec<T>;
  const int64_t vecs = n / kN;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads * kVecs + threadIdx.x;
  Raw<T, kN> xr[kVecs], gr[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int64_t i = first + j * kThreads;
    if (i < vecs) {
      xr[j] = load_raw<T, kN>(x + i * kN);
      gr[j] = load_raw<T, kN>(dy + i * kN);
    }
  }
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int64_t i = first + j * kThreads;
    if (i < vecs) {
      float v[kN], g[kN];
      widen<T, kN>(xr[j], v);
      widen<T, kN>(gr[j], g);
#pragma unroll
      for (int e = 0; e < kN; ++e) v[e] = __fmul_rn(Elt<T>::round(dgelu(v[e])), g[e]);
      store_vec<T, kN>(dx + i * kN, v);
    }
  }
  const int64_t tail = vecs * kN + threadIdx.x;
  if (blockIdx.x == 0 && tail < n) {
    Elt<T>::store(dx + tail, __fmul_rn(Elt<T>::round(dgelu(Elt<T>::load(x + tail))),
                                       Elt<T>::load(dy + tail)));
  }
}

template <typename T>
cudaError_t launch_fwd(const void* x, void* y, int64_t n, cudaStream_t stream) {
  gelu_rational_fwd_kernel<T><<<blocks_for<T, kThreads, kVecs>(n), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, void* dx, int64_t n,
                       cudaStream_t stream) {
  gelu_rational_bwd_kernel<T><<<blocks_for<T, kThreads, kVecs>(n), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), n);
  return cudaGetLastError();
}

}  // namespace

// dtype (every operand): 0 = float32, 1 = bfloat16. n elements, n >= 0;
// every pointer 16-byte aligned (the Python wrapper checks this first).
// Each returns a cudaError_t.
extern "C" int vt_gelu_rational_fwd(const void* x, void* out, int dtype, long long n,
                                    void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_fwd<float>(x, out, n, s);
  if (dtype == 1) return (int)launch_fwd<__nv_bfloat16>(x, out, n, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int vt_gelu_rational_bwd(const void* x, const void* dy, void* dx, int dtype,
                                    long long n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_bwd<float>(x, dy, dx, n, s);
  if (dtype == 1) return (int)launch_bwd<__nv_bfloat16>(x, dy, dx, n, s);
  return (int)cudaErrorInvalidValue;
}
