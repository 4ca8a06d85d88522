// The hidden-state counter-hash dropout for Hopper (sm_90a), forward and
// backward.
//
// Replaces no TPU kernel: vilbert_tpu/ops/dropout.py::hash_dropout is plain
// jnp, which XLA fuses into one pass. Eager PyTorch has no uint32 shift, so
// the plain version (ops/dropout.py::hash_keep_mask and hash_dropout_ref)
// emulates the uint32 hash in int64: about 27 passes over an int64 tensor
// of the activation's size to build the mask, then where / div, ~30
// launches a site forward and a saved boolean mask for the backward. These
// kernels hash each element's flat index in uint32 registers
// (keep_mask.cuh::hidden_keep, the attention kernels' finalizer) and make
// one pass each:
//   forward   y  = keep(i) ? x / divisor : 0
//   backward  dx = keep(i) ? g / divisor : 0  (the mask recomputed, none saved)
// with i = (flat index + offset) mod 2^32, the hash's seed term
// seed * 0x27D4EB2F mod 2^32, the keep threshold and the divisor (1 - rate
// in the operand's dtype) all computed on the host. The division is a true
// one, __fdiv_rn on fp32 operands, then one round-to-nearest-even to bf16:
// what PyTorch's CUDA div of two bf16 (fp32) tensors computes, so both
// kernels are bit-equal to the eager chain run on the card (chip_smoke.py
// checks every bf16 pattern). A product by the reciprocal rounds otherwise.
// A dropped NaN or inf gives +0, as torch.where does.
//
// What bounds it on the H100: bytes, barely. A bf16 element takes 4 bytes
// (one read, one write) against ~12 integer operations of the hash and a
// correctly rounded division, so the CUDA cores' issue rate sits close
// behind the memory's. The design is gelu.cu's:
// - every access is a 16-byte vector (8 bf16 or 4 fp32, vectors.cuh),
//   neighbouring threads on neighbouring vectors;
// - a thread issues the loads of its kVecs vectors before it hashes any;
// - the grid covers the tensor once, a block of kThreads threads to every
//   kThreads * kVecs vectors;
// - the n % (elements a vector) elements past the last whole vector take
//   one scalar pass in the first block's first threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "keep_mask.cuh"
#include "vectors.cuh"

namespace {

using namespace vt::vectors;

constexpr int kThreads = 256;
constexpr int kVecs = 2;  // 16-byte vectors a thread

// the mask and its scaling: what both kernels compute
struct Mask {
  uint32_t offset;     // flat index of element 0, mod 2^32
  uint32_t seed_term;  // seed * 0x27D4EB2F mod 2^32
  uint32_t threshold;  // keep where hash >= threshold
  float divisor;       // 1 - rate, rounded to the operand's dtype

  __device__ __forceinline__ float apply(uint32_t index, float v) const {
    return vt::hidden_keep(index + offset, seed_term, threshold) ? __fdiv_rn(v, divisor) : 0.f;
  }
};

// out = mask(in) over n elements
template <typename T>
__device__ __forceinline__ void dropout_pass(const T* __restrict__ in, T* __restrict__ out,
                                             int64_t n, const Mask& m) {
  constexpr int kN = kPerVec<T>;
  const int64_t vecs = n / kN;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads * kVecs + threadIdx.x;
  Raw<T, kN> r[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int64_t i = first + j * kThreads;
    if (i < vecs) r[j] = load_raw<T, kN>(in + i * kN);
  }
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int64_t i = first + j * kThreads;
    if (i < vecs) {
      float v[kN];
      widen<T, kN>(r[j], v);
      const uint32_t base = static_cast<uint32_t>(i * kN);  // the flat index mod 2^32
#pragma unroll
      for (int e = 0; e < kN; ++e) v[e] = m.apply(base + e, v[e]);
      store_vec<T, kN>(out + i * kN, v);
    }
  }
  const int64_t tail = vecs * kN + threadIdx.x;
  if (blockIdx.x == 0 && tail < n) {
    Elt<T>::store(out + tail, m.apply(static_cast<uint32_t>(tail), Elt<T>::load(in + tail)));
  }
}

// two names for one pass, so that a trace tells the forward's launches
// from the backward's
template <typename T>
__global__ void __launch_bounds__(kThreads)
hidden_dropout_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n, Mask m) {
  dropout_pass<T>(x, y, n, m);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hidden_dropout_bwd_kernel(const T* __restrict__ g, T* __restrict__ dx, int64_t n, Mask m) {
  dropout_pass<T>(g, dx, n, m);
}

template <typename T>
cudaError_t launch(bool backward, const void* in, void* out, int64_t n, const Mask& m,
                   cudaStream_t stream) {
  const auto* src = static_cast<const T*>(in);
  auto* dst = static_cast<T*>(out);
  const unsigned int blocks = blocks_for<T, kThreads, kVecs>(n);
  if (backward) {
    hidden_dropout_bwd_kernel<T><<<blocks, kThreads, 0, stream>>>(src, dst, n, m);
  } else {
    hidden_dropout_fwd_kernel<T><<<blocks, kThreads, 0, stream>>>(src, dst, n, m);
  }
  return cudaGetLastError();
}

int dispatch(bool backward, const void* in, void* out, int dtype, long long n,
             unsigned int offset, unsigned int seed_term, unsigned int threshold, float divisor,
             void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const Mask m{offset, seed_term, threshold, divisor};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(backward, in, out, n, m, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(backward, in, out, n, m, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (both operands): 0 = float32, 1 = bfloat16. n elements, n >= 0;
// both pointers 16-byte aligned (the Python wrapper checks this first).
// offset, seed_term, threshold: uint32; divisor: 1 - rate in the dtype.
// Each returns a cudaError_t.
extern "C" int vt_hidden_dropout_fwd(const void* x, void* y, int dtype, long long n,
                                     unsigned int offset, unsigned int seed_term,
                                     unsigned int threshold, float divisor, void* stream) {
  return dispatch(false, x, y, dtype, n, offset, seed_term, threshold, divisor, stream);
}

extern "C" int vt_hidden_dropout_bwd(const void* g, void* dx, int dtype, long long n,
                                     unsigned int offset, unsigned int seed_term,
                                     unsigned int threshold, float divisor, void* stream) {
  return dispatch(true, g, dx, dtype, n, offset, seed_term, threshold, divisor, stream);
}
