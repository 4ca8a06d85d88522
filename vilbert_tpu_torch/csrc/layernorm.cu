// LayerNorm(x [+ residual]) forward for Hopper (sm_90a), one warp per row.
//
// Replaces the TPU kernel vilbert_tpu/ops/pallas_layernorm.py::_ln_kernel.
// Same arithmetic: the residual is added in fp32, mean and variance are fp32
// two-pass statistics over the row, eps (1e-12) sits inside the rsqrt, weight
// and bias are fp32, and the output takes x's dtype.
//
// What bounds it on the H100: a handful of flops per element against 2 or 3
// elements read and one written, so device-memory bandwidth alone. The design
// reads every element once with 16-byte (fp32) or 8-byte (bf16) vector loads,
// keeps the row in registers for both statistics passes (H <= kMaxH), reduces
// with warp shuffles only (no shared memory, no block barrier), and writes
// once. Four rows per block of 128 threads; a ragged last block simply has
// idle warps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 4;
constexpr int kVec = 4;                     // elements per vector load
constexpr int kMaxH = 2048;
constexpr int kMaxVecs = kMaxH / (32 * kVec);  // vectors per lane at kMaxH

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&lo);
  t.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = t;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
layer_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                      const float* __restrict__ weight, const float* __restrict__ bias,
                      T* __restrict__ out, int rows, int h, float eps) {
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const int nvec = h / (32 * kVec);
  const T* xr = x + row * h;
  const T* rr = res ? res + row * h : nullptr;

  float vals[kMaxVecs * kVec];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    if (i < nvec) {
      const int col = (i * 32 + lane) * kVec;
      load4(xr + col, &vals[i * kVec]);
      if (rr) {
        float r[kVec];
        load4(rr + col, r);
#pragma unroll
        for (int e = 0; e < kVec; ++e) vals[i * kVec + e] += r[e];
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) sum += vals[i * kVec + e];
    }
  }
  const float mean = warp_sum(sum) / h;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    if (i < nvec) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float d = vals[i * kVec + e] - mean;
        sq += d * d;
      }
    }
  }
  const float inv = rsqrtf(warp_sum(sq) / h + eps);
  T* orow = out + row * h;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    if (i < nvec) {
      const int col = (i * 32 + lane) * kVec;
      float w[kVec], b[kVec], y[kVec];
      load4(weight + col, w);
      load4(bias + col, b);
#pragma unroll
      for (int e = 0; e < kVec; ++e) y[e] = (vals[i * kVec + e] - mean) * inv * w[e] + b[e];
      store4(orow + col, y);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* res, const void* weight, const void* bias,
                   void* out, int rows, int h, float eps, cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  layer_norm_fwd_kernel<T><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<T*>(out), rows, h, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, residual and out); weight and bias are
// float32. residual may be null. h must be a multiple of 128 and at most
// 2048, and every pointer 16-byte aligned (the Python wrapper checks this
// first). Returns a cudaError_t.
extern "C" int vt_layer_norm_fwd(const void* x, const void* residual, const void* weight,
                                 const void* bias, void* out, int dtype, int rows, int h,
                                 float eps, void* stream) {
  if (rows < 1 || h < 32 * kVec || h > kMaxH || h % (32 * kVec) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, residual, weight, bias, out, rows, h, eps, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, residual, weight, bias, out, rows, h, eps, s);
  return (int)cudaErrorInvalidValue;
}

// Message for a cudaError_t returned by the entry points above.
extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
