// LayerNorm(x [+ residual]) forward for Hopper (sm_90a): K4.
//
// Replaces the TPU kernel vilbert_tpu/ops/pallas_layernorm.py:28 _ln_kernel,
// with the same arithmetic: the residual is added in fp32; the mean first,
// then the mean of the squared deviations, both over values held in
// registers (two passes, never a sum and a sum of squares); eps (1e-12)
// inside the rsqrt; weight and bias widened to fp32; one rounding to x's
// dtype. Weight and bias are fp32 or bf16 (a template parameter: the bf16
// ones are what a step that differentiates with respect to bf16 copies of
// the parameters hands in); a thread widens its share once, in registers.
//
// What bounds it on the H100: a few flops per element against two or three
// elements read and one written, so device-memory bytes alone. The design:
// - the kernel is templated on H, and a row is split over H / (32 * vector)
//   warps of one block, one vector a thread: a thread holds 4 or 8 values,
//   32 registers, so an SM holds 64 warps and their loads in flight;
// - every access is a 16-byte vector (4 fp32 or 8 bf16) but for bf16 rows
//   whose H is a multiple of 128 and not of 256, which take 8-byte vectors
//   so that the row splits into whole warps; neighbouring threads read
//   neighbouring vectors;
// - each element is read once and written once; a thread issues its loads
//   of x, the residual, the weight and the bias before the statistics, and
//   the warps' partial sums meet in shared memory (two barriers a row);
// - two variants, picked in Python by row count
//   (ops/layernorm.py::ln_variant, crossovers measured on the card):
//   "block": one row a block. Few rows, where every row should be in flight
//   at once, and very many, where 32 registers a thread keep the most
//   loads in flight.
//   "persistent": as many blocks as the card holds at once, each striding
//   over the rows with the weight and bias kept in registers; a thread
//   loads its share of the next row before it reduces the current one, so
//   the loads of one row overlap the barriers of the other. Between the
//   two, from about a thousand to about fourteen thousand rows, where one
//   row a block leaves SMs waiting on their rows' single round trip.
// Sums are taken in a fixed order: a thread's elements in column order, a
// butterfly over the 32 lanes of its warp, then the warps of the row in
// order (tests/test_torch_ops.py emulates it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vectors.cuh"

namespace {

using namespace vt::vectors;

constexpr int kMaxH = 2048;

template <typename T, int H>
struct Row {
  static constexpr int kVec = (sizeof(T) == 2 && H % 256 == 0) ? 8 : 4;  // elements a vector
  static constexpr int kWarps = H / kVec / 32;                            // one vector a thread
  static_assert(H % 128 == 0 && kWarps * 32 * kVec == H, "H must be a multiple of 128");
};

// N weight or bias values of type W (N a multiple of 4) as fp32: fp32 in
// 16-byte loads, bf16 in one 8- or 16-byte load widened in registers
template <typename W, int N>
__device__ __forceinline__ void load_param(const W* p, float* v) {
  if constexpr (sizeof(W) == 4) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float4 t = reinterpret_cast<const float4*>(p)[j];
      v[4 * j] = t.x; v[4 * j + 1] = t.y; v[4 * j + 2] = t.z; v[4 * j + 3] = t.w;
    }
  } else {
    widen<W, N>(load_raw<W, N>(p), v);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The sum over the kWarps warps of a block, the same in every thread;
// `slots` holds kWarps floats of shared memory.
template <int kWarps>
__device__ __forceinline__ float block_sum(float s, float* slots) {
  s = warp_sum(s);
  if constexpr (kWarps == 1) {
    return s;
  } else {
    if (threadIdx.x % 32 == 0) slots[threadIdx.x / 32] = s;
    __syncthreads();
    float total = slots[0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) total += slots[k];
    return total;
  }
}

// Row blockIdx.x ("block"), or rows blockIdx.x, + gridDim.x, ...
// ("persistent"), one vector a thread: thread t holds columns
// [t * kVec, (t + 1) * kVec). The grid has at most `rows` blocks.
template <typename T, typename W, int H, bool kPersistent>
__global__ void __launch_bounds__(32 * Row<T, H>::kWarps)
layer_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                      const W* __restrict__ weight, const W* __restrict__ bias,
                      T* __restrict__ out, int rows, float eps) {
  constexpr int kVec = Row<T, H>::kVec;
  constexpr int kWarps = Row<T, H>::kWarps;
  // slots[1] is written only after the barrier that slots[0] is read behind,
  // and slots[0] again only after the next: two barriers a row suffice
  __shared__ float slots[2][kWarps];

  const int col = threadIdx.x * kVec;
  int64_t row = blockIdx.x;
  Raw<T, kVec> xv, rv;
  xv = load_raw<T, kVec>(x + row * H + col);
  if (res) rv = load_raw<T, kVec>(res + row * H + col);
  float w[kVec], b[kVec];
  load_param<W, kVec>(weight + col, w);
  load_param<W, kVec>(bias + col, b);

  while (true) {
    float v[kVec];
    widen<T, kVec>(xv, v);
    if (res) {
      float r[kVec];
      widen<T, kVec>(rv, r);
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] += r[e];
    }
    const int64_t next = row + gridDim.x;
    if (kPersistent && next < rows) {
      xv = load_raw<T, kVec>(x + next * H + col);
      if (res) rv = load_raw<T, kVec>(res + next * H + col);
    }
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) sum += v[e];
    const float mean = block_sum<kWarps>(sum, slots[0]) / H;
    float sq = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float d = v[e] - mean;
      sq += d * d;
    }
    const float inv = rsqrtf(block_sum<kWarps>(sq, slots[1]) / H + eps);
    float y[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) y[e] = (v[e] - mean) * inv * w[e] + b[e];
    store_vec<T, kVec>(out + row * H + col, y);
    if (!kPersistent || next >= rows) break;
    row = next;
  }
}

struct Args {
  const void *x, *res, *weight, *bias;
  void* out;
  int rows;
  float eps;
  cudaStream_t stream;
};

// blocks of `threads` threads of `kernel` that the current card holds at once
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return sms * per_sm;
}

template <typename T, typename W, int H, bool kPersistent>
cudaError_t launch(const Args& a) {
  constexpr int kThreads = 32 * Row<T, H>::kWarps;
  const auto kernel = layer_norm_fwd_kernel<T, W, H, kPersistent>;
  int blocks = a.rows;
  if constexpr (kPersistent) {
    static const int resident = resident_blocks(kernel, kThreads);
    if (resident < 1) return cudaErrorLaunchOutOfResources;
    blocks = blocks < resident ? blocks : resident;
  }
  kernel<<<blocks, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.res),
      static_cast<const W*>(a.weight), static_cast<const W*>(a.bias),
      static_cast<T*>(a.out), a.rows, a.eps);
  return cudaGetLastError();
}

// the instantiation for H = 128 * K (K = 1 .. kMaxH / 128)
template <typename T, typename W, bool kPersistent, int K = 1>
cudaError_t launch_h(int h, const Args& a) {
  if constexpr (K * 128 > kMaxH) {
    return cudaErrorInvalidValue;
  } else {
    if (h != K * 128) return launch_h<T, W, kPersistent, K + 1>(h, a);
    return launch<T, W, K * 128, kPersistent>(a);
  }
}

template <typename T, bool kPersistent>
cudaError_t launch_w(int wdtype, int h, const Args& a) {
  if (wdtype == 0) return launch_h<T, float, kPersistent>(h, a);
  if (wdtype == 1) return launch_h<T, __nv_bfloat16, kPersistent>(h, a);
  return cudaErrorInvalidValue;
}

template <bool kPersistent>
int layer_norm_fwd(const void* x, const void* residual, const void* weight, const void* bias,
                   void* out, int dtype, int wdtype, int rows, int h, float eps,
                   void* stream) {
  if (rows < 1 || h < 128 || h > kMaxH || h % 128 != 0) return (int)cudaErrorInvalidValue;
  const Args a{x, residual, weight, bias, out, rows, eps, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)launch_w<float, kPersistent>(wdtype, h, a);
  if (dtype == 1) return (int)launch_w<__nv_bfloat16, kPersistent>(wdtype, h, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The two variants, one entry point each. dtype (x, residual and out) and
// wdtype (weight and bias): 0 = float32, 1 = bfloat16. residual may be null.
// h must be a multiple of 128 and at most 2048, and every pointer 16-byte
// aligned (the Python wrapper checks this first). Returns a cudaError_t.
extern "C" int vt_layer_norm_fwd_block(const void* x, const void* residual, const void* weight,
                                       const void* bias, void* out, int dtype, int wdtype,
                                       int rows, int h, float eps, void* stream) {
  return layer_norm_fwd<false>(x, residual, weight, bias, out, dtype, wdtype, rows, h, eps,
                               stream);
}

extern "C" int vt_layer_norm_fwd_persistent(const void* x, const void* residual,
                                            const void* weight, const void* bias, void* out,
                                            int dtype, int wdtype, int rows, int h, float eps,
                                            void* stream) {
  return layer_norm_fwd<true>(x, residual, weight, bias, out, dtype, wdtype, rows, h, eps,
                              stream);
}

// Message for a cudaError_t returned by the entry points of this library.
extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
