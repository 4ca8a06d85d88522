// The attention-probability dropout mask of the TPU attention kernels,
// vilbert_tpu/ops/pallas_attention_train.py::_keep_mask, for one element:
// a murmur3-finalizer hash of (query row, key column, tile seed), kept where
// hash >= threshold. All arithmetic is uint32 and wraps, as it does there:
//   x = row * C1 ^ (col + C2) * C3 ^ seed * C4   (XOR of three products)
// The tile seed of (batch b, head h) is seed + (b * heads + h) * 7919 mod
// 2^32 (the int32 wrap of _fwd_kernel:73). Shared by the forward
// (attention.cu) and backward (attention_bwd.cu) kernels, which therefore
// regenerate the identical mask instead of storing it.

#pragma once

#include <stdint.h>

namespace vt {

__device__ __forceinline__ uint32_t tile_seed(uint32_t seed, int64_t bh) {
  return seed + (uint32_t)bh * 7919u;
}

__device__ __forceinline__ bool keep(uint32_t row, uint32_t col, uint32_t tile_seed,
                                     uint32_t threshold) {
  uint32_t x = (row * 0x9E3779B1u) ^ ((col + 0x7F4A7C15u) * 0x85EBCA77u) ^
               (tile_seed * 0x27D4EB2Fu);
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= threshold;
}

}  // namespace vt
