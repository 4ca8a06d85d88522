// The counter-hash dropout masks of the JAX package, for one element each:
// the murmur3 finalizer (vilbert_tpu/ops/dropout.py:29-35) of a counter
// mixed with the seed, kept where hash >= threshold. All arithmetic is
// uint32 and wraps, as it does there. One copy of the constants serves
// both kinds of site:
// - the attention probabilities (pallas_attention_train.py::_keep_mask):
//     x = row * kGolden ^ (col + kColAdd) * kColMul ^ tile_seed * kSeedMul,
//   with the tile seed of (batch b, head h) seed + (b * heads + h) * 7919
//   mod 2^32 (the int32 wrap of _fwd_kernel:73). The forward
//   (attention.cu, attention_fwd_wg.cu) and backward (attention_bwd.cu,
//   attention_bwd_wg.cu) kernels regenerate the identical mask instead of
//   storing it;
// - the hidden states (ops/dropout.py::hash_keep_mask):
//     x = index * kGolden ^ seed * kSeedMul,
//   over the flat element index (dropout.cu, forward and backward alike).

#pragma once

#include <stdint.h>

namespace vt {

constexpr uint32_t kGolden = 0x9E3779B1u;  // row / flat-index multiplier
constexpr uint32_t kSeedMul = 0x27D4EB2Fu;
constexpr uint32_t kColAdd = 0x7F4A7C15u;
constexpr uint32_t kColMul = 0x85EBCA77u;

__device__ __forceinline__ uint32_t murmur_mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t tile_seed(uint32_t seed, int64_t bh) {
  return seed + (uint32_t)bh * 7919u;
}

// the attention-probability mask at (query row, key column) of a tile
__device__ __forceinline__ bool keep(uint32_t row, uint32_t col, uint32_t tile_seed,
                                     uint32_t threshold) {
  return murmur_mix((row * kGolden) ^ ((col + kColAdd) * kColMul) ^ (tile_seed * kSeedMul)) >=
         threshold;
}

// the hidden-state mask at a flat index; seed_term = seed * kSeedMul, which
// the caller computes once
__device__ __forceinline__ bool hidden_keep(uint32_t index, uint32_t seed_term,
                                            uint32_t threshold) {
  return murmur_mix((index * kGolden) ^ seed_term) >= threshold;
}

}  // namespace vt
