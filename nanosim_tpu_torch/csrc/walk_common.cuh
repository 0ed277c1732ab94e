// Device functions shared by the walk kernels (walk.cu, walk_ablate.cu): the
// threefry-2x32 hash and the uniform draws of jax.random, bit for bit, and the
// error-length lookup in the mixture tables.  ops/cuda_build.py counts this
// header as a source of every .cu that includes it.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace walk_common {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds: bit-identical to jax.random's threefry2x32.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0,
                                             uint32_t x1, uint32_t& y0, uint32_t& y1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl32(x1, r); \
  x1 ^= x0;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef TF_ROUND
  y0 = x0;
  y1 = x1;
}

// jax.random.uniform's float32 construction from 32 random bits.
__device__ __forceinline__ float bits_to_uniform(uint32_t b) {
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

// Draw j of uniform(fold_in(key, t), (n,)): counter (0, j) under the folded key.
__device__ __forceinline__ void fold(uint32_t k0, uint32_t k1, uint32_t t, uint32_t& f0,
                                     uint32_t& f1) {
  threefry2x32(k0, k1, 0u, t, f0, f1);
}

__device__ __forceinline__ float draw(uint32_t f0, uint32_t f1, uint32_t j) {
  uint32_t y0, y1;
  threefry2x32(f0, f1, 0u, j, y0, y1);
  return bits_to_uniform(y0 ^ y1);
}

// 1 + count(cdf[row] < u): an error length from the mixture tables.
__device__ __forceinline__ int mixture_len(const float* s_cdf, int n_t, int row, float u) {
  const float* r = s_cdf + row * n_t;
  int cnt = 0;
  for (int i = 0; i < n_t; ++i) cnt += (r[i] < u);
  return 1 + cnt;
}

}  // namespace walk_common
