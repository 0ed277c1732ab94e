// Device functions shared by the walk kernels (walk.cu, walk_ablate.cu): the
// threefry-2x32 hash and the uniform draws of jax.random, bit for bit, the
// error-length lookup in the mixture tables, and the warp-cooperative counts
// of the aligned walk (one warp per read lane).  ops/cuda_build.py counts this
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

// count(row[i] < u) over a NON-DECREASING row of n entries: the index of the
// first entry >= u, found by a branchless binary search (the answer lies in
// [base, base + len] throughout).  The loop runs ceil(log2(n)) times whatever
// u is, so the threads of a warp searching for different u stay together.
// On a row that is not non-decreasing it is not the count.
__device__ __forceinline__ int count_less_sorted(const float* row, int n, float u) {
  if (n <= 0) return 0;
  const float* base = row;
  for (int len = n; len > 1;) {
    const int half = len >> 1;
    base = base[half] < u ? base + half : base;
    len -= half;
  }
  return static_cast<int>(base - row) + (*base < u);
}

// --- warp-cooperative lookups (one warp per read lane) ----------------------
//
// Every table lookup of a walk step is a count of compares.  Split over the
// 32 threads of a warp and summed across it, the count is the same integer
// the serial scan gives, whatever the order of the row.  The rows sit in
// shared memory padded with a value the compare never accepts: +inf for a
// uniform, INT_MAX for a match length.  A short row (the match-length bins),
// padded to a multiple of 32 entries, is counted with one ballot per 32
// entries.  A long row, padded to a multiple of kRowGroup entries, is taken
// kRowGroup entries at a time: thread i loads entries 4i .. 4i + 3 of the
// group with one 16-byte load (a warp reads 512 contiguous bytes, no bank
// conflict) and counts its share, and the caller sums the shares with one
// __reduce_add_sync after the last group, so the loads of every group are in
// flight together.  All threads of the warp must call these together, with
// the same row and the same value.

constexpr unsigned kFullWarp = 0xFFFFFFFFu;
constexpr int kRowGroup = 128;  // entries of a long row a warp reads at once

__device__ __forceinline__ int round_up_warp(int n) { return (n + 31) & ~31; }
__device__ __host__ __forceinline__ int round_up_group(int n) {
  return (n + kRowGroup - 1) / kRowGroup * kRowGroup;
}

// count(row[i] <= u) over a row padded to n_pad entries (a multiple of 32)
template <typename V>
__device__ __forceinline__ int warp_count_le(const V* row, int n_pad, V u, int lane) {
  int cnt = 0;
  for (int i0 = 0; i0 < n_pad; i0 += 32)
    cnt += __popc(__ballot_sync(kFullWarp, row[i0 + lane] <= u));
  return cnt;
}

// this thread's share of count(row[i] < u) over group g of a long row (16-byte aligned)
__device__ __forceinline__ int share_less(const float* row, int g, float u, int lane) {
  const float4 v = reinterpret_cast<const float4*>(row)[g * (kRowGroup / 4) + lane];
  return (v.x < u) + (v.y < u) + (v.z < u) + (v.w < u);
}

// this thread's share of count(row[i] <= u) over group g of a long row (16-byte aligned)
__device__ __forceinline__ int share_le(const float* row, int g, float u, int lane) {
  const float4 v = reinterpret_cast<const float4*>(row)[g * (kRowGroup / 4) + lane];
  return (v.x <= u) + (v.y <= u) + (v.z <= u) + (v.w <= u);
}

}  // namespace walk_common
