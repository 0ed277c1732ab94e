// The counter-based draws of ops/rng.py, each public draw as one launch.
//
// ops/rng.py defines the draws of every batch program: a key is a pair of
// 32-bit words, a fold is threefry(key, (0, data)), and draw j of a key is
// threefry(key, (0, j)) turned into bits, a float32 uniform, two 16-bit
// uniforms or a float64 uniform.  Its plain version runs the hash as int64
// torch ops (each word masked to 32 bits after every operation), about 170
// device ops a call.  The kernels here compute the same words with native
// uint32 arithmetic, walk_common.cuh's threefry2x32 and bits_to_uniform (the
// ones K1 and K2 draw their steps with), and write exactly the dtype and
// bits the plain version writes:
//
//   fold_kernel   out[e] = threefry(keys[e], (0, data[e] + add))  -> [..., 2] int64
//   draw_kernel   out[b, j] = f(threefry(key_b, (0, c)))          -> [B, n]
//                 key_b the row's key, folded with the site first where the
//                 draw is per slot; c = j, or pos[b, j] (clamped to [0, hi]
//                 where asked); f one of the four constructions (kBits ..).
//
// It replaces no TPU kernel: the JAX package draws with jax.random, whose
// threefry XLA fuses into the jitted batch program.  The port runs eagerly,
// so without this file each hash is ~170 launches of int64 elementwise
// kernels, and the [B, l_out] draws of the read-emitting program write
// int64 intermediates of 8 bytes an element per operation.
//
// What bounds it on an H100: integer operations.  A hash is 20 rounds of
// add, rotate and xor (60 integer operations) plus five key injections, for
// at most 8 bytes written a draw, so at the read-emitting shape (B = 2,048,
// n = 19,456) it is at least 0.143 ms of integer work against 0.048 ms of
// stores.
// Each thread takes 4 consecutive draws of one row: the row's key is loaded
// once and, for a per-slot draw, folded once for the 4 draws (a fold costs a
// fifth of a thread's hashes); the 4 hashes are independent, so their
// rounds interleave; the rotations compile to funnel shifts (SHF.L.W).  The
// 4 results go out as 16-byte stores where the 4 lie in the row and the
// address is 16-byte aligned, by scalar stores at a ragged row's edges.
// The grid is 1-D over the groups of 4, at most kWaves waves of blocks with
// a grid-stride loop beyond that, so a [512]-lane draw is two blocks and a
// [2,048 x 19,456] one a few waves.  Nothing is allocated and nothing
// synchronises: the launchers run on the stream they are given and return
// cudaGetLastError().
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W) at B = 2,048, n = 19,456:
// 0.165 ms on the device for the float32 uniforms, 86.5% of the 60-operation
// bound (nvcc issues part of the adds as IMAD on the float pipe), against
// 44 ms in 351 launches for the int64 torch version; a [512]-lane draw takes
// 1.4-1.8 us on the device and 14-29 us of host time a call (PERF.md).
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (no PyTorch headers), bound with ctypes by ops/draw_cuda.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

using walk_common::bits_to_uniform;
using walk_common::threefry2x32;

constexpr int kThreads = 256;
constexpr int kWaves = 4;  // blocks in flight: at most this many full waves
constexpr int kPer = 4;    // draws a thread

// the constructions of a draw from its hash words (y0, y1), as ops/rng.py
enum Kind : int {
  kBits = 0,      // y0 ^ y1 as int64 (bits_at, bits_per_slot)
  kUniform = 1,   // float32 uniform of y0 ^ y1 (uniform, uniform_per_slot, uniform_at)
  kUniform2 = 2,  // two float32 uniforms of its low and high 16 bits (uniform2_per_slot)
  kUniformF64 = 3 // float64 uniform of (y0 << 20) | (y1 >> 12) (uniform_f64)
};

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

unsigned grid_for(int64_t work) {
  const int64_t cap = static_cast<int64_t>(sm_count()) * (2048 / kThreads) * kWaves;
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// --- fold_kernel ----------------------------------------------------------
//
// out[r, c] = threefry(keys[r, c], (0, data[r, c] + add)) over a broadcast
// [R, C] grid: the keys and the data are read through element strides (0
// for a broadcast dimension), so an expanded view is never materialised.
// D is the data's element type; without data the counter word is `add`.
template <typename D>
__global__ void __launch_bounds__(kThreads) fold_kernel(
    const uint32_t* __restrict__ keys, int64_t k_r, int64_t k_c, int64_t k_w,
    const D* __restrict__ data, int64_t d_r, int64_t d_c, uint32_t add, int64_t R, int64_t C,
    longlong2* __restrict__ out) {
  const int64_t N = R * C;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; e < N; e += stride) {
    const int64_t r = C == 1 ? e : e / C;
    const int64_t c = e - r * C;
    const uint32_t* k = keys + 2 * (r * k_r + c * k_c);  // the low word of each int64
    uint32_t x1 = add;
    if (data != nullptr) x1 += static_cast<uint32_t>(__ldg(data + r * d_r + c * d_c));
    uint32_t y0, y1;
    threefry2x32(__ldg(k), __ldg(k + 2 * k_w), 0u, x1, y0, y1);
    out[e] = make_longlong2(static_cast<long long>(y0), static_cast<long long>(y1));
  }
}

// --- draw_kernel ----------------------------------------------------------

// the 4 counters of a thread's draws from a position row: p points at
// position j0 of the row, cnt of the 4 lie in it
template <typename P>
__device__ __forceinline__ void load_positions(const P* __restrict__ p, int cnt, bool clamp,
                                               int64_t hi, uint32_t (&ctr)[kPer]) {
  long long v[kPer] = {0, 0, 0, 0};
  if (cnt == kPer && aligned16(p)) {
    if constexpr (sizeof(P) == 4) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(p));
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    } else {
      const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p));
      const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p) + 1);
      v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if (e < cnt) v[e] = static_cast<long long>(__ldg(p + e));
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    long long x = v[e];
    if (clamp) {  // torch.clamp(0, hi): the lower bound first, then the upper
      x = x < 0 ? 0 : x;
      x = x > hi ? hi : x;
    }
    ctr[e] = static_cast<uint32_t>(x);  // pos & MASK32
  }
}

template <int K>
__device__ __forceinline__ void store_draws(void* __restrict__ out0, void* __restrict__ out1,
                                            int64_t flat, int cnt, const uint32_t (&y0)[kPer],
                                            const uint32_t (&y1)[kPer]) {
  if constexpr (K == kBits) {
    int64_t* o = static_cast<int64_t*>(out0) + flat;
    int64_t v[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) v[e] = static_cast<int64_t>(y0[e] ^ y1[e]);
    if (cnt == kPer && aligned16(o)) {
      reinterpret_cast<longlong2*>(o)[0] = make_longlong2(v[0], v[1]);
      reinterpret_cast<longlong2*>(o)[1] = make_longlong2(v[2], v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        if (e < cnt) o[e] = v[e];
    }
  } else if constexpr (K == kUniform) {
    float* o = static_cast<float*>(out0) + flat;
    float v[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) v[e] = bits_to_uniform(y0[e] ^ y1[e]);
    if (cnt == kPer && aligned16(o)) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        if (e < cnt) o[e] = v[e];
    }
  } else if constexpr (K == kUniform2) {
    // (bits & 0xFFFF) and (bits >> 16) are exact in float32, and the
    // factor 2**-16 is exact: the plain version's products, bit for bit
    float* lo = static_cast<float*>(out0) + flat;
    float* hi = static_cast<float*>(out1) + flat;
    float a[kPer], b[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const uint32_t bits = y0[e] ^ y1[e];
      a[e] = __uint2float_rn(bits & 0xFFFFu) * (1.0f / 65536.0f);
      b[e] = __uint2float_rn(bits >> 16) * (1.0f / 65536.0f);
    }
    if (cnt == kPer && aligned16(lo) && aligned16(hi)) {
      *reinterpret_cast<float4*>(lo) = make_float4(a[0], a[1], a[2], a[3]);
      *reinterpret_cast<float4*>(hi) = make_float4(b[0], b[1], b[2], b[3]);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        if (e < cnt) {
          lo[e] = a[e];
          hi[e] = b[e];
        }
    }
  } else {  // kUniformF64: the top 52 of the 64 bits (y0 << 32) | y1 as the mantissa
    double* o = static_cast<double*>(out0) + flat;
    double v[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const uint64_t mant = (static_cast<uint64_t>(y0[e]) << 20) | (y1[e] >> 12);
      v[e] = __longlong_as_double(static_cast<long long>(mant | 0x3FF0000000000000ull)) - 1.0;
    }
    if (cnt == kPer && aligned16(o)) {
      reinterpret_cast<double2*>(o)[0] = make_double2(v[0], v[1]);
      reinterpret_cast<double2*>(o)[1] = make_double2(v[2], v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        if (e < cnt) o[e] = v[e];
    }
  }
}

// K: the construction; P: the position type (int32_t or int64_t; unread when
// pos is null, the counters then being the draw indices j); I: the index
// type of the groups and flat positions (32-bit where B * n fits)
template <int K, typename P, typename I>
__global__ void __launch_bounds__(kThreads) draw_kernel(
    const uint32_t* __restrict__ keys, I k_row, I k_word,  // [B, 2] int64 through its strides
    int fold, uint32_t site,                              // fold the site into each key first
    const P* __restrict__ pos, int clamp, int64_t hi,     // [B, n] counters, or null
    I n, I groups_per_row, I n_groups,
    void* __restrict__ out0, void* __restrict__ out1) {   // [B, n] each
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  for (I g = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; g < n_groups; g += stride) {
    const I row = groups_per_row == 1 ? g : g / groups_per_row;
    const I j0 = (g - row * groups_per_row) * kPer;
    const I flat = row * n + j0;
    const int cnt = n - j0 < kPer ? static_cast<int>(n - j0) : kPer;
    const uint32_t* k = keys + 2 * (row * k_row);  // the low word of each int64
    uint32_t k0 = __ldg(k);
    uint32_t k1 = __ldg(k + 2 * k_word);
    if (fold) threefry2x32(k0, k1, 0u, site, k0, k1);
    uint32_t ctr[kPer];
    if (pos != nullptr) {
      load_positions(pos + flat, cnt, clamp != 0, hi, ctr);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) ctr[e] = static_cast<uint32_t>(j0) + e;
    }
    uint32_t y0[kPer], y1[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) threefry2x32(k0, k1, 0u, ctr[e], y0[e], y1[e]);
    store_draws<K>(out0, out1, static_cast<int64_t>(flat), cnt, y0, y1);
  }
}

template <int K, typename P, typename I>
int launch_typed(const void* keys, int64_t k_row, int64_t k_word, int fold, uint32_t site,
                 const void* pos, int clamp, int64_t hi, int64_t B, int64_t n, void* out0,
                 void* out1, cudaStream_t stream) {
  const int64_t gpr = (n + kPer - 1) / kPer;
  const int64_t groups = B * gpr;
  draw_kernel<K, P, I><<<grid_for(groups), kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(keys), static_cast<I>(k_row), static_cast<I>(k_word), fold,
      site, static_cast<const P*>(pos), clamp, hi, static_cast<I>(n), static_cast<I>(gpr),
      static_cast<I>(groups), out0, out1);
  return static_cast<int>(cudaGetLastError());
}

template <int K, typename P>
int launch_indexed(const void* keys, int64_t k_row, int64_t k_word, int fold, uint32_t site,
                   const void* pos, int clamp, int64_t hi, int64_t B, int64_t n, void* out0,
                   void* out1, cudaStream_t stream) {
  // 32-bit indices where every flat position, key offset and group fits
  // (with room for the grid stride past the end)
  const int64_t lim = int64_t{1} << 30;
  if (B * n < lim && B * k_row < lim)
    return launch_typed<K, P, uint32_t>(keys, k_row, k_word, fold, site, pos, clamp, hi, B, n,
                                        out0, out1, stream);
  return launch_typed<K, P, uint64_t>(keys, k_row, k_word, fold, site, pos, clamp, hi, B, n, out0,
                                      out1, stream);
}

template <int K>
int launch_kind(const void* keys, int64_t k_row, int64_t k_word, int fold, uint32_t site,
                const void* pos, int pos_bytes, int clamp, int64_t hi, int64_t B, int64_t n,
                void* out0, void* out1, cudaStream_t stream) {
  if (pos_bytes == 4)
    return launch_indexed<K, int32_t>(keys, k_row, k_word, fold, site, pos, clamp, hi, B, n, out0,
                                      out1, stream);
  return launch_indexed<K, long long>(keys, k_row, k_word, fold, site, pos, clamp, hi, B, n, out0,
                                    out1, stream);
}

}  // namespace

// keys [R, C] of int64 word pairs read as keys[r*k_r + c*k_c] and
// [... + k_w]; data (data_bytes 4 or 8; 0: none) read as data[r*d_r + c*d_c];
// out [R * C, 2] int64, 16-byte aligned
extern "C" int launch_fold_in(const void* keys, int64_t k_r, int64_t k_c, int64_t k_w,
                              const void* data, int data_bytes, int64_t d_r, int64_t d_c,
                              int64_t add, int64_t R, int64_t C, void* out, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto k = static_cast<const uint32_t*>(keys);
  const auto o = static_cast<longlong2*>(out);
  const auto a = static_cast<uint32_t>(add);
  const unsigned grid = grid_for(R * C);
  if (data_bytes == 4)
    fold_kernel<int32_t><<<grid, kThreads, 0, st>>>(k, k_r, k_c, k_w,
                                                   static_cast<const int32_t*>(data), d_r, d_c,
                                                   a, R, C, o);
  else
    fold_kernel<long long><<<grid, kThreads, 0, st>>>(
        k, k_r, k_c, k_w, data_bytes == 8 ? static_cast<const long long*>(data) : nullptr, d_r,
        d_c, a, R, C, o);
  return static_cast<int>(cudaGetLastError());
}

// kind: a Kind; keys [B, 2] through (k_row, k_word); fold: fold `site` into
// each key first; pos [B, n] contiguous (pos_bytes 4 or 8) or null; clamp:
// clamp each position to [0, hi]; out0 (and out1 for kUniform2) [B, n]
extern "C" int launch_draw(int kind, const void* keys, int64_t k_row, int64_t k_word, int fold,
                           int64_t site, const void* pos, int pos_bytes, int clamp, int64_t hi,
                           int64_t B, int64_t n, void* out0, void* out1, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto s = static_cast<uint32_t>(site);
  switch (kind) {
    case kBits:
      return launch_kind<kBits>(keys, k_row, k_word, fold, s, pos, pos_bytes, clamp, hi, B, n,
                                out0, out1, st);
    case kUniform:
      return launch_kind<kUniform>(keys, k_row, k_word, fold, s, pos, pos_bytes, clamp, hi, B, n,
                                   out0, out1, st);
    case kUniform2:
      return launch_kind<kUniform2>(keys, k_row, k_word, fold, s, pos, pos_bytes, clamp, hi, B,
                                    n, out0, out1, st);
    case kUniformF64:
      return launch_kind<kUniformF64>(keys, k_row, k_word, fold, s, pos, pos_bytes, clamp, hi, B,
                                      n, out0, out1, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
