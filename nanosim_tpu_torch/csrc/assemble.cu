// Read assembly: head | mutated middle | tail per lane, strand flip included.
//
// Replaces the JAX package's TPU kernel ops/pallas_assemble.py::assemble_rolls
// (kernel _kernel).  Inputs are packed 16-bit base|class values (ASCII base in
// the low byte, quality class in the high byte): the mutated middle
// mid [B, l_cap] and the random head/tail pool ht [B, ht_cap], with per-lane
// head, l_new, total and is_rev.  For output position j of lane b:
//
//     jj  = is_rev ? total - 1 - j : j                (pre-reverse coordinate)
//     src = ht[jj]              if jj <  head         (head bases)
//           mid[jj - head]      if jj <  head + l_new (mutated middle)
//           ht[jj - l_new]      otherwise             (tail bases)
//     out = is_rev ? complement_low_byte(src) : src,  0 where j >= total
//
// What it computes is exactly assemble_rolls_plain in ops/assemble_cuda.py,
// the concatenate-and-one-gather formulation of the JAX package's
// sim/genome_mode.py::assemble_read: the source index addresses the
// concatenation [mid | ht] and is clipped to it, so even a lane whose l_new
// exceeds l_cap (a capacity overflow, discarded later) reads the same element
// as the plain version.
//
// The TPU kernel pads both inputs into a scratch row, rotates it three times
// with a dynamic roll, selects among the rolls, builds reversed lanes
// right-aligned and leaves the reversal to a global flip outside, in tiles of
// eight lanes: a TPU has no per-element addressing.  On Hopper the three
// rolls are index arithmetic and the flip is the mirrored coordinate, so
// there is no roll, no scratch row, no second pass and no restriction on the
// batch size.
//
// What bounds it on an H100: bytes.  Per output position below the lane's
// total it reads one 2-byte element, and it writes every output position
// once; the per-lane scalars are 13 bytes.  More than half of the output is
// zero fill past total at the `-hp` path's shape.  One block takes one lane,
// and its threads read the lane's four scalars once; then each thread takes
// groups of 8 consecutive output positions and writes each group as one
// 16-byte vector.  A group wholly past total is stored as zeros with no
// load; a group below it reads its 8 elements through the read-only cache
// (a lane's reads are near-contiguous, forward or mirrored).  All index
// arithmetic is 32-bit, and the complement is branch-free (A^T and C^G
// differ in one xor mask each).  The positions of a row before its first
// 16-byte aligned address and after its last whole group take a scalar
// loop, so any l_out and any output offset work.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W) at the `-hp` path's shape
// (B = 2,048, l_cap = 17,664, ht_cap = 1,024, l_out = 19,456; bound 0.0336
// ms): 0.0469-0.0470 ms on the device, 0.72 of the bound, where the first
// design (a 2-D grid of 1,024 positions a block, scalar 2-byte loads and
// stores) took 0.095-0.100 ms.  A variant that first copied the lane's
// middle and head/tail row into shared memory (TMA bulk copies completing
// on an mbarrier) took 0.0453-0.0456 ms, and 0.0457-0.0459 ms in the same
// runs where it read device memory instead; it was removed, as 1-3% did
// not pay for a second fetch path and its limits on shared memory
// (PERF.md).
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (no PyTorch headers) and bound with ctypes; the launcher returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;  // positions a 16-byte vector holds

// A<->T, C<->G on the low byte; anything else, and the high byte, unchanged
__device__ __forceinline__ uint32_t complement_low_byte(uint32_t v) {
  const uint32_t b = v & 0xFFu;
  const uint32_t flip = (b == 'A' || b == 'T') ? 21u : ((b == 'C' || b == 'G') ? 4u : 0u);
  return v ^ flip;
}

struct Lane {
  const uint16_t* __restrict__ mid;  // the lane's rows
  const uint16_t* __restrict__ ht;
  int32_t h, n, t;  // head, l_new, total
  bool rev;
  int32_t l_cap, parts;
};

// output position j of the lane, 0 at and past total
__device__ __forceinline__ uint32_t element(const Lane& ln, int32_t j) {
  if (j >= ln.t) return 0u;
  const int32_t jj = ln.rev ? ln.t - 1 - j : j;
  // index into the concatenation [mid | ht], clipped to it
  int32_t idx = (jj >= ln.h && jj < ln.h + ln.n) ? jj - ln.h
                                                  : (jj < ln.h ? ln.l_cap + jj : ln.l_cap + jj - ln.n);
  idx = idx < 0 ? 0 : (idx >= ln.parts ? ln.parts - 1 : idx);
  const uint32_t v = idx < ln.l_cap ? __ldg(ln.mid + idx) : __ldg(ln.ht + (idx - ln.l_cap));
  return ln.rev ? complement_low_byte(v) : v;
}

__global__ void __launch_bounds__(kThreads) assemble_kernel(
    const uint16_t* __restrict__ mid,    // [B, l_cap]
    int32_t l_cap,
    const uint16_t* __restrict__ ht,     // [B, ht_cap]
    int32_t ht_cap,
    const int32_t* __restrict__ head,    // [B]
    const int32_t* __restrict__ l_new,   // [B]
    const int32_t* __restrict__ total,   // [B]
    const uint8_t* __restrict__ is_rev,  // [B]
    int32_t l_out,
    uint16_t* __restrict__ out) {        // [B, l_out]
  const size_t b = blockIdx.x;
  const Lane ln{mid + b * l_cap, ht + b * ht_cap, __ldg(head + b), __ldg(l_new + b),
                __ldg(total + b), __ldg(is_rev + b) != 0, l_cap, l_cap + ht_cap};
  uint16_t* orow = out + b * l_out;

  // positions [0, a0) before the first 16-byte aligned address of the row,
  // [a0, a0 + 8 * nv) as vectors, the rest after them
  const int32_t a0 = static_cast<int32_t>(
      ((16u - (reinterpret_cast<uintptr_t>(orow) & 15u)) & 15u) / 2u);
  const int32_t nv = a0 < l_out ? (l_out - a0) / kGroup : 0;
  for (int32_t g = threadIdx.x; g < nv; g += kThreads) {
    const int32_t j0 = a0 + kGroup * g;
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (j0 < ln.t) {
      uint32_t v[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) v[k] = element(ln, j0 + k);
      o = make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16, v[6] | v[7] << 16);
    }
    *reinterpret_cast<uint4*>(orow + j0) = o;
  }
  const int32_t lo = a0 < l_out ? a0 : l_out;
  for (int32_t j = threadIdx.x; j < lo; j += kThreads)
    orow[j] = static_cast<uint16_t>(element(ln, j));
  for (int32_t j = a0 + kGroup * nv + threadIdx.x; j < l_out; j += kThreads)
    orow[j] = static_cast<uint16_t>(element(ln, j));
}

}  // namespace

extern "C" int launch_assemble(const void* mid, int64_t l_cap, const void* ht, int64_t ht_cap,
                               const void* head, const void* l_new, const void* total,
                               const void* is_rev, int B, int64_t l_out, void* out,
                               void* stream) {
  if (B <= 0 || l_out <= 0) return 0;
  // 32-bit positions within a lane: the concatenation and the output row fit
  if (l_cap + ht_cap >= (int64_t{1} << 31) - kThreads * kGroup ||
      l_out >= (int64_t{1} << 31) - kThreads * kGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  assemble_kernel<<<static_cast<unsigned>(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(mid), static_cast<int32_t>(l_cap),
      static_cast<const uint16_t*>(ht), static_cast<int32_t>(ht_cap),
      static_cast<const int32_t*>(head), static_cast<const int32_t*>(l_new),
      static_cast<const int32_t*>(total), static_cast<const uint8_t*>(is_rev),
      static_cast<int32_t>(l_out), static_cast<uint16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
