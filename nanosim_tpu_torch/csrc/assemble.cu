// Read assembly: head | mutated middle | tail per lane, strand flip included,
// one CUDA thread per output position.
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
// What bounds it on an H100: bytes.  Per output position it reads one 2-byte
// element and writes one; the per-lane scalars are 13 bytes.  One block
// covers 1024 consecutive positions of one lane (blockIdx.y is the lane),
// each thread four of them at a stride of 256: a warp's stores are 64
// contiguous bytes, and its loads are contiguous too (ascending on forward
// lanes, descending on reversed ones) except where a warp straddles the
// head/middle or middle/tail boundary.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (no PyTorch headers) and bound with ctypes; the launcher returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kCols = kThreads * kPerThread;  // positions per block

// A<->T, C<->G on the low byte; anything else, and the high byte, unchanged
__device__ __forceinline__ uint16_t complement_low_byte(uint16_t v) {
  const uint16_t base = v & 0xFFu;
  uint16_t comp = base;
  if (base == 'A') comp = 'T';
  else if (base == 'T') comp = 'A';
  else if (base == 'C') comp = 'G';
  else if (base == 'G') comp = 'C';
  return static_cast<uint16_t>((v & 0xFF00u) | comp);
}

__global__ void assemble_kernel(const uint16_t* __restrict__ mid,   // [B, l_cap]
                                int64_t l_cap,
                                const uint16_t* __restrict__ ht,    // [B, ht_cap]
                                int64_t ht_cap,
                                const int32_t* __restrict__ head,   // [B]
                                const int32_t* __restrict__ l_new,  // [B]
                                const int32_t* __restrict__ total,  // [B]
                                const uint8_t* __restrict__ is_rev, // [B]
                                int64_t l_out,
                                uint16_t* __restrict__ out) {       // [B, l_out]
  const int64_t b = blockIdx.y;
  const uint16_t* mrow = mid + b * l_cap;
  const uint16_t* hrow = ht + b * ht_cap;
  uint16_t* orow = out + b * l_out;
  const int64_t h = head[b];
  const int64_t n = l_new[b];
  const int64_t t = total[b];
  const bool rev = is_rev[b] != 0;
  const int64_t parts = l_cap + ht_cap;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kCols + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t j = j0 + k * kThreads;
    if (j >= l_out) continue;
    uint16_t v = 0;
    if (j < t) {
      const int64_t jj = rev ? t - 1 - j : j;
      // index into the concatenation [mid | ht], clipped to it
      int64_t idx;
      if (jj >= h && jj < h + n) idx = jj - h;
      else if (jj < h) idx = l_cap + jj;
      else idx = l_cap + jj - n;
      idx = idx < 0 ? 0 : (idx >= parts ? parts - 1 : idx);
      v = idx < l_cap ? __ldg(mrow + idx) : __ldg(hrow + (idx - l_cap));
      if (rev) v = complement_low_byte(v);
    }
    orow[j] = v;
  }
}

}  // namespace

extern "C" int launch_assemble(const void* mid, int64_t l_cap, const void* ht, int64_t ht_cap,
                               const void* head, const void* l_new, const void* total,
                               const void* is_rev, int B, int64_t l_out, void* out,
                               void* stream) {
  if (B <= 0 || l_out <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((l_out + kCols - 1) / kCols),
                  static_cast<unsigned>(B));
  assemble_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(mid), l_cap, static_cast<const uint16_t*>(ht), ht_cap,
      static_cast<const int32_t*>(head), static_cast<const int32_t*>(l_new),
      static_cast<const int32_t*>(total), static_cast<const uint8_t*>(is_rev), l_out,
      static_cast<uint16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
