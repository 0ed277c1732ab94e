// The read assembly's packed-code gather, one CUDA thread per output position.
//
// Replaces the JAX package's TPU kernel
// ops/window_gather.py::gather_bytes_windowed (with _gather_windowed_i32):
// for each lane b and output position j, the packed reference byte holding
// 2-bit code src[b, j].  The code extraction that follows it in
// ops/apply_errors.py::fused_read_v2 is fused in, so the kernel writes the
// code itself:
//
//     code[b, j] = (packed[b, clamp(src >> 2)] >> 2 * (src & 3)) & 3
//
// What it computes is exactly the plain version gather_codes_plain in
// ops/gather_cuda.py (torch.gather of the packed row, then the shift), which
// the tests hold against the JAX package's take_along_axis branch.
//
// The TPU kernel builds a 1024-byte window per tile of 1024 positions and
// selects bytes from it by two one-hot matrix products, because a TPU has no
// fast per-element gather; lanes whose indices drift out of the window are
// flagged for a re-run.  Hopper gathers directly: a lane's indices are nearly
// contiguous (the output position shifted by the local indel drift), so a
// warp's 32 loads fall in one or two 32-byte sectors of the packed row and
// hit L1.  No window, no window starts, no overflow flag.
//
// What bounds it on an H100: bytes.  Per position it reads a 4-byte index,
// writes a 1-byte code and reads a quarter of a packed byte; there is no
// arithmetic to speak of.  The design keeps every device-memory access
// coalesced: one block covers 1024 consecutive positions of one lane
// (blockIdx.y is the lane), each thread four of them at a stride of 256, so
// a warp reads 128 contiguous index bytes and writes 32 contiguous code bytes
// per step, and the four independent loads per thread are in flight together.
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

__global__ void gather_codes_kernel(const uint8_t* __restrict__ packed,  // [B, PB]
                                    int64_t PB,
                                    const int32_t* __restrict__ src,     // [B, L]
                                    int64_t L,
                                    uint8_t* __restrict__ out) {         // [B, L]
  const int64_t b = blockIdx.y;
  const uint8_t* prow = packed + b * PB;
  const int32_t* srow = src + b * L;
  uint8_t* orow = out + b * L;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kCols + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t j = j0 + k * kThreads;
    if (j < L) {
      const int32_t s = srow[j];
      // byte index clamped to the row, as the plain version clamps src >> 2
      int64_t byte = s >> 2;
      byte = byte < 0 ? 0 : (byte >= PB ? PB - 1 : byte);
      const uint32_t v = __ldg(prow + byte);
      orow[j] = static_cast<uint8_t>((v >> (2 * (s & 3))) & 3u);
    }
  }
}

}  // namespace

extern "C" int launch_gather_codes(const void* packed, int64_t PB, const void* src, int B,
                                   int64_t L, void* out, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((L + kCols - 1) / kCols), static_cast<unsigned>(B));
  gather_codes_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), PB, static_cast<const int32_t*>(src), L,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
