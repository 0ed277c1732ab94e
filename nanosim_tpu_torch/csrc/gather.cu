// The read path's two per-lane gathers: the packed-code gather of the fused
// read (gather_codes_kernel, one CUDA thread per four output positions of a
// row) and the plain element gather of the unfused homopolymer path
// (gather_rows_kernel, below, a 1-D grid over the flat output).
//
// --- gather_codes_kernel ---------------------------------------------------
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

// --- gather_rows_kernel ----------------------------------------------------
//
// Replaces the JAX package's TPU kernel ops/pallas_gather.py::gather_u8 (with
// _gather_i32): out[b, j] = parts[b, idx[b, j]], i.e.
// take_along_axis(parts, idx, axis=1) with idx already clipped to the row.
// The unfused (homopolymer-mode) read path calls it twice per batch: on the
// ASCII reference segment in materialize_read (1-byte elements) and on the
// packed base|class values in resize_homopolymers (2-byte elements), so the
// kernel is a template over the element type with one entry point per width.
// What it computes is exactly gather_u8_plain in ops/gather_cuda.py
// (torch.gather with an int64 index).
//
// The TPU kernel turns the gather into two one-hot matrix products over
// 128-byte rows of the parts buffer, because a TPU has no per-element gather,
// and its cost grows with the row width.  On Hopper the gather is a load at a
// computed address, so none of that is carried over.
//
// What bounds it on an H100: bytes.  Per position it reads a 4-byte index,
// reads one element and writes one element.  The grid is 1-D over the B*L
// output positions, read as one flat array, and sized to the work (at most
// kWaves waves of blocks, a grid-stride loop beyond that), so a short row
// leaves no block partly idle.  Each thread takes four consecutive positions:
// one 16-byte load of four indices, four element loads through the read-only
// cache (the near-contiguous indices of an edit script hit the same
// sectors), and one 4- or 8-byte store of the four elements.  Four flat
// positions may straddle two rows (or more, when L < 4): each position
// finds its own row.  The last B*L mod 4 positions, and every position when
// a pointer is not aligned for the vector accesses, take a scalar loop.
// Indices are clamped to the row so that a bad index cannot read outside
// the buffer (the callers clip; the plain version raises).

constexpr int kRowThreads = 256;
constexpr int kWaves = 4;  // blocks in flight: at most this many full waves

template <typename T> struct Vec4;
template <> struct Vec4<uint8_t> { using type = uchar4; };
template <> struct Vec4<uint16_t> { using type = ushort4; };

template <typename T, typename I>
__device__ __forceinline__ T gather_one(const T* __restrict__ prow, I W, int32_t s) {
  const I c = s < 0 ? I(0) : (static_cast<I>(s) >= W ? W - 1 : static_cast<I>(s));
  return __ldg(prow + c);
}

// I: the index type of the flat positions (32-bit when B*L and B*W fit)
template <typename T, typename I>
__global__ void __launch_bounds__(kRowThreads) gather_rows_kernel(
    const T* __restrict__ parts,      // [B, W]
    I W,
    const int32_t* __restrict__ idx,  // [B, L]
    I L,
    I n_vec,                          // groups of four positions taken as vectors
    I N,                              // B * L
    T* __restrict__ out) {            // [B, L]
  using V = typename Vec4<T>::type;
  const I stride = static_cast<I>(gridDim.x) * kRowThreads;
  const I tid = static_cast<I>(blockIdx.x) * kRowThreads + threadIdx.x;
  for (I g = tid; g < n_vec; g += stride) {
    const int4 s = __ldg(reinterpret_cast<const int4*>(idx) + g);
    const I p = 4 * g;
    const I b = p / L;
    I j = p - b * L;
    const T* prow = parts + b * W;
    T v[4];
    const int32_t si[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (j == L) {  // the next row
        j = 0;
        prow += W;
      }
      v[k] = gather_one(prow, W, si[k]);
      ++j;
    }
    V o;
    o.x = v[0];
    o.y = v[1];
    o.z = v[2];
    o.w = v[3];
    reinterpret_cast<V*>(out)[g] = o;
  }
  for (I p = 4 * n_vec + tid; p < N; p += stride) {
    const I b = p / L;
    out[p] = gather_one(parts + b * W, W, __ldg(idx + p));
  }
}

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

template <typename T, typename I>
int launch_rows(const void* parts, int64_t W, const void* idx, int64_t N, int64_t L, void* out,
                void* stream) {
  // the vector accesses need a 16-byte aligned index and a 4-element aligned output
  const bool vec = reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % sizeof(typename Vec4<T>::type) == 0;
  const int64_t n_vec = vec ? N / 4 : 0;
  const int64_t work = n_vec + (N - 4 * n_vec);  // threads the work can use
  const int64_t cap = static_cast<int64_t>(sm_count()) * (2048 / kRowThreads) * kWaves;
  int64_t blocks = (work + kRowThreads - 1) / kRowThreads;
  blocks = blocks < cap ? blocks : cap;
  gather_rows_kernel<T, I><<<static_cast<unsigned>(blocks), kRowThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(parts), static_cast<I>(W), static_cast<const int32_t*>(idx),
      static_cast<I>(L), static_cast<I>(n_vec), static_cast<I>(N), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gather_rows(const void* parts, int64_t W, const void* idx, int B, int64_t L,
                       void* out, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  const int64_t N = static_cast<int64_t>(B) * L;
  // 32-bit positions when every flat position and row offset fits (with room
  // for the grid stride past the end)
  if (N < (int64_t{1} << 31) && static_cast<int64_t>(B) * W < (int64_t{1} << 31))
    return launch_rows<T, uint32_t>(parts, W, idx, N, L, out, stream);
  return launch_rows<T, uint64_t>(parts, W, idx, N, L, out, stream);
}

}  // namespace

extern "C" int launch_gather_u8(const void* parts, int64_t W, const void* idx, int B,
                                int64_t L, void* out, void* stream) {
  return launch_gather_rows<uint8_t>(parts, W, idx, B, L, out, stream);
}

extern "C" int launch_gather_u16(const void* parts, int64_t W, const void* idx, int B,
                                 int64_t L, void* out, void* stream) {
  return launch_gather_rows<uint16_t>(parts, W, idx, B, L, out, stream);
}

extern "C" int launch_gather_codes(const void* packed, int64_t PB, const void* src, int B,
                                   int64_t L, void* out, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((L + kCols - 1) / kCols), static_cast<unsigned>(B));
  gather_codes_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), PB, static_cast<const int32_t*>(src), L,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
