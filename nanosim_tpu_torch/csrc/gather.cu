// The read path's two per-lane gathers: the packed-code gather of the fused
// read (gather_codes_kernel) and the plain element gather of the unfused
// homopolymer path (gather_rows_kernel, below).  Both run a 1-D grid over
// the flat output.
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
//     code[b, j] = (packed[b, clamp(src >> 2, 0, PB - 1)] >> 2 * (src & 3)) & 3
//
// What it computes is exactly the plain version gather_codes_plain in
// ops/gather_cuda.py (torch.gather of the packed row, then the shift), which
// the tests hold against the JAX package's take_along_axis branch and its
// windowed TPU kernel in interpret mode.
//
// The TPU kernel builds a 1024-byte window per tile of 1024 positions and
// selects bytes from it by two one-hot matrix products, because a TPU has no
// fast per-element gather; lanes whose indices drift out of the window are
// flagged for a re-run.  Hopper gathers directly: a lane's indices are nearly
// contiguous (the output position shifted by the local indel drift), so the
// bytes a warp reads fall in a few 32-byte sectors of the packed row and hit
// L1.  No window, no window starts, no overflow flag.
//
// What bounds it on an H100: bytes.  Per position it reads a 4-byte index,
// writes a 1-byte code and reads a quarter of a packed byte; there is no
// arithmetic to speak of.  The grid is 1-D over the B*L output positions,
// read as one flat array, sized to the card (at most kWaves waves of blocks,
// a grid-stride loop beyond that), with 32-bit positions where B*L and B*PB
// fit.  Each thread takes 16 consecutive positions: four 16-byte index loads
// issued together (64 bytes in flight a thread), the 16 packed-byte loads
// through the read-only cache, and one 16-byte store of the 16 codes.  The
// 16 positions may straddle two rows (or more, when L < 16): each position
// finds its own row.  The last B*L mod 16 positions, and every position when
// the index or the output is not 16-byte aligned, take a scalar loop.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W) at the circular path's shape
// (B = 2,048, L = 19,456, PB = 4,480; bound 0.0622 ms): 0.072-0.076 ms on the
// device, 82-86% of the bound, where the first design (a 2-D grid of 1,024
// positions a block, four scalar positions a thread) took 0.126-0.128 ms.
// An instance that staged the indices through a ring of three 16 KB tiles in
// shared memory, filled by TMA bulk copies ahead of four resident blocks an
// SM, took 0.0742-0.0744 ms on the device against this one's 0.0732-0.0733
// ms in the same run and was dropped: the direct loads already keep enough
// bytes in flight (PERF.md).
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (no PyTorch headers) and bound with ctypes; the launchers return
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowThreads = 256;
constexpr int kWaves = 4;  // blocks in flight: at most this many full waves
constexpr int kCodes = 16;  // positions a thread of the code gather takes

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

// the byte of a packed row holding code s, its index clamped to the row
template <typename I>
__device__ __forceinline__ uint32_t packed_byte(const uint8_t* __restrict__ prow, I PB,
                                                int32_t s) {
  const int32_t w = s >> 2;
  const I c = w < 0 ? I(0) : (static_cast<I>(w) >= PB ? PB - 1 : static_cast<I>(w));
  return __ldg(prow + c);
}

__device__ __forceinline__ uint32_t code_bits(uint32_t byte, int32_t s) {
  return (byte >> (2 * (s & 3))) & 3u;
}

// the 16 codes of flat positions p .. p+15 (p a multiple of 16) from their
// 16 indices, as one 16-byte vector
template <typename I>
__device__ __forceinline__ uint4 sixteen_codes(const uint8_t* __restrict__ packed, I PB, I L,
                                               I p, const int32_t (&s)[kCodes]) {
  const I row = p / L;
  I j = p - row * L;
  const uint8_t* prow = packed + row * PB;
  uint32_t v[kCodes];
#pragma unroll
  for (int k = 0; k < kCodes; ++k) {  // every byte load issued before any is used
    if (j == L) {  // the next row
      j = 0;
      prow += PB;
    }
    v[k] = packed_byte(prow, PB, s[k]);
    ++j;
  }
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    w[q] = code_bits(v[4 * q], s[4 * q]) | code_bits(v[4 * q + 1], s[4 * q + 1]) << 8 |
           code_bits(v[4 * q + 2], s[4 * q + 2]) << 16 | code_bits(v[4 * q + 3], s[4 * q + 3]) << 24;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// I: the index type of the flat positions (32-bit when B*L and B*PB fit)
template <typename I>
__global__ void __launch_bounds__(kRowThreads) gather_codes_kernel(
    const uint8_t* __restrict__ packed,  // [B, PB]
    I PB,
    const int32_t* __restrict__ src,     // [B, L]
    I L,
    I n_vec,                             // groups of 16 positions taken as vectors
    I N,                                 // B * L
    uint8_t* __restrict__ out) {         // [B, L]
  const I stride = static_cast<I>(gridDim.x) * kRowThreads;
  const I tid = static_cast<I>(blockIdx.x) * kRowThreads + threadIdx.x;
  for (I g = tid; g < n_vec; g += stride) {
    const int4* s4 = reinterpret_cast<const int4*>(src) + 4 * g;
    const int4 a[4] = {__ldg(s4), __ldg(s4 + 1), __ldg(s4 + 2), __ldg(s4 + 3)};
    const int32_t s[kCodes] = {a[0].x, a[0].y, a[0].z, a[0].w, a[1].x, a[1].y, a[1].z, a[1].w,
                               a[2].x, a[2].y, a[2].z, a[2].w, a[3].x, a[3].y, a[3].z, a[3].w};
    reinterpret_cast<uint4*>(out)[g] = sixteen_codes(packed, PB, L, kCodes * g, s);
  }
  for (I p = kCodes * n_vec + tid; p < N; p += stride) {
    const int32_t s = __ldg(src + p);
    out[p] = static_cast<uint8_t>(code_bits(packed_byte(packed + (p / L) * PB, PB, s), s));
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename I>
int launch_codes(const void* packed, int64_t PB, const void* src, int64_t N, int64_t L,
                 void* out, cudaStream_t stream) {
  // the vector accesses need a 16-byte aligned index and output
  const int64_t n_vec = aligned16(src) && aligned16(out) ? N / kCodes : 0;
  const int64_t work = n_vec + (N - kCodes * n_vec);  // threads the work can use
  const int64_t cap = static_cast<int64_t>(sm_count()) * (2048 / kRowThreads) * kWaves;
  int64_t blocks = (work + kRowThreads - 1) / kRowThreads;
  blocks = blocks < cap ? blocks : cap;
  gather_codes_kernel<I><<<static_cast<unsigned>(blocks), kRowThreads, 0, stream>>>(
      static_cast<const uint8_t*>(packed), static_cast<I>(PB), static_cast<const int32_t*>(src),
      static_cast<I>(L), static_cast<I>(n_vec), static_cast<I>(N), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
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
  const int64_t N = static_cast<int64_t>(B) * L;
  const auto st = static_cast<cudaStream_t>(stream);
  // 32-bit positions when every flat position and row offset fits (with room
  // for the grid stride past the end)
  if (N < (int64_t{1} << 31) && static_cast<int64_t>(B) * PB < (int64_t{1} << 31))
    return launch_codes<uint32_t>(packed, PB, src, N, L, out, st);
  return launch_codes<uint64_t>(packed, PB, src, N, L, out, st);
}
