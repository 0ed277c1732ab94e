// The windowed byte gather: the design question of the JAX package's TPU
// experiment bench/gather_variants.py::make_gather(KT, W8v, dt) (its
// pallas_call at :75), asked on Hopper.
//
// What it computes, for lane b and output position j of tile t = j / 1024:
//
//     wb  = ws[b, t] >> 9                      (window start, in 128-byte rows)
//     lb  = clamp((idx[b, j] - (wb << 9)) >> 2, 0, W8V * 128 - 1)
//     out = packed[b, wb * 128 + lb]   if that byte lies in the row, else 0
//
// i.e. the packed byte holding 2-bit code idx[b, j], read from a window of
// W8V * 128 bytes that starts at the tile's window start.  Where the window
// covers the tile's indices, out = packed[b, idx >> 2]; a window row past the
// row's end reads as zeros (the TPU kernel's one-hot product with a row that
// does not exist).  The TPU kernel builds each window with a one-hot matrix
// product and selects bytes with two more, because a TPU has no fast
// per-element gather; KT (tiles per grid step) changes its schedule only and
// dt (f32 or bf16 products) is exact for bytes either way, so the bf16
// variants map to the same instances here.
//
// The question on this card is whether staging a window of the row in shared
// memory beats the direct global gather of csrc/gather.cu (K3's design).  A
// block owns 8 lanes x KT tiles.  It loads its own window starts, copies each
// (lane, tile) window of W8V * 128 bytes into shared memory (a warp reads 32
// neighbouring bytes), then each thread gathers four positions of each tile
// from shared memory, reading the int32 indices and writing the int32 bytes
// coalesced.  The ragged edges (B not a multiple of 8, L not a multiple of
// 1024 * KT) are masked; nothing is padded.  Shared memory: 8 * KT * W8V *
// 128 bytes (32 KB for KT4 W8 and KT8 W4, 16 KB for KT4 W4).
//
// What bounds it on an H100: bytes.  Per position it reads a 4-byte index and
// writes a 4-byte result; each packed row is read about once (the windows of
// neighbouring tiles overlap by the drift).  At the experiment's shape (B =
// 1,024, L = 19,456, 4,608 packed bytes per lane) that is 164 MB, 0.049 ms at
// 3.35 TB/s.  A simple kernel first: no TMA, no vector loads.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (no PyTorch headers) and bound with ctypes; the launcher returns
// cudaGetLastError(), or kUnsupported for a (KT, W8V) that has no instance.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;     // output positions per tile
constexpr int kRows = 8;        // lanes per block
constexpr int kThreads = 256;
constexpr int kUnsupported = 1000;  // above every cudaError_t value

template <int KT, int W8V>
__global__ void __launch_bounds__(kThreads)
gather_window_kernel(const uint8_t* __restrict__ packed,  // [B, PB]
                     int64_t PB,
                     const int32_t* __restrict__ idx,     // [B, L]
                     const int32_t* __restrict__ ws,      // [B, n_tiles]
                     int B, int64_t L, int n_tiles,
                     int32_t* __restrict__ out) {         // [B, L]
  constexpr int kWin = W8V * 128;
  __shared__ uint8_t win[kRows * KT][kWin];
  __shared__ int32_t wbs[kRows * KT];

  const int b0 = blockIdx.x * kRows;
  const int t0 = blockIdx.y * KT;
  const int tid = threadIdx.x;

  // the block's window starts (in 128-byte rows)
  if (tid < kRows * KT) {
    const int b = b0 + tid / KT;
    const int t = t0 + tid % KT;
    wbs[tid] = (b < B && t < n_tiles) ? (ws[static_cast<int64_t>(b) * n_tiles + t] >> 9) : 0;
  }
  __syncthreads();

  // stage every (lane, tile) window; bytes past the row's end are zeros
  for (int w = 0; w < kRows * KT; ++w) {
    const int b = b0 + w / KT;
    if (b >= B || t0 + w % KT >= n_tiles) continue;
    const uint8_t* prow = packed + static_cast<int64_t>(b) * PB;
    const int64_t a0 = static_cast<int64_t>(wbs[w]) * 128;
    for (int c = tid; c < kWin; c += kThreads) {
      const int64_t a = a0 + c;
      win[w][c] = a < PB ? __ldg(prow + a) : uint8_t(0);
    }
  }
  __syncthreads();

  // gather: four positions per thread and tile, 256 apart
  for (int w = 0; w < kRows * KT; ++w) {
    const int b = b0 + w / KT;
    const int t = t0 + w % KT;
    if (b >= B || t >= n_tiles) continue;
    const int32_t base = wbs[w] << 9;
    const int32_t* irow = idx + static_cast<int64_t>(b) * L;
    int32_t* orow = out + static_cast<int64_t>(b) * L;
#pragma unroll
    for (int k = 0; k < kTile / kThreads; ++k) {
      const int64_t j = static_cast<int64_t>(t) * kTile + k * kThreads + tid;
      if (j < L) {
        int32_t lb = (irow[j] - base) >> 2;
        lb = lb < 0 ? 0 : (lb > kWin - 1 ? kWin - 1 : lb);
        orow[j] = win[w][lb];
      }
    }
  }
}

template <int KT, int W8V>
void launch(const uint8_t* packed, int64_t PB, const int32_t* idx, const int32_t* ws, int B,
            int64_t L, int n_tiles, int32_t* out, cudaStream_t stream) {
  const dim3 grid((B + kRows - 1) / kRows, (n_tiles + KT - 1) / KT);
  gather_window_kernel<KT, W8V><<<grid, kThreads, 0, stream>>>(packed, PB, idx, ws, B, L,
                                                                n_tiles, out);
}

}  // namespace

extern "C" int launch_gather_window(int kt, int w8v, const void* packed, int64_t PB,
                                    const void* idx, const void* ws, int B, int64_t L,
                                    int n_tiles, void* out, void* stream) {
  auto p = static_cast<const uint8_t*>(packed);
  auto i = static_cast<const int32_t*>(idx);
  auto s = static_cast<const int32_t*>(ws);
  auto o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (kt == 4 && w8v == 8) {
    launch<4, 8>(p, PB, i, s, B, L, n_tiles, o, st);
  } else if (kt == 4 && w8v == 4) {
    launch<4, 4>(p, PB, i, s, B, L, n_tiles, o, st);
  } else if (kt == 8 && w8v == 4) {
    launch<8, 4>(p, PB, i, s, B, L, n_tiles, o, st);
  } else {
    return kUnsupported;
  }
  return static_cast<int>(cudaGetLastError());
}
