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
// per-element gather; dt (f32 or bf16 products) is exact for bytes either
// way, so the bf16 variants map to the same instances here.
//
// The question on this card is whether staging a window of the row in shared
// memory beats the direct global gather of csrc/gather.cu (K3's design).  The
// design stages every window by an asynchronous bulk copy and keeps the next
// copy in flight while the current windows are read:
//
// - A work item is one lane x KT consecutive tiles (KT sets how many windows
//   an item stages, KT * W8V * 128 bytes).  The grid is 1-D and persistent,
//   as many blocks as the card holds at once; block k takes items k,
//   k + grid, ...  One lane an item keeps the items many (5,120 at the
//   experiment's shape), so the last round of the grid is nearly full.
// - The copy.  Where the packed row's base and length are multiples of 16
//   bytes, one thread issues one 1-D TMA bulk copy (cp.async.bulk) per
//   window, completing on the buffer's mbarrier; a window's bytes past the
//   row's end are not copied but zero-filled by the threads.  Otherwise
//   (the ragged rows) each thread copies 16-byte pieces of the windows with
//   cp.async where the piece is aligned and inside the row, and byte by byte
//   where it is not.
// - Double buffering.  Two buffers of KT windows: each item's threads issue
//   their index loads, then the next item's copies into the other buffer,
//   then wait for the current item's windows and gather.  The __syncthreads
//   that ends an item frees its buffer for the copies the next item issues.
// - The gather.  A thread takes four consecutive positions of each tile: one
//   16-byte index load (all KT issued before the wait), four byte reads from
//   shared memory, one 16-byte store of the four int32 results.  Positions
//   past L, and rows that are not 16-byte aligned (L not a multiple of 4),
//   take a scalar path.
//
// What bounds it on an H100: bytes.  Per position it reads a 4-byte index and
// writes a 4-byte result; each packed row is read about once (the windows of
// neighbouring tiles overlap by the drift).  At the experiment's shape (B =
// 1,024, L = 19,456, 4,608 packed bytes per lane) that is 164 MB, 0.049 ms at
// 3.35 TB/s.  Measured on an NVIDIA H100 80GB HBM3 (700 W) there: 0.0601-
// 0.0654 ms, device 0.0583-0.0640 ms (0.77-0.84 of the bound), against
// 0.0787-0.1076 ms for the first design (a 2-D grid of 8 lanes x KT tiles a
// block, the windows staged one byte per thread before any gather) and
// 0.0784 ms for one torch.gather in the same run (PERF.md).  The bulk copies
// against the threads' 16-byte cp.async at that shape, on the same card:
// KT4 W8 0.0606 against 0.0630 ms, KT4 W4 0.0604 against 0.0618, KT8 W4
// 0.0654 against 0.0641 (medians of five rounds of 100 launches).
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (no PyTorch headers) and bound with ctypes; the launcher returns
// cudaGetLastError(), or kUnsupported for a (KT, W8V) that has no instance.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;     // output positions per tile
constexpr int kThreads = 256;   // 4 positions a thread cover a tile
constexpr int kUnsupported = 1000;  // above every cudaError_t value

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// add `bytes` to the barrier's pending transaction count
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// n bytes (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t n,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(n), "r"(smem_addr(bar))
      : "memory");
}

// the first byte of (lane b, tile t)'s window in the packed row
__device__ __forceinline__ int64_t window_start(const int32_t* __restrict__ ws, int b, int t,
                                                int n_tiles) {
  return static_cast<int64_t>(__ldg(ws + static_cast<int64_t>(b) * n_tiles + t) >> 9) * 128;
}

template <int KT, int W8V, bool BULK>
__global__ void __launch_bounds__(kThreads)
gather_window_kernel(const uint8_t* __restrict__ packed,  // [B, PB]
                     int64_t PB,
                     const int32_t* __restrict__ idx,     // [B, L]
                     const int32_t* __restrict__ ws,      // [B, n_tiles]
                     int64_t L, int n_tiles, int n_chunks, int n_items, bool vec,
                     int32_t* __restrict__ out) {         // [B, L]
  constexpr int kWin = W8V * 128;
  __shared__ __align__(128) uint8_t win[2][KT][kWin];
  __shared__ __align__(8) uint64_t bar[2];
  const int tid = threadIdx.x;
  if (BULK && tid == 0) {
    bar_init(&bar[0]);
    bar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // issue item `it`'s window copies into buffer `buf`
  auto stage = [&](int it, int buf) {
    const int b = it / n_chunks;
    const int t0 = (it - b * n_chunks) * KT;
    const uint8_t* prow = packed + static_cast<int64_t>(b) * PB;
    if (BULK) {
      // thread 0 adds each window's bytes to the barrier's count and issues
      // its copy, then arrives; every thread zero-fills its share of the
      // bytes past the row's end
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        if (t0 + k >= n_tiles) break;
        const int64_t a0 = window_start(ws, b, t0 + k, n_tiles);
        const int64_t left = PB - a0;
        const uint32_t n = left <= 0 ? 0u : (left >= kWin ? uint32_t(kWin)
                                                          : static_cast<uint32_t>(left));
        for (int c = n + tid; c < kWin; c += kThreads) win[buf][k][c] = 0;
        if (tid == 0 && n > 0) {
          bar_expect(&bar[buf], n);
          bulk_copy(win[buf][k], prow + a0, n, &bar[buf]);
        }
      }
      if (tid == 0) bar_arrive(&bar[buf]);
    } else {
      constexpr int kPieces = kWin / 16;  // 16-byte pieces of a window
      for (int c = tid; c < KT * kPieces; c += kThreads) {
        const int k = c / kPieces;
        if (t0 + k >= n_tiles) continue;
        const int off = (c - k * kPieces) * 16;
        const int64_t a = window_start(ws, b, t0 + k, n_tiles) + off;
        uint8_t* dst = &win[buf][k][off];
        if (a + 16 <= PB && (reinterpret_cast<uintptr_t>(prow + a) & 15) == 0) {
          __pipeline_memcpy_async(dst, prow + a, 16);
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) dst[i] = a + i < PB ? __ldg(prow + a + i) : uint8_t(0);
        }
      }
      __pipeline_commit();  // one group an item, empty for a thread that copied nothing
    }
  };

  uint32_t parity = 0;  // bit buf: the phase of buffer buf's barrier to wait for
  int buf = 0;
  stage(blockIdx.x, 0);
  for (int it = blockIdx.x; it < n_items; it += gridDim.x, buf ^= 1) {
    const int b = it / n_chunks;
    const int t0 = (it - b * n_chunks) * KT;
    const int32_t* irow = idx + static_cast<int64_t>(b) * L;
    int32_t* orow = out + static_cast<int64_t>(b) * L;

    // this thread's indices of the item's tiles, all loads in flight together
    // (issued before the next item's copies, whose sizes wait on ws)
    int4 s[KT];
    int32_t base[KT];
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int64_t j = static_cast<int64_t>(t0 + k) * kTile + 4 * tid;
      base[k] = t0 + k < n_tiles ? __ldg(ws + static_cast<int64_t>(b) * n_tiles + t0 + k) & ~511
                                 : 0;
      if (vec && j + 3 < L) {
        s[k] = __ldcs(reinterpret_cast<const int4*>(irow + j));
      } else {
        s[k].x = j < L ? irow[j] : 0;
        s[k].y = j + 1 < L ? irow[j + 1] : 0;
        s[k].z = j + 2 < L ? irow[j + 2] : 0;
        s[k].w = j + 3 < L ? irow[j + 3] : 0;
      }
    }
    // the next item's copies, in flight while this one is gathered
    const int next = it + gridDim.x;
    if (next < n_items) stage(next, buf ^ 1);
    else if (!BULK) __pipeline_commit();  // keep one group an item
    if (BULK) {
      bar_wait(&bar[buf], (parity >> buf) & 1u);
      parity ^= 1u << buf;
    } else {
      __pipeline_wait_prior(1);  // this item's group; the next item's may be in flight
    }
    __syncthreads();  // the zero fill (and the threads' copies) are visible

#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int64_t j = static_cast<int64_t>(t0 + k) * kTile + 4 * tid;
      if (j >= L) continue;
      const uint8_t* w = win[buf][k];
      auto pick = [&](int32_t i) {
        int32_t lb = (i - base[k]) >> 2;
        lb = lb < 0 ? 0 : (lb > kWin - 1 ? kWin - 1 : lb);
        return static_cast<int32_t>(w[lb]);
      };
      const int4 v = make_int4(pick(s[k].x), pick(s[k].y), pick(s[k].z), pick(s[k].w));
      if (vec && j + 3 < L) {
        __stcs(reinterpret_cast<int4*>(orow + j), v);
      } else {
        orow[j] = v.x;
        if (j + 1 < L) orow[j + 1] = v.y;
        if (j + 2 < L) orow[j + 2] = v.z;
        if (j + 3 < L) orow[j + 3] = v.w;
      }
    }
    // every thread is done with buffer buf before it is refilled; the fence
    // orders this thread's accesses of it before the next bulk copy's writes
    if (BULK) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
}

template <int KT, int W8V, bool BULK>
int launch(const uint8_t* packed, int64_t PB, const int32_t* idx, const int32_t* ws, int B,
           int64_t L, int n_tiles, int32_t* out, cudaStream_t stream) {
  auto kernel = gather_window_kernel<KT, W8V, BULK>;
  static int per_sm = 0;  // resident blocks an SM holds, asked once per instance
  if (per_sm == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm <= 0) per_sm = 1;
  }
  const int n_chunks = (n_tiles + KT - 1) / KT;
  const int64_t items = static_cast<int64_t>(B) * n_chunks;
  if (items <= 0) return 0;
  const int64_t cap = static_cast<int64_t>(sm_count()) * per_sm;
  const int grid = static_cast<int>(items < cap ? items : cap);
  const bool vec = L % 4 == 0 && (reinterpret_cast<uintptr_t>(idx) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  kernel<<<grid, kThreads, 0, stream>>>(packed, PB, idx, ws, L, n_tiles, n_chunks,
                                        static_cast<int>(items), vec, out);
  return static_cast<int>(cudaGetLastError());
}

template <int KT, int W8V>
int launch_copy(bool bulk, const uint8_t* packed, int64_t PB, const int32_t* idx,
                const int32_t* ws, int B, int64_t L, int n_tiles, int32_t* out,
                cudaStream_t stream) {
  return bulk ? launch<KT, W8V, true>(packed, PB, idx, ws, B, L, n_tiles, out, stream)
              : launch<KT, W8V, false>(packed, PB, idx, ws, B, L, n_tiles, out, stream);
}

}  // namespace

// The launcher alone chooses the copy route: TMA bulk copies when the packed
// rows' base and length are multiples of 16 bytes, the threads' copies
// otherwise.  *bulk gets the route taken (1 bulk, 0 threads).
extern "C" int launch_gather_window(int kt, int w8v, const void* packed, int64_t PB,
                                    const void* idx, const void* ws, int B, int64_t L,
                                    int n_tiles, void* out, void* stream, int* bulk) {
  auto p = static_cast<const uint8_t*>(packed);
  auto i = static_cast<const int32_t*>(idx);
  auto s = static_cast<const int32_t*>(ws);
  auto o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool b = PB % 16 == 0 && (reinterpret_cast<uintptr_t>(packed) & 15) == 0;
  *bulk = b;
  if (kt == 4 && w8v == 8) return launch_copy<4, 8>(b, p, PB, i, s, B, L, n_tiles, o, st);
  if (kt == 4 && w8v == 4) return launch_copy<4, 4>(b, p, PB, i, s, B, L, n_tiles, o, st);
  if (kt == 8 && w8v == 4) return launch_copy<8, 4>(b, p, PB, i, s, B, L, n_tiles, o, st);
  return kUnsupported;
}
