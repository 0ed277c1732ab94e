// The aligned walk for a FIXED number of steps, with parts of the step
// switched off or done another way: the measuring kernels of the walk.
//
// Replaces the JAX package's two TPU experiment kernels
// bench/micro_walk8.py::make(variant) (which part of a step costs what:
// the threefry hashes, the table lookups, the event store) and
// bench/micro_walk9.py::make(variant) (how the match-length row is selected).
// What they compute is exactly ops/walk_ablate.py::fixed_walk_plain.
//
// Every lane starts at pos = prev_match = first_match, state 0, with the
// same m_ref (10**8 in the experiments, so that every lane takes every step);
// step t (from 1) draws three uniforms from fold_in(walk_key, t); the step is
// aligned_walk_kernel's (walk.cu); each step's event word is stored
// STEP-MAJOR, ev[(t - 1) * B + lane] (the TPU kernel's [E, B] output); the
// result is pos + l_new + n_events per lane.  The words are also folded
// (xor) into one more per-lane output, so that a variant without the store
// still has to compute them.
//
// The switches:
//   THREEFRY    false: the three uniforms are the constant 0.5
//   ERR_TABLES  false: etype = (u_err < 0.5), elen = 1 + etype, no lookups in
//               the transition and mixture tables
//   MATCH       how mstep comes from (bin, u_match):
//               kScan    count over all K breakpoints of the bin's row in
//                        shared memory (what walk.cu does)
//               kSearch  a search over the row's n_bk sorted breakpoints
//                        in shared memory (a 32-ary search by the warp)
//               kGlobal  the same search through the read-only cache, the
//                        match tables not staged in shared memory
//               kNone    no table work: mstep = int(u_match * 20)
//   STORE       false: no event store
//
// One kernel, the aligned walk's own design: one warp per read lane
// (fixed_walk_warp_kernel), so what the step ablation (K6) splits a step
// into is the step that the paths run, and the row-select experiment (K7)
// asks its question on that step: does a search of the match row beat the
// ballot and reduction that walk.cu's scan uses?  On a TPU the second
// experiment asked how to select one row of the match table exactly on the
// matrix unit (one-hot products); a lane here indexes its row, so those
// products have no counterpart and the question becomes how the warp
// searches the row.  Both go through one launcher, launch_fixed_walk_warp.
//
// Bound by integer operations, like walk.cu: four hashes of 72 operations per
// step.  Measured on an NVIDIA H100 80GB HBM3 (700 W) at the ablation's shape
// (1,024 lanes, 8,192 steps): `full` 2.333 ms, 285 ns per serial step, where
// the first design, one thread per lane, took 20.842 ms (PERF.md, which
// also holds the row-select variants' times).  Built with nvcc for sm_90a,
// plain C interface, bound with ctypes.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

using walk_common::draw;
using walk_common::fold;
using walk_common::kFullWarp;
using walk_common::kRowGroup;
using walk_common::round_up_group;
using walk_common::round_up_warp;
using walk_common::share_le;
using walk_common::share_less;
using walk_common::warp_count_le;

enum Match { kNone = 0, kScan = 1, kSearch = 2, kGlobal = 3 };

template <bool LDG>
__device__ __forceinline__ float row_entry(const float* row, int i) {
  return LDG ? __ldg(row + i) : row[i];
}

// count(row[i] <= u) over the first n entries of a NON-DECREASING row, by the
// whole warp: a 32-ary search.  While more than 32 entries are left, thread i
// tests the last entry of segment i of 32 segments of s = ceil(n / 32)
// entries; the ballot's count c says that the first min(c * s, n) entries are
// <= u and that the answer lies in the next segment, which the loop searches
// next.  The last <= 32 entries take one ballot.  At n <= 1,024 that is two
// dependent loads and two ballots.  The loop is the same on every thread (n
// and lo are warp-uniform).  All threads of the warp must call it together,
// with the same row, n and u.
template <bool LDG>
__device__ __forceinline__ int warp_upper_bound(const float* row, int n, float u, int lane) {
  int lo = 0;
  while (n > 32) {
    const int s = (n + 31) >> 5;
    const int last = min((lane + 1) * s, n) - 1;
    const int c = __popc(__ballot_sync(kFullWarp, row_entry<LDG>(row, lo + last) <= u));
    const int skip = min(c * s, n);
    lo += skip;
    n = min(skip + s, n) - skip;
  }
  return lo + __popc(__ballot_sync(kFullWarp, lane < n && row_entry<LDG>(row, lo + lane) <= u));
}

// --- the fixed-step walk: one warp per read lane ------------------------------

constexpr int kWarpLanes = 8;  // warps (read lanes) a block
// The kernel is specialised on the groups of kRowGroup entries its
// error-length rows (GL) and match-length rows (GM) are padded to, 1 or 2
// each, as walk.cu's aligned walk is; GL = GM = 0 takes any table size.  GM
// matters only where the match row is scanned: the searches take GM = 1.
constexpr int kFastGroups = 2;

__host__ __device__ __forceinline__ int row_pad(int groups, int n) {
  return groups > 0 ? groups * kRowGroup : round_up_group(n);
}

// The fixed-step walk with aligned_walk_kernel's step (walk.cu): one warp per
// lane, kWarpLanes lanes a block.  At the start of each chunk of 32 steps
// thread i hashes step t0 + i and keeps its three uniforms; step t0 + k takes
// them by shuffle from thread k.  The transition row and the match-length
// bins are counted with one ballot each (thread i holds entry i); the
// error-length row and the match-length row are split across the warp in
// groups of kRowGroup entries, their loads in flight together, and summed
// with one __reduce_add_sync each (kScan).  kSearch and kGlobal find the
// match-row count by warp_upper_bound over the row's n_bk sorted breakpoints
// instead, in shared memory or through the read-only cache (the match tables
// then not staged).  Every thread runs the state arithmetic, so every thread
// holds the same state.  A switched-off table group is neither staged nor
// read, so the warp never waits on it.
//
// The store: thread k keeps the word of step t0 + k.  The block writes its
// lanes' words of the chunk into a [32 steps x kWarpLanes] tile in shared
// memory, and after one __syncthreads thread i stores step i / kWarpLanes of
// lane i % kWarpLanes: each step's kWarpLanes words are one contiguous run of
// 32 bytes (one sector), where a warp storing its own 32 steps would write 32
// sectors 4 bytes each.  Two tiles alternate, so one barrier a chunk does.
// Warps past B keep to the barriers and compute nothing.
template <bool THREEFRY, bool ERR_TABLES, int MATCH, bool STORE, int GL, int GM>
__global__ void __launch_bounds__(kWarpLanes * 32) fixed_walk_warp_kernel(
    const uint32_t* __restrict__ wk,          // [B, 2] walk keys
    int m_ref, int first_match,
    const float* __restrict__ cdf_t, int n_t, // [3, n_t]
    const int32_t* __restrict__ bin_lo,       // [nb]
    const float* __restrict__ breaks,         // [nb, K]
    const int32_t* __restrict__ vals,         // [nb, K]
    const int32_t* __restrict__ n_bk,         // [nb]
    int nb, int K,
    const float* __restrict__ cum,            // [7, 3]
    int B, int E,
    int32_t* __restrict__ ev,                 // [E, B] step-major
    int32_t* __restrict__ result_out,         // [B] pos + l_new + n_events
    int32_t* __restrict__ fold_out) {         // [B] xor of the lane's words
  constexpr bool kMatch = MATCH != kNone;                  // bins and a match row
  constexpr bool kStaged = MATCH == kScan || MATCH == kSearch;  // match rows in shared memory
  constexpr bool kFast = GL > 0 && GM > 0;
  // a scanned match row is padded to its groups, a searched one is not
  const int nt_pad = row_pad(GL, n_t), k_pad = MATCH == kScan ? row_pad(GM, K) : K;
  const int nb_pad = round_up_warp(nb);
  const float inf = __int_as_float(0x7F800000);
  // shared tables, the counted rows padded with values the compares never
  // accept (walk_common.cuh); the layout of walk.cu's aligned walk
  extern __shared__ float4 s_tables[];
  float* s_cdf = reinterpret_cast<float*>(s_tables);            // [3, nt_pad]
  float* s_breaks = s_cdf + 3 * nt_pad;                         // [nb, k_pad] if staged
  int32_t* s_vals = reinterpret_cast<int32_t*>(s_breaks + (kStaged ? nb * k_pad : 0));
  int32_t* s_binlo = s_vals + (kStaged ? nb * K : 0);           // [nb_pad]
  int32_t* s_nbk = s_binlo + nb_pad;                            // [nb]
  __shared__ int32_t s_ev[2][32][kWarpLanes + 1];  // the chunk's words (padded: no conflicts)
  if (ERR_TABLES)
    for (int i = threadIdx.x; i < 3 * nt_pad; i += blockDim.x) {
      const int r = i / nt_pad, c = i - r * nt_pad;
      s_cdf[i] = c < n_t ? cdf_t[r * n_t + c] : inf;
    }
  if (kStaged) {
    for (int i = threadIdx.x; i < nb * k_pad; i += blockDim.x) {
      const int r = i / k_pad, c = i - r * k_pad;
      s_breaks[i] = c < K ? breaks[r * K + c] : inf;
    }
    for (int i = threadIdx.x; i < nb * K; i += blockDim.x) s_vals[i] = vals[i];
  }
  if (kMatch) {
    for (int i = threadIdx.x; i < nb_pad; i += blockDim.x)
      s_binlo[i] = i < nb ? bin_lo[i] : INT_MAX;
    for (int i = threadIdx.x; i < nb; i += blockDim.x) s_nbk[i] = n_bk[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarpLanes + warp;
  const bool live = b < B;  // whole warps: b is the warp's lane
  const float my_cum = ERR_TABLES && lane < 21 ? cum[lane] : inf;
  const int my_binlo = kMatch && kFast ? s_binlo[lane] : 0;
  const int g_len = nt_pad / kRowGroup, g_match = MATCH == kScan ? k_pad / kRowGroup : 0;
  const uint32_t k0 = live && THREEFRY ? wk[2 * b] : 0u;
  const uint32_t k1 = live && THREEFRY ? wk[2 * b + 1] : 0u;
  int pos = first_match;
  int middle = m_ref;
  int lnew = m_ref;
  int state = 0;
  int pm = first_match;
  int n = 0;
  uint32_t acc = 0u;

  for (int t0 = 1, buf = 0; t0 <= E; t0 += 32, buf ^= 1) {
    const int steps = min(32, E - t0 + 1);
    uint32_t my_word = 0;
    if (live) {
      float my_err = 0.5f, my_len = 0.5f, my_match = 0.5f;
      if (THREEFRY) {  // this thread's step of the chunk: t0 + lane
        uint32_t f0, f1;
        fold(k0, k1, static_cast<uint32_t>(t0 + lane), f0, f1);
        my_err = draw(f0, f1, 0u);
        my_len = draw(f0, f1, 1u);
        my_match = draw(f0, f1, 2u);
      }
      for (int k = 0; k < steps; ++k) {
        const float u_err = THREEFRY ? __shfl_sync(kFullWarp, my_err, k) : 0.5f;
        const float u_len = THREEFRY ? __shfl_sync(kFullWarp, my_len, k) : 0.5f;
        const float u_match = THREEFRY ? __shfl_sync(kFullWarp, my_match, k) : 0.5f;
        const bool active = pos < middle;

        // the match-length bin of the previous match: count(bin_lo <= pm)
        int bin = 0;
        if (kMatch) {
          const int bc = kFast ? __popc(__ballot_sync(kFullWarp, my_binlo <= pm))
                               : warp_count_le(s_binlo, nb_pad, pm, lane);
          bin = min(max(bc - 1, 0), nb - 1);
        }
        // error type: min(count(cum[state] <= u), 2) over entries 3 * state ..
        int et;
        if (ERR_TABLES) {
          const bool in_row = static_cast<unsigned>(lane - 3 * state) < 3u;
          et = min(__popc(__ballot_sync(kFullWarp, in_row && my_cum <= u_err)), 2);
        } else {
          et = u_err < 0.5f ? 1 : 0;
        }

        // count(cdf[et] < u_len), and (kScan) count(breaks[bin] <= u_match)
        const float* len_row = s_cdf + et * nt_pad;
        const float* match_row = s_breaks + bin * k_pad;
        int c_len = 0, c_match = 0;
        if (kFast) {
#pragma unroll
          for (int g = 0; g < (GL > GM ? GL : GM); ++g) {
            if (ERR_TABLES && g < GL) c_len += share_less(len_row, g, u_len, lane);
            if (MATCH == kScan && g < GM) c_match += share_le(match_row, g, u_match, lane);
          }
        } else {
          for (int g = 0; g < max(g_len, g_match); ++g) {
            if (ERR_TABLES && g < g_len) c_len += share_less(len_row, g, u_len, lane);
            if (MATCH == kScan && g < g_match) c_match += share_le(match_row, g, u_match, lane);
          }
        }
        const int elen = ERR_TABLES ? 1 + __reduce_add_sync(kFullWarp, c_len) : 1 + et;
        int mstep;
        if (MATCH == kScan) {
          const int c2 = __reduce_add_sync(kFullWarp, c_match);
          mstep = s_vals[bin * K + min(max(c2 - 1, 0), s_nbk[bin] - 1)];
        } else if (kMatch) {  // kSearch, kGlobal
          const int nk = s_nbk[bin];
          const int c2 = MATCH == kGlobal
                             ? warp_upper_bound<true>(breaks + bin * K, nk, u_match, lane)
                             : warp_upper_bound<false>(match_row, nk, u_match, lane);
          const int idx = bin * K + min(max(c2 - 1, 0), nk - 1);
          mstep = MATCH == kGlobal ? __ldg(vals + idx) : s_vals[idx];
        } else {
          mstep = static_cast<int>(u_match * 20.0f);
        }
        if (pm == 0 && mstep == 0) mstep = 1;

        const bool is_ins = et == 1;
        const bool is_del = et == 2;
        const int e_pos2x = is_ins ? 2 * pos - 1 : 2 * pos;
        const int pos_after = pos + (is_ins ? 0 : elen);
        const int over1 = max(pos_after - middle, 0);
        int lnew_n = lnew + (is_ins ? elen : (is_del ? -elen : 0)) + over1;
        int middle_n = max(middle, is_ins ? middle : pos_after);
        const int over2 = max(pos_after + mstep - middle_n, 0);
        lnew_n += over2;
        middle_n = max(middle_n, pos_after + mstep);

        const uint32_t word = static_cast<uint32_t>(e_pos2x) |
                              (static_cast<uint32_t>(elen) << 19) |
                              (static_cast<uint32_t>(et) << 30);
        acc ^= word;
        if (lane == k) my_word = word;
        if (active) {
          pos = pos_after + mstep;
          middle = middle_n;
          lnew = lnew_n;
          state = et + 1 + (mstep == 0 ? 3 : 0);
          pm = mstep;
          ++n;
        }
      }
    }
    if (STORE) {
      s_ev[buf][lane][warp] = static_cast<int32_t>(my_word);
      __syncthreads();
      const int k = threadIdx.x / kWarpLanes, l = threadIdx.x - k * kWarpLanes;
      const int bl = blockIdx.x * kWarpLanes + l;
      if (k < steps && bl < B) ev[static_cast<size_t>(t0 - 1 + k) * B + bl] = s_ev[buf][k][l];
    }
  }
  if (live && lane == 0) {
    result_out[b] = pos + lnew + n;
    fold_out[b] = static_cast<int32_t>(acc);
  }
}

template <bool THREEFRY, bool ERR_TABLES, int MATCH, bool STORE>
int launch_warp(const void* wk, int m_ref, int first_match, const void* cdf_t, int n_t,
                const void* bin_lo, const void* breaks, const void* vals, const void* n_bk,
                int nb, int K, const void* cum, int B, int E, void* ev, void* result,
                void* fold_out, void* stream) {
  // the specialised kernel where the tables fit its rows, else the general one
  constexpr bool kScanRow = MATCH == kScan;
  constexpr bool kStaged = MATCH == kScan || MATCH == kSearch;
  const int gl = n_t <= kRowGroup ? 1 : (n_t <= kFastGroups * kRowGroup ? 2 : 0);
  const int gm = !kScanRow ? 1 : (K <= kRowGroup ? 1 : (K <= kFastGroups * kRowGroup ? 2 : 0));
  const bool fast = gl > 0 && gm > 0 && nb <= 32;
  using Kernel = decltype(&fixed_walk_warp_kernel<THREEFRY, ERR_TABLES, MATCH, STORE, 0, 0>);
  Kernel kernel = fixed_walk_warp_kernel<THREEFRY, ERR_TABLES, MATCH, STORE, 0, 0>;
  if (fast) {
    if constexpr (kScanRow) {
      const Kernel fast_kernels[2][2] = {
          {fixed_walk_warp_kernel<THREEFRY, ERR_TABLES, MATCH, STORE, 1, 1>,
           fixed_walk_warp_kernel<THREEFRY, ERR_TABLES, MATCH, STORE, 1, 2>},
          {fixed_walk_warp_kernel<THREEFRY, ERR_TABLES, MATCH, STORE, 2, 1>,
           fixed_walk_warp_kernel<THREEFRY, ERR_TABLES, MATCH, STORE, 2, 2>}};
      kernel = fast_kernels[gl - 1][gm - 1];
    } else {
      const Kernel fast_kernels[2] = {
          fixed_walk_warp_kernel<THREEFRY, ERR_TABLES, MATCH, STORE, 1, 1>,
          fixed_walk_warp_kernel<THREEFRY, ERR_TABLES, MATCH, STORE, 2, 1>};
      kernel = fast_kernels[gl - 1];
    }
  }
  const int nt_pad = row_pad(fast ? gl : 0, n_t);
  const int k_pad = kScanRow ? row_pad(fast ? gm : 0, K) : K;
  const int nb_pad = (nb + 31) & ~31;
  const size_t smem = sizeof(float) * 3 * nt_pad +
                      (kStaged ? sizeof(float) * nb * k_pad + sizeof(int32_t) * nb * K : 0) +
                      (MATCH != kNone ? sizeof(int32_t) * (nb_pad + nb) : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (B + kWarpLanes - 1) / kWarpLanes;
  kernel<<<blocks, kWarpLanes * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wk), m_ref, first_match, static_cast<const float*>(cdf_t),
      n_t, static_cast<const int32_t*>(bin_lo), static_cast<const float*>(breaks),
      static_cast<const int32_t*>(vals), static_cast<const int32_t*>(n_bk), nb, K,
      static_cast<const float*>(cum), B, E, static_cast<int32_t*>(ev),
      static_cast<int32_t*>(result), static_cast<int32_t*>(fold_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both experiments (K6 and K7): threefry, err_tables, store 0 or 1; match 0
// none, 1 scan, 2 search, 3 global.  Returns cudaGetLastError(), or -1 for a
// combination that is not instantiated: the switches of ops/walk_ablate.py's
// ABLATION_VARIANTS and ROW_SELECT_VARIANTS, eight, each on the
// warp-per-lane kernel.
extern "C" int launch_fixed_walk_warp(int threefry, int err_tables, int match, int store,
                                      const void* wk, int m_ref, int first_match,
                                      const void* cdf_t, int n_t, const void* bin_lo,
                                      const void* breaks, const void* vals, const void* n_bk,
                                      int nb, int K, const void* cum, int B, int E, void* ev,
                                      void* result, void* fold_out, void* stream) {
  if (B <= 0 || E <= 0) return 0;
#define WARP_WALK_CASE(T, R, M, S)                                                          \
  if (threefry == T && err_tables == R && match == M && store == S)                         \
    return launch_warp<T != 0, R != 0, M, S != 0>(wk, m_ref, first_match, cdf_t, n_t,       \
                                                  bin_lo, breaks, vals, n_bk, nb, K, cum,   \
                                                  B, E, ev, result, fold_out, stream);
  WARP_WALK_CASE(1, 1, kScan, 1)    // K6 full, onlytables; K7 scan
  WARP_WALK_CASE(0, 1, kScan, 1)    // K6 nothreefry
  WARP_WALK_CASE(1, 1, kScan, 0)    // K6 nodma
  WARP_WALK_CASE(1, 0, kScan, 1)    // K6 onlymatch
  WARP_WALK_CASE(1, 0, kNone, 1)    // K6 min
  WARP_WALK_CASE(1, 1, kSearch, 1)  // K7 search
  WARP_WALK_CASE(1, 1, kGlobal, 1)  // K7 global
  WARP_WALK_CASE(1, 1, kNone, 1)    // K7 min
#undef WARP_WALK_CASE
  return -1;
}
