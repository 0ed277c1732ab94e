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
// STEP-MAJOR, ev[(t - 1) * B + lane], so that a warp's 32 stores are one
// 128-byte line (walk.cu stores lane-major rows); the result is
// pos + l_new + n_events per lane.  The words are also folded (xor) into one
// more per-lane output, so that a variant without the store still has to
// compute them.
//
// One templated kernel; the switches:
//   THREEFRY    false: the three uniforms are the constant 0.5
//   ERR_TABLES  false: etype = (u_err < 0.5), elen = 1 + etype, no lookups in
//               the transition and mixture tables
//   MATCH       how mstep comes from (bin, u_match):
//               kScan    count over all K breakpoints of the bin's row in
//                        shared memory (what walk.cu does)
//               kSearch  binary search over the row's n_bk sorted
//                        breakpoints in shared memory
//               kGlobal  the same search through the read-only cache, the
//                        match tables not staged in shared memory
//               kNone    no table work: mstep = int(u_match * 20)
//   STORE       false: no event store
// On a TPU the second experiment asked how to select one row of the match
// table exactly on the matrix unit (one-hot products); a lane here indexes
// its row, so those products have no counterpart and the question becomes how
// the lane searches the row.
//
// Bound by integer operations, like walk.cu: four hashes of 72 operations per
// step.  Built with nvcc for sm_90a, plain C interface, bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

using walk_common::draw;
using walk_common::fold;
using walk_common::mixture_len;

enum Match { kNone = 0, kScan = 1, kSearch = 2, kGlobal = 3 };

// count(row[i] <= u) over a non-decreasing row of n entries
__device__ __forceinline__ int upper_bound(const float* row, int n, float u) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] <= u) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound_ldg(const float* row, int n, float u) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) <= u) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <bool THREEFRY, bool ERR_TABLES, int MATCH, bool STORE>
__global__ void fixed_walk_kernel(
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
  extern __shared__ uint32_t smem[];
  float* s_cdf = reinterpret_cast<float*>(smem);
  float* s_breaks = s_cdf + 3 * n_t;
  int32_t* s_vals = reinterpret_cast<int32_t*>(s_breaks + nb * K);
  int32_t* s_binlo = s_vals + nb * K;
  int32_t* s_nbk = s_binlo + nb;
  float* s_cum = reinterpret_cast<float*>(s_nbk + nb);
  if (ERR_TABLES)
    for (int i = threadIdx.x; i < 3 * n_t; i += blockDim.x) s_cdf[i] = cdf_t[i];
  if (MATCH == kScan || MATCH == kSearch)
    for (int i = threadIdx.x; i < nb * K; i += blockDim.x) {
      s_breaks[i] = breaks[i];
      s_vals[i] = vals[i];
    }
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    s_binlo[i] = bin_lo[i];
    s_nbk[i] = n_bk[i];
  }
  for (int i = threadIdx.x; i < 21; i += blockDim.x) s_cum[i] = cum[i];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint32_t k0 = wk[2 * b], k1 = wk[2 * b + 1];
  int pos = first_match;
  int middle = m_ref;
  int lnew = m_ref;
  int state = 0;
  int pm = first_match;
  int n = 0;
  uint32_t acc = 0u;

  for (int t = 1; t <= E; ++t) {
    float u_err = 0.5f, u_len = 0.5f, u_match = 0.5f;
    if (THREEFRY) {
      uint32_t f0, f1;
      fold(k0, k1, static_cast<uint32_t>(t), f0, f1);
      u_err = draw(f0, f1, 0u);
      u_len = draw(f0, f1, 1u);
      u_match = draw(f0, f1, 2u);
    }
    const bool active = pos < middle;

    int et, elen;
    if (ERR_TABLES) {
      et = (s_cum[state * 3] <= u_err) + (s_cum[state * 3 + 1] <= u_err) +
           (s_cum[state * 3 + 2] <= u_err);
      et = min(et, 2);
      elen = mixture_len(s_cdf, n_t, et, u_len);
    } else {
      et = u_err < 0.5f ? 1 : 0;
      elen = 1 + et;
    }

    int mstep;
    if (MATCH == kNone) {
      mstep = static_cast<int>(u_match * 20.0f);
    } else {
      int bc = 0;
      for (int i = 0; i < nb; ++i) bc += (s_binlo[i] <= pm);
      const int bin = min(max(bc - 1, 0), nb - 1);
      const int nk = s_nbk[bin];
      int c2;
      if (MATCH == kScan) {
        const float* br = s_breaks + bin * K;
        c2 = 0;
        for (int i = 0; i < K; ++i) c2 += (br[i] <= u_match);
      } else if (MATCH == kSearch) {
        c2 = upper_bound(s_breaks + bin * K, nk, u_match);
      } else {
        c2 = upper_bound_ldg(breaks + bin * K, nk, u_match);
      }
      const int idx = min(max(c2 - 1, 0), nk - 1);
      mstep = MATCH == kGlobal ? __ldg(vals + bin * K + idx) : s_vals[bin * K + idx];
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

    const uint32_t word = static_cast<uint32_t>(e_pos2x) | (static_cast<uint32_t>(elen) << 19) |
                          (static_cast<uint32_t>(et) << 30);
    acc ^= word;
    if (STORE) ev[static_cast<size_t>(t - 1) * B + b] = static_cast<int32_t>(word);
    if (active) {
      pos = pos_after + mstep;
      middle = middle_n;
      lnew = lnew_n;
      state = et + 1 + (mstep == 0 ? 3 : 0);
      pm = mstep;
      ++n;
    }
  }
  result_out[b] = pos + lnew + n;
  fold_out[b] = static_cast<int32_t>(acc);
}

constexpr int kThreads = 128;

template <bool THREEFRY, bool ERR_TABLES, int MATCH, bool STORE>
int launch(const void* wk, int m_ref, int first_match, const void* cdf_t, int n_t,
           const void* bin_lo, const void* breaks, const void* vals, const void* n_bk, int nb,
           int K, const void* cum, int B, int E, void* ev, void* result, void* fold_out,
           void* stream) {
  auto kernel = fixed_walk_kernel<THREEFRY, ERR_TABLES, MATCH, STORE>;
  const size_t smem = sizeof(float) * 3 * n_t + sizeof(float) * nb * K +
                      sizeof(int32_t) * nb * K + sizeof(int32_t) * 2 * nb + sizeof(float) * 21;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (B + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wk), m_ref, first_match, static_cast<const float*>(cdf_t),
      n_t, static_cast<const int32_t*>(bin_lo), static_cast<const float*>(breaks),
      static_cast<const int32_t*>(vals), static_cast<const int32_t*>(n_bk), nb, K,
      static_cast<const float*>(cum), B, E, static_cast<int32_t*>(ev),
      static_cast<int32_t*>(result), static_cast<int32_t*>(fold_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// threefry, err_tables, store: 0 or 1; match: 0 none, 1 scan, 2 search,
// 3 global.  Returns cudaGetLastError(), or -1 for a combination that is not
// instantiated (the experiments use eight).
extern "C" int launch_fixed_walk(int threefry, int err_tables, int match, int store,
                                 const void* wk, int m_ref, int first_match, const void* cdf_t,
                                 int n_t, const void* bin_lo, const void* breaks,
                                 const void* vals, const void* n_bk, int nb, int K,
                                 const void* cum, int B, int E, void* ev, void* result,
                                 void* fold_out, void* stream) {
  if (B <= 0 || E <= 0) return 0;
#define FIXED_WALK_CASE(T, R, M, S)                                                         \
  if (threefry == T && err_tables == R && match == M && store == S)                         \
    return launch<T != 0, R != 0, M, S != 0>(wk, m_ref, first_match, cdf_t, n_t, bin_lo,    \
                                             breaks, vals, n_bk, nb, K, cum, B, E, ev,      \
                                             result, fold_out, stream);
  FIXED_WALK_CASE(1, 1, kScan, 1)    // full, onlytables; scan
  FIXED_WALK_CASE(0, 1, kScan, 1)    // nothreefry
  FIXED_WALK_CASE(1, 1, kScan, 0)    // nodma
  FIXED_WALK_CASE(1, 0, kScan, 1)    // onlymatch
  FIXED_WALK_CASE(1, 0, kNone, 1)    // min (ablation)
  FIXED_WALK_CASE(1, 1, kSearch, 1)  // search
  FIXED_WALK_CASE(1, 1, kGlobal, 1)  // global
  FIXED_WALK_CASE(1, 1, kNone, 1)    // min (row select)
#undef FIXED_WALK_CASE
  return -1;
}
