// Error-state walks of the genome slice: the aligned walk with one warp per
// read lane, the unaligned walk with four warps per read lane.
//
// Replaces the JAX package's TPU kernels ops/walk_pallas.py::error_walk_pallas
// (aligned walk) and ops/walk_pallas.py::unaligned_walk_pallas (unaligned
// walk).  What they compute is exactly the plain versions in
// ops/walk_cuda.py (aligned_steps_plain / unaligned_steps_plain), which are
// held against the JAX package's XLA walks ops/error_walk.py::error_walk and
// ::unaligned_walk.  The Pallas kernels' one-hot MXU table selects exist only
// because of the TPU and are not carried over: here a lane indexes its table
// rows directly.
//
// What bounds them on an H100: not bytes.  A lane reads its key and two
// lengths and writes one 4-byte word per event; the tables (under 25 KB at
// the bench's shapes) are read from shared memory.  The work is integer
// arithmetic: three or four threefry-2x32 hashes (20 rounds each) and the
// table lookups per step, in a loop whose length is the lane's own event
// count.
//
// The aligned walk's step depends on the one before it (the Markov state and
// the previous match length choose its rows), so a launch takes at least as
// long as its longest lane's chain of steps.  It runs one warp per lane, 4
// lanes a block (B=2,048 is 512 blocks, one wave on 132 SMs), and takes the
// hashes and the table scans off each step's serial chain: the 32 threads of
// the warp hash 32 steps at once and split every table row between them
// (aligned_walk_kernel below).
//
// The unaligned walk has no such chain: a step's kind and length come from
// its own uniforms, and the only thing carried is the position, which grows
// by the step's advance.  So each warp of a lane takes 32 steps at once (four
// warps a lane: 128 steps a round), each thread its own step from hash to
// event word, and the position of every step is a prefix sum of the advances
// (unaligned_walk_kernel below).
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (no PyTorch headers) and bound with ctypes; every launcher returns
// cudaGetLastError().  The walk keys are passed as the [B, 2] int64 tensor
// the walks hold them in; a kernel reads the low 32-bit word of each (the
// uint32 key word), so no conversion runs before a launch.

#include <climits>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

using walk_common::count_less_sorted;
using walk_common::draw;
using walk_common::fold;
using walk_common::kFullWarp;
using walk_common::kRowGroup;
using walk_common::round_up_group;
using walk_common::round_up_warp;
using walk_common::share_le;
using walk_common::share_less;
using walk_common::warp_count_le;

constexpr int kAlignedLanes = 4;  // the aligned walk: warps (read lanes) a block

// one 4-byte word from device memory into shared memory, asynchronously
template <typename V>
__device__ __forceinline__ void copy_word(V* dst, const V* src) {
  __pipeline_memcpy_async(dst, src, sizeof(V));
}

// The aligned walk's kernel is specialised on the groups of kRowGroup
// entries its error-length rows (GL) and match-length rows (GM) are padded
// to, 1 or 2 each (n_t and K at most 256, at most 32 bins: the bench's
// tables and the fixtures' have n_t = 128, K = 150, 15 bins); GL = GM = 0
// takes any table size.
constexpr int kFastGroups = 2;

__host__ __device__ __forceinline__ int row_pad(int groups, int n) {
  return groups > 0 ? groups * kRowGroup : round_up_group(n);
}

// The aligned walk, one warp per read lane (kAlignedLanes lanes a block).
//
// The step uniforms depend only on (walk key, t), not on the walk's state, so
// at the start of each chunk of 32 steps thread i hashes step t0 + i (the
// folded key and the three draws) and keeps the uniforms in registers; the
// serial walk then takes step t0 + k's uniforms with a shuffle from thread k,
// and the hash chain is off each step's critical path.  The bits are the
// same as one thread per lane computing them in order.  Every table lookup
// is a warp-parallel count (walk_common.cuh): the transition rows and the
// match-length bins are held in registers (thread i holds entry i) and
// counted with one ballot each; the error-length row and the match-length
// row do not depend on each other, so their groups are read together and
// their loads are in flight at once.  With GL, GM > 0 the rows have exactly
// that many groups and the step is straight-line code.  The state
// arithmetic runs redundantly in every thread, so every thread holds the
// same state and no broadcast is needed.  Thread k keeps the event word of
// step t0 + k; the warp stores the chunk as one coalesced line, masked to
// the steps actually taken.
template <int GL, int GM>
__global__ void __launch_bounds__(kAlignedLanes * 32, 4) aligned_walk_kernel(
    const uint32_t* __restrict__ wk,          // [B, 4]: the [B, 2] int64 keys' words
    const int32_t* __restrict__ m_ref,        // [B]
    const int32_t* __restrict__ first_match,  // [B] prev_match at step 1
    const float* __restrict__ cdf_t, int n_t, // [3, n_t]
    const int32_t* __restrict__ bin_lo,       // [nb]
    const float* __restrict__ breaks,         // [nb, K]
    const int32_t* __restrict__ vals,         // [nb, K]
    const int32_t* __restrict__ n_bk,         // [nb]
    int nb, int K,
    const float* __restrict__ cum,            // [7, 3]
    int B, int E,
    int32_t* __restrict__ ev,                 // [B, E], zero-filled by the caller
    int32_t* __restrict__ pos_out, int32_t* __restrict__ mref_out,
    int32_t* __restrict__ lnew_out, int32_t* __restrict__ nev_out) {
  // shared tables; the counted rows padded to whole groups (the bins to a
  // whole warp) with values the compares never accept (walk_common.cuh)
  constexpr bool kFast = GL > 0 && GM > 0;
  const int nt_pad = row_pad(GL, n_t), k_pad = row_pad(GM, K);
  const int nb_pad = round_up_warp(nb);
  const float inf = __int_as_float(0x7F800000);
  extern __shared__ float4 s_tables[];  // 16-byte aligned: the rows are read as float4
  float* s_cdf = reinterpret_cast<float*>(s_tables);            // [3, nt_pad]
  float* s_breaks = s_cdf + 3 * nt_pad;                         // [nb, k_pad]
  int32_t* s_vals = reinterpret_cast<int32_t*>(s_breaks + nb * k_pad);  // [nb, K]
  int32_t* s_binlo = s_vals + nb * K;                           // [nb_pad]
  int32_t* s_nbk = s_binlo + nb_pad;                            // [nb]
  // every word is copied by an asynchronous 4-byte copy, all of a thread's
  // copies in flight together, and the padding is written directly
  for (int r = 0; r < 3; ++r)
    for (int c = threadIdx.x; c < nt_pad; c += blockDim.x) {
      if (c < n_t) copy_word(s_cdf + r * nt_pad + c, cdf_t + r * n_t + c);
      else s_cdf[r * nt_pad + c] = inf;
    }
  for (int r = 0; r < nb; ++r)
    for (int c = threadIdx.x; c < k_pad; c += blockDim.x) {
      if (c < K) copy_word(s_breaks + r * k_pad + c, breaks + r * K + c);
      else s_breaks[r * k_pad + c] = inf;
    }
  for (int i = threadIdx.x; i < nb * K; i += blockDim.x) copy_word(s_vals + i, vals + i);
  for (int i = threadIdx.x; i < nb_pad; i += blockDim.x) {
    if (i < nb) copy_word(s_binlo + i, bin_lo + i);
    else s_binlo[i] = INT_MAX;
  }
  for (int i = threadIdx.x; i < nb; i += blockDim.x) copy_word(s_nbk + i, n_bk + i);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kAlignedLanes + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp: b is the warp's lane
  // thread i's entries of the transition rows (7 x 3 = 21) and of the bins
  const float my_cum = lane < 21 ? cum[lane] : inf;
  const int my_binlo = s_binlo[lane];
  // groups of the error-length rows and of the match-length rows, and the
  // groups both have
  const int g_len = nt_pad / kRowGroup, g_match = k_pad / kRowGroup;
  const int g_both = min(g_len, g_match);
  const uint32_t k0 = wk[4 * b], k1 = wk[4 * b + 2];  // the low words
  int pos = first_match[b];
  int middle = m_ref[b];
  int lnew = middle;
  int state = 0;
  int pm = pos;
  int n = 0;
  int32_t* ev_row = ev + static_cast<size_t>(b) * E;

  for (int t0 = 1; t0 <= E && pos < middle; t0 += 32) {
    // this thread's step of the chunk: t0 + lane
    uint32_t f0, f1;
    fold(k0, k1, static_cast<uint32_t>(t0 + lane), f0, f1);
    const float my_err = draw(f0, f1, 0u);
    const float my_len = draw(f0, f1, 1u);
    const float my_match = draw(f0, f1, 2u);
    const int steps = min(32, E - t0 + 1);
    uint32_t my_word = 0;
    int k = 0;
    for (; k < steps && pos < middle; ++k) {
      const float u_err = __shfl_sync(kFullWarp, my_err, k);
      const float u_len = __shfl_sync(kFullWarp, my_len, k);
      const float u_match = __shfl_sync(kFullWarp, my_match, k);

      // the match-length bin of the previous match: count(bin_lo <= pm)
      const int bc = kFast ? __popc(__ballot_sync(kFullWarp, my_binlo <= pm))
                           : warp_count_le(s_binlo, nb_pad, pm, lane);
      const int bin = min(max(bc - 1, 0), nb - 1);
      // error type: min(count(cum[state] <= u), 2), the row being entries
      // 3 * state .. 3 * state + 2
      const bool in_row = static_cast<unsigned>(lane - 3 * state) < 3u;
      const int et = min(__popc(__ballot_sync(kFullWarp, in_row && my_cum <= u_err)), 2);

      // count(cdf[et] < u_len) and count(breaks[bin] <= u_match)
      const float* len_row = s_cdf + et * nt_pad;
      const float* match_row = s_breaks + bin * k_pad;
      int c_len = 0, c_match = 0;
      if (kFast) {
#pragma unroll
        for (int g = 0; g < (GL > GM ? GL : GM); ++g) {
          if (g < GL) c_len += share_less(len_row, g, u_len, lane);
          if (g < GM) c_match += share_le(match_row, g, u_match, lane);
        }
      } else {
#pragma unroll 2
        for (int g = 0; g < g_both; ++g) {
          c_len += share_less(len_row, g, u_len, lane);
          c_match += share_le(match_row, g, u_match, lane);
        }
        for (int g = g_both; g < g_len; ++g) c_len += share_less(len_row, g, u_len, lane);
        for (int g = g_both; g < g_match; ++g) c_match += share_le(match_row, g, u_match, lane);
      }
      const int elen = 1 + __reduce_add_sync(kFullWarp, c_len);
      const int c2 = __reduce_add_sync(kFullWarp, c_match);

      const bool is_ins = et == 1;
      const bool is_del = et == 2;
      const int e_pos2x = is_ins ? 2 * pos - 1 : 2 * pos;
      const int pos_after = pos + (is_ins ? 0 : elen);

      // del/mis overshoot extends the reference span
      const int over1 = max(pos_after - middle, 0);
      int lnew_n = lnew + (is_ins ? elen : (is_del ? -elen : 0)) + over1;
      int middle_n = max(middle, is_ins ? middle : pos_after);

      // next match length from the bin of the previous one
      const int idx = min(max(c2 - 1, 0), s_nbk[bin] - 1);
      int mstep = s_vals[bin * K + idx];
      if (pm == 0 && mstep == 0) mstep = 1;
      const int over2 = max(pos_after + mstep - middle_n, 0);
      lnew_n += over2;
      middle_n = max(middle_n, pos_after + mstep);

      const uint32_t word = static_cast<uint32_t>(e_pos2x) |
                            (static_cast<uint32_t>(elen) << 19) |
                            (static_cast<uint32_t>(et) << 30);
      if (lane == k) my_word = word;
      pos = pos_after + mstep;
      middle = middle_n;
      lnew = lnew_n;
      state = et + 1 + (mstep == 0 ? 3 : 0);
      pm = mstep;
    }
    // steps t0 .. t0 + k - 1 are events n .. n + k - 1 (n == t0 - 1)
    if (lane < k) ev_row[n + lane] = static_cast<int32_t>(my_word);
    n += k;
  }
  if (lane == 0) {
    pos_out[b] = pos;
    mref_out[b] = middle;
    lnew_out[b] = lnew;
    nev_out[b] = n;
  }
}

// The two uniforms of unaligned step t (from 0): draws 0 and 1 of
// uniform(fold_in(key, t), (2,)).
__device__ __forceinline__ float2 unaligned_uniforms(uint32_t k0, uint32_t k1, int t) {
  uint32_t f0, f1;
  fold(k0, k1, static_cast<uint32_t>(t), f0, f1);
  return make_float2(draw(f0, f1, 0u), draw(f0, f1, 1u));
}

// The unaligned walk: kUnalignedWarps warps per read lane, one lane a block.
//
// Step t's kind and error length depend only on its own two uniforms, and the
// step advances the position by d_t (0 for an insertion, else its length).
// With P_t the exclusive prefix sum of d, step t is taken exactly when
// t < E and P_t < m_ref: middle_ref changes only at the step that crosses
// m_ref, which is never an insertion, and after it pos == middle_ref.  P is
// non-decreasing, so the taken steps are a prefix.  So each round thread i
// takes step t0 + i (S = 32 W steps a round): its hashes, its kind, its
// length (a binary search of its own type's row in shared memory: the rows
// are non-decreasing, which ops/tables.py::MixtureDevice holds), its advance
// and its event word.  A warp-wide inclusive scan of the advances (five
// shuffles), plus the totals of the warps before it (shared memory, one
// barrier a round), gives each step its P_t; the round's last step says
// whether the lane goes on.  The only value carried from round to round is
// the position at the round's start; the next round's hashes are computed
// before this round's scan, off that chain.  Each taken step stores its
// word, so a warp stores a round as one line, nothing past the lane's last
// step.  At the end, with pos = P_n:
//   middle_ref = max(m_ref, pos),
//   l_new = m_ref + sum of (ins ? len : del ? -len : 0) + max(pos - m_ref, 0),
// the last term being the crossing step's overshoot, added once.  Every sum
// is of integers, so the order does not matter and the words and totals
// equal the plain version's bit for bit.
//
// Four warps a lane were measured against 1, 2 and 8 at every shape a path
// launches (PERF.md, the K2 rows): four is the fastest at B=2,048
// (E=11,904), where one warp a lane leaves the longest lanes' rounds on too
// few warps, and on the transcriptome's unaligned pass (B=512, E=1,984), and
// within a few percent of the fastest at the chimeric gap lanes and at
// B=8,192.
constexpr int kUnalignedWarps = 4;

__global__ void __launch_bounds__(kUnalignedWarps * 32) unaligned_walk_kernel(
    const uint32_t* __restrict__ wk,          // [B, 4]: the [B, 2] int64 keys' words
    const int32_t* __restrict__ m_ref,        // [B]
    const float* __restrict__ cdf_t, int n_t, // [3, n_t], rows non-decreasing
    int B, int E,
    int32_t* __restrict__ ev,                 // [B, E], zero-filled by the caller
    int32_t* __restrict__ pos_out, int32_t* __restrict__ mref_out,
    int32_t* __restrict__ lnew_out, int32_t* __restrict__ nev_out) {
  constexpr int W = kUnalignedWarps;
  constexpr int S = 32 * W;       // steps a round
  extern __shared__ float s_cdf[];  // [3, n_t]
  __shared__ int s_total[2][W];   // each warp's advance in the round (two rounds' buffers)
  __shared__ int s_last[2];       // the advance of the round's last step
  __shared__ int s_sum[3][W];     // each warp's share of the lane's totals
  for (int i = threadIdx.x; i < 3 * n_t; i += blockDim.x) s_cdf[i] = cdf_t[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int i = threadIdx.x;  // this thread's step of each round
  const int m = m_ref[b];
  if (m <= 0) {  // no step
    if (i == 0) {
      pos_out[b] = 0;
      mref_out[b] = m;
      lnew_out[b] = m;
      nev_out[b] = 0;
    }
    return;
  }
  const uint32_t k0 = wk[4 * b], k1 = wk[4 * b + 2];  // the low words
  int32_t* ev_row = ev + static_cast<size_t>(b) * E;
  int carry = 0;                     // the position at the round's first step
  int my_n = 0, my_d = 0, my_s = 0;  // this thread's taken steps: count, advance, l_new change
  float2 u = unaligned_uniforms(k0, k1, i);
  for (int t0 = 0, buf = 0; t0 < E; t0 += S, buf ^= 1) {
    const int t = t0 + i;
    const float2 u_next = unaligned_uniforms(k0, k1, t + S);
    // fixed type probabilities: 0=match 1=mis 2=ins 3=del
    const int kind = (u.x >= 0.4f) + (u.x >= 0.7f) + (u.x >= 0.85f);
    const int et = min(max(kind - 1, 0), 2);
    const int found = 1 + count_less_sorted(s_cdf + et * n_t, n_t, u.y);
    const int elen = kind > 0 ? found : 1;
    const bool is_ins = kind == 2;
    const int d = is_ins ? 0 : elen;
    const int dl = is_ins ? elen : (kind == 3 ? -elen : 0);
    // inclusive prefix of the advances over the warp's steps
    int incl = d;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFullWarp, incl, o);
      if (lane >= o) incl += v;
    }
    // the advance of the round's steps in earlier warps, and of all of them
    if (lane == 31) s_total[buf][warp] = incl;
    if (i == S - 1) s_last[buf] = d;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int v = s_total[buf][w];
      before += w < warp ? v : 0;
      total += v;
    }
    const int p = carry + before + incl - d;  // P_t
    if (t < E && p < m) {  // taken
      const uint32_t word = static_cast<uint32_t>(2 * p + is_ins) |
                            (static_cast<uint32_t>(kind > 0 ? elen : 0) << 19) |
                            (static_cast<uint32_t>(et) << 30);
      ev_row[t] = static_cast<int32_t>(word);
      ++my_n;
      my_d += d;
      my_s += dl;
    }
    // the lane goes on while the round's last step was taken
    if (t0 + S > E || carry + total - s_last[buf] >= m) break;
    carry += total;
    u = u_next;
  }
  const int n = __reduce_add_sync(kFullWarp, my_n);
  const int d_sum = __reduce_add_sync(kFullWarp, my_d);
  const int l_sum = __reduce_add_sync(kFullWarp, my_s);
  if (lane == 0) {
    s_sum[0][warp] = n;
    s_sum[1][warp] = d_sum;
    s_sum[2][warp] = l_sum;
  }
  __syncthreads();
  if (i == 0) {
    int n_all = 0, pos = 0, dsum = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      n_all += s_sum[0][w];
      pos += s_sum[1][w];
      dsum += s_sum[2][w];
    }
    pos_out[b] = pos;
    mref_out[b] = max(m, pos);
    lnew_out[b] = m + dsum + max(pos - m, 0);
    nev_out[b] = n_all;
  }
}

cudaError_t set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" int launch_aligned_walk(const void* wk, const void* m_ref, const void* first_match,
                                   const void* cdf_t, int n_t, const void* bin_lo,
                                   const void* breaks, const void* vals, const void* n_bk,
                                   int nb, int K, const void* cum, int B, int E, void* ev,
                                   void* pos, void* mref, void* lnew, void* nev,
                                   void* stream) {
  if (B <= 0) return 0;
  // the specialised kernel where the tables fit its rows, else the general one
  const int gl = n_t <= kRowGroup ? 1 : (n_t <= kFastGroups * kRowGroup ? 2 : 0);
  const int gm = K <= kRowGroup ? 1 : (K <= kFastGroups * kRowGroup ? 2 : 0);
  const bool fast = gl > 0 && gm > 0 && nb <= 32;
  using Kernel = decltype(&aligned_walk_kernel<0, 0>);
  const Kernel fast_kernels[2][2] = {{aligned_walk_kernel<1, 1>, aligned_walk_kernel<1, 2>},
                                     {aligned_walk_kernel<2, 1>, aligned_walk_kernel<2, 2>}};
  const Kernel kernel = fast ? fast_kernels[gl - 1][gm - 1] : aligned_walk_kernel<0, 0>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  // the kernel's shared tables, the counted rows padded (walk_common.cuh)
  const int nt_pad = row_pad(fast ? gl : 0, n_t), k_pad = row_pad(fast ? gm : 0, K);
  const int nb_pad = (nb + 31) & ~31;
  const size_t smem = sizeof(float) * (3 * nt_pad + nb * k_pad) + sizeof(int32_t) * nb * K +
                      sizeof(int32_t) * (nb_pad + nb);
  cudaError_t e = set_smem(fn, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // shared memory bounds the blocks an SM holds: ask for the largest carve-out
  e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (B + kAlignedLanes - 1) / kAlignedLanes;
  kernel<<<blocks, kAlignedLanes * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wk), static_cast<const int32_t*>(m_ref),
      static_cast<const int32_t*>(first_match), static_cast<const float*>(cdf_t), n_t,
      static_cast<const int32_t*>(bin_lo), static_cast<const float*>(breaks),
      static_cast<const int32_t*>(vals), static_cast<const int32_t*>(n_bk), nb, K,
      static_cast<const float*>(cum), B, E, static_cast<int32_t*>(ev),
      static_cast<int32_t*>(pos), static_cast<int32_t*>(mref), static_cast<int32_t*>(lnew),
      static_cast<int32_t*>(nev));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_unaligned_walk(const void* wk, const void* m_ref, const void* cdf_t,
                                     int n_t, int B, int E, void* ev, void* pos, void* mref,
                                     void* lnew, void* nev, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = sizeof(float) * 3 * n_t;
  cudaError_t e = set_smem(reinterpret_cast<const void*>(unaligned_walk_kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  unaligned_walk_kernel<<<B, kUnalignedWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wk), static_cast<const int32_t*>(m_ref),
      static_cast<const float*>(cdf_t), n_t, B, E, static_cast<int32_t*>(ev),
      static_cast<int32_t*>(pos), static_cast<int32_t*>(mref), static_cast<int32_t*>(lnew),
      static_cast<int32_t*>(nev));
  return static_cast<int>(cudaGetLastError());
}
