// Error-state walks of the genome slice, one CUDA thread per read lane.
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
// arithmetic: four threefry-2x32 hashes (20 rounds each) and a few hundred
// compares per step, in a loop whose length is the lane's own event count.
// So the kernel is bound by integer throughput and by divergence: a warp runs
// until its slowest lane is done.  This first version copies the tables into
// shared memory once per block and lets each lane exit on its own; sorting
// lanes by length, binary search over the sorted rows and coalesced
// step-major event stores are left for later work.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (no PyTorch headers) and bound with ctypes; every launcher returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

using walk_common::draw;
using walk_common::fold;
using walk_common::mixture_len;

__global__ void aligned_walk_kernel(
    const uint32_t* __restrict__ wk,          // [B, 2] walk keys
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
  extern __shared__ uint32_t smem[];
  float* s_cdf = reinterpret_cast<float*>(smem);
  float* s_breaks = s_cdf + 3 * n_t;
  int32_t* s_vals = reinterpret_cast<int32_t*>(s_breaks + nb * K);
  int32_t* s_binlo = s_vals + nb * K;
  int32_t* s_nbk = s_binlo + nb;
  float* s_cum = reinterpret_cast<float*>(s_nbk + nb);
  for (int i = threadIdx.x; i < 3 * n_t; i += blockDim.x) s_cdf[i] = cdf_t[i];
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
  int pos = first_match[b];
  int middle = m_ref[b];
  int lnew = m_ref[b];
  int state = 0;
  int pm = first_match[b];
  int n = 0;
  int32_t* ev_row = ev + static_cast<size_t>(b) * E;

  for (int t = 1; t <= E && pos < middle; ++t) {
    uint32_t f0, f1;
    fold(k0, k1, static_cast<uint32_t>(t), f0, f1);
    const float u_err = draw(f0, f1, 0u);
    const float u_len = draw(f0, f1, 1u);
    const float u_match = draw(f0, f1, 2u);

    // error type: min(count(cum[state] <= u), 2)
    int et = (s_cum[state * 3] <= u_err) + (s_cum[state * 3 + 1] <= u_err) +
             (s_cum[state * 3 + 2] <= u_err);
    et = min(et, 2);
    const int elen = mixture_len(s_cdf, n_t, et, u_len);
    const bool is_ins = et == 1;
    const bool is_del = et == 2;
    const int e_pos2x = is_ins ? 2 * pos - 1 : 2 * pos;
    const int pos_after = pos + (is_ins ? 0 : elen);

    // del/mis overshoot extends the reference span
    const int over1 = max(pos_after - middle, 0);
    int lnew_n = lnew + (is_ins ? elen : (is_del ? -elen : 0)) + over1;
    int middle_n = max(middle, is_ins ? middle : pos_after);

    // next match length from the bin of the previous one
    int bc = 0;
    for (int i = 0; i < nb; ++i) bc += (s_binlo[i] <= pm);
    const int bin = min(max(bc - 1, 0), nb - 1);
    const float* br = s_breaks + bin * K;
    int c2 = 0;
    for (int i = 0; i < K; ++i) c2 += (br[i] <= u_match);
    const int idx = min(max(c2 - 1, 0), s_nbk[bin] - 1);
    int mstep = s_vals[bin * K + idx];
    if (pm == 0 && mstep == 0) mstep = 1;
    const int over2 = max(pos_after + mstep - middle_n, 0);
    lnew_n += over2;
    middle_n = max(middle_n, pos_after + mstep);

    const uint32_t word = static_cast<uint32_t>(e_pos2x) | (static_cast<uint32_t>(elen) << 19) |
                          (static_cast<uint32_t>(et) << 30);
    ev_row[n] = static_cast<int32_t>(word);
    pos = pos_after + mstep;
    middle = middle_n;
    lnew = lnew_n;
    state = et + 1 + (mstep == 0 ? 3 : 0);
    pm = mstep;
    ++n;
  }
  pos_out[b] = pos;
  mref_out[b] = middle;
  lnew_out[b] = lnew;
  nev_out[b] = n;
}

__global__ void unaligned_walk_kernel(
    const uint32_t* __restrict__ wk,          // [B, 2] walk keys
    const int32_t* __restrict__ m_ref,        // [B]
    const float* __restrict__ cdf_t, int n_t, // [3, n_t]
    int B, int E,
    int32_t* __restrict__ ev,                 // [B, E], zero-filled by the caller
    int32_t* __restrict__ pos_out, int32_t* __restrict__ mref_out,
    int32_t* __restrict__ lnew_out, int32_t* __restrict__ nev_out) {
  extern __shared__ uint32_t smem[];
  float* s_cdf = reinterpret_cast<float*>(smem);
  for (int i = threadIdx.x; i < 3 * n_t; i += blockDim.x) s_cdf[i] = cdf_t[i];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint32_t k0 = wk[2 * b], k1 = wk[2 * b + 1];
  int pos = 0;
  int middle = m_ref[b];
  int lnew = m_ref[b];
  int n = 0;
  int32_t* ev_row = ev + static_cast<size_t>(b) * E;

  for (int t = 0; t < E && pos < middle; ++t) {
    uint32_t f0, f1;
    fold(k0, k1, static_cast<uint32_t>(t), f0, f1);
    const float u_type = draw(f0, f1, 0u);
    const float u_len = draw(f0, f1, 1u);
    // fixed type probabilities: 0=match 1=mis 2=ins 3=del
    const int kind = (u_type >= 0.4f) + (u_type >= 0.7f) + (u_type >= 0.85f);
    const int et = min(max(kind - 1, 0), 2);
    const bool is_err = kind > 0;
    const int elen = is_err ? mixture_len(s_cdf, n_t, et, u_len) : 1;
    const bool is_ins = kind == 2;
    const bool is_del = kind == 3;
    const int e_pos2x = is_ins ? 2 * pos + 1 : 2 * pos;
    const int e_len_store = is_err ? elen : 0;
    const int pos_after = pos + (is_ins ? 0 : elen);
    const int over = max(pos_after - middle, 0);
    const int lnew_n = lnew + (is_ins ? elen : (is_del ? -elen : 0)) + (is_ins ? 0 : over);
    const int middle_n = max(middle, is_ins ? middle : pos_after);
    const uint32_t word = static_cast<uint32_t>(e_pos2x) |
                          (static_cast<uint32_t>(e_len_store) << 19) |
                          (static_cast<uint32_t>(et) << 30);
    ev_row[n] = static_cast<int32_t>(word);
    pos = pos_after;
    middle = middle_n;
    lnew = lnew_n;
    ++n;
  }
  pos_out[b] = pos;
  mref_out[b] = middle;
  lnew_out[b] = lnew;
  nev_out[b] = n;
}

constexpr int kThreads = 128;

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
  const size_t smem = sizeof(float) * 3 * n_t + sizeof(float) * nb * K +
                      sizeof(int32_t) * nb * K + sizeof(int32_t) * 2 * nb + sizeof(float) * 21;
  cudaError_t e = set_smem(reinterpret_cast<const void*>(aligned_walk_kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (B + kThreads - 1) / kThreads;
  aligned_walk_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
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
  const int blocks = (B + kThreads - 1) / kThreads;
  unaligned_walk_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wk), static_cast<const int32_t*>(m_ref),
      static_cast<const float*>(cdf_t), n_t, B, E, static_cast<int32_t*>(ev),
      static_cast<int32_t*>(pos), static_cast<int32_t*>(mref), static_cast<int32_t*>(lnew),
      static_cast<int32_t*>(nev));
  return static_cast<int>(cudaGetLastError());
}
