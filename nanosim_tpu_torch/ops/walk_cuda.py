"""The error-walk kernels (csrc/walk.cu) and their plain PyTorch versions.

`aligned_steps` and `unaligned_steps` are the wrappers the walks call.  For a
tensor on the CPU they run the plain version in this module; for a CUDA
tensor they launch the kernel or raise — there is no fallback.  Each wrapper
counts its launches in a plain integer attribute (``aligned_steps.launches``)
so that a run can show it went through the kernel; the aligned wrapper also
counts them per event budget (``aligned_steps.launches_by_budget``), which
tells the lean main-path launches from the overflow rescue's full-budget ones.

Both versions compute, per lane, the walk's event words (``pos2x | len << 19 |
type << 30``, a per-lane prefix, zeros after it) and the final ``pos``,
``middle_ref``, ``l_new`` and event count.  The first match of the aligned
walk is drawn outside, by the caller, as in the JAX package.

The kernels are built from csrc/walk.cu by ops/cuda_build.py on first use
(about a second; no PyTorch headers) and bound with ctypes.  See
csrc/walk.cu for what bounds them on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import rng
from .cuda_build import KernelLibrary

UNROLL = 8  # steps per termination check in the plain loops
MASK32 = 0xFFFFFFFF
THREADS_PER_BLOCK = 128  # kThreads in csrc/walk.cu: one thread per lane


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.launch_aligned_walk.argtypes = [p, p, p, p, i, p, p, p, p, i, i, p, i, i,
                                        p, p, p, p, p, p]
    lib.launch_aligned_walk.restype = ctypes.c_int
    lib.launch_unaligned_walk.argtypes = [p, p, p, i, i, i, p, p, p, p, p, p]
    lib.launch_unaligned_walk.restype = ctypes.c_int


LIBRARY = KernelLibrary("walk.cu", _bind)


# --- plain versions -----------------------------------------------------------


def step_uniforms(walk_keys: torch.Tensor, steps: torch.Tensor, n: int) -> torch.Tensor:
    """Per-step uniforms ``uniform(fold_in(key, t), (n,))``: walk_keys [B, 2],
    steps [T] int64 -> [T, B, n] f32."""
    T, B = steps.shape[0], walk_keys.shape[0]
    f = rng.fold_in(walk_keys[None].expand(T, B, 2), steps[:, None].expand(T, B))
    j = torch.arange(n, dtype=torch.int64, device=walk_keys.device)
    y0, y1 = rng._threefry2x32(f[..., 0, None], f[..., 1, None], torch.zeros_like(j), j)
    return rng._bits_to_uniform(y0 ^ y1)


def _word(pos2x, length, etype) -> torch.Tensor:
    """pos2x | len << 19 | type << 30 as the int32 with the same bits."""
    w = (pos2x.long() | (length.long() << 19) | (etype.long() << 30)) & MASK32
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def aligned_step_arith(pos, middle_ref, l_new, prev_match, etype, elen, mstep):
    """The state arithmetic of one aligned step, given its three draws (error
    type, error length, next match length): the event's pos2x and the next
    (pos, middle_ref, l_new, state, prev_match).  A zero match after a zero
    match is forced to 1; del/mis overshoot extends the reference span."""
    zero = torch.zeros_like(pos)
    is_ins = etype == 1
    is_del = etype == 2
    e_pos2x = torch.where(is_ins, 2 * pos - 1, 2 * pos)
    pos_after = pos + torch.where(is_ins, zero, elen)
    over1 = (pos_after - middle_ref).clamp_min(0)
    l_new_n = l_new + torch.where(is_ins, elen, torch.where(is_del, -elen, zero)) + over1
    middle_ref_n = torch.maximum(middle_ref, torch.where(is_ins, middle_ref, pos_after))
    mstep = torch.where((prev_match == 0) & (mstep == 0), torch.ones_like(mstep), mstep)
    over2 = (pos_after + mstep - middle_ref_n).clamp_min(0)
    l_new_n = l_new_n + over2
    middle_ref_n = torch.maximum(middle_ref_n, pos_after + mstep)
    new_state = etype + 1 + torch.where(mstep == 0, 3, 0).to(torch.int32)
    return e_pos2x, pos_after + mstep, middle_ref_n, l_new_n, new_state, mstep


def aligned_steps_plain(walk_keys, m_ref, first_match, match_markov, mixtures, trans,
                        max_events: int):
    """Plain PyTorch aligned walk (steps 1..E): the kernel's reference."""
    B, E = m_ref.shape[0], max_events
    dev = m_ref.device
    pos = first_match.to(torch.int32).clone()
    middle_ref = m_ref.to(torch.int32).clone()
    l_new = middle_ref.clone()
    state = torch.zeros(B, dtype=torch.int32, device=dev)
    prev_match = pos.clone()
    n_events = torch.zeros(B, dtype=torch.int32, device=dev)
    words = torch.zeros((B, E), dtype=torch.int32, device=dev)
    for t0 in range(1, E + 1, UNROLL):
        if not bool((pos < middle_ref).any()):
            break
        ts = torch.arange(t0, min(t0 + UNROLL, E + 1), dtype=torch.int64, device=dev)
        U = step_uniforms(walk_keys, ts, 3)
        for k in range(ts.shape[0]):
            active = pos < middle_ref
            u_err, u_len, u_match = U[k, :, 0], U[k, :, 1], U[k, :, 2]
            etype = trans.sample(state, u_err)
            elen = mixtures.sample(etype, u_len)
            bins = match_markov.select_bin(prev_match)
            mstep = match_markov.invert(bins, u_match).to(torch.int32)
            e_pos2x, pos_n, middle_ref_n, l_new_n, new_state, mstep = aligned_step_arith(
                pos, middle_ref, l_new, prev_match, etype, elen, mstep)
            t = int(ts[k])
            words[:, t - 1] = torch.where(active, _word(e_pos2x, elen, etype), 0)
            pos = torch.where(active, pos_n, pos)
            middle_ref = torch.where(active, middle_ref_n, middle_ref)
            l_new = torch.where(active, l_new_n, l_new)
            state = torch.where(active, new_state, state)
            prev_match = torch.where(active, mstep, prev_match)
            n_events = n_events + active.to(torch.int32)
    return words, pos, middle_ref, l_new, n_events


def unaligned_steps_plain(walk_keys, m_ref, mixtures, max_steps: int):
    """Plain PyTorch unaligned walk (steps 0..E-1): the kernel's reference."""
    B, E = m_ref.shape[0], max_steps
    dev = m_ref.device
    pos = torch.zeros(B, dtype=torch.int32, device=dev)
    middle_ref = m_ref.to(torch.int32).clone()
    l_new = middle_ref.clone()
    n_steps = torch.zeros(B, dtype=torch.int32, device=dev)
    words = torch.zeros((B, E), dtype=torch.int32, device=dev)
    zero = torch.zeros_like(pos)
    th = [torch.tensor(v, dtype=torch.float32, device=dev) for v in (0.4, 0.7, 0.85)]
    for t0 in range(0, E, UNROLL):
        if not bool((pos < middle_ref).any()):
            break
        ts = torch.arange(t0, min(t0 + UNROLL, E), dtype=torch.int64, device=dev)
        U = step_uniforms(walk_keys, ts, 2)
        for k in range(ts.shape[0]):
            active = pos < middle_ref
            u_type, u_len = U[k, :, 0], U[k, :, 1]
            kind = sum((u_type >= c).to(torch.int32) for c in th)  # 0=match 1=mis 2=ins 3=del
            etype = (kind - 1).clamp(0, 2)
            is_err = kind > 0
            elen = torch.where(is_err, mixtures.sample(etype, u_len), torch.ones_like(kind))
            is_ins = kind == 2
            is_del = kind == 3
            e_pos2x = torch.where(is_ins, 2 * pos + 1, 2 * pos)
            e_len_store = torch.where(is_err, elen, zero)
            pos_after = pos + torch.where(is_ins, zero, elen)
            over = (pos_after - middle_ref).clamp_min(0)
            l_new_n = l_new + torch.where(is_ins, elen, torch.where(is_del, -elen, zero))
            l_new_n = l_new_n + torch.where(is_ins, zero, over)
            middle_ref_n = torch.maximum(middle_ref, torch.where(is_ins, middle_ref, pos_after))
            t = int(ts[k])
            words[:, t] = torch.where(active, _word(e_pos2x, e_len_store, etype), 0)
            pos = torch.where(active, pos_after, pos)
            middle_ref = torch.where(active, middle_ref_n, middle_ref)
            l_new = torch.where(active, l_new_n, l_new)
            n_steps = n_steps + active.to(torch.int32)
    return words, pos, middle_ref, l_new, n_steps


# --- kernel wrappers ----------------------------------------------------------


def _as_u32_words(keys: torch.Tensor) -> torch.Tensor:
    """[B, 2] int64 keys holding uint32 values -> [B, 2] int32 with the same bits."""
    k = keys & MASK32
    return torch.where(k >= 2**31, k - 2**32, k).to(torch.int32).contiguous()


def _check_cuda(name: str, device, *tensors):
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: all inputs must be on {device}, got {t.device}")


def _outputs(B: int, E: int, device):
    ev = torch.zeros((B, E), dtype=torch.int32, device=device)
    rest = [torch.empty(B, dtype=torch.int32, device=device) for _ in range(4)]
    return ev, rest


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def aligned_steps(walk_keys, m_ref, first_match, match_markov, mixtures, trans,
                  max_events: int):
    """Aligned walk: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  Returns (words [B, E] i32, pos, middle_ref, l_new, n_events)."""
    if not m_ref.is_cuda:
        return aligned_steps_plain(walk_keys, m_ref, first_match, match_markov,
                                   mixtures, trans, max_events)
    lib = LIBRARY.load()
    dev = m_ref.device
    B, E = m_ref.shape[0], int(max_events)
    wk = _as_u32_words(walk_keys)
    mref = m_ref.to(torch.int32).contiguous()
    fm = first_match.to(torch.int32).contiguous()
    cdf = mixtures.cdf_t.to(torch.float32).contiguous()
    bin_lo = match_markov.bin_lo.to(torch.int32).contiguous()
    breaks = match_markov.breaks.to(torch.float32).contiguous()
    vals = match_markov.vals.to(torch.int32).contiguous()
    n_bk = match_markov.n_bk.to(torch.int32).contiguous()
    cum = trans.cum.to(torch.float32).contiguous()
    _check_cuda("aligned_steps", dev, wk, fm, cdf, bin_lo, breaks, vals, n_bk, cum)
    if cum.shape != (7, 3):
        raise ValueError(f"aligned_steps: transition table must be [7, 3], got {tuple(cum.shape)}")
    nb, K = breaks.shape
    ev, (pos, mr, ln, ne) = _outputs(B, E, dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    rc = lib.launch_aligned_walk(
        _ptr(wk), _ptr(mref), _ptr(fm), _ptr(cdf), cdf.shape[1], _ptr(bin_lo),
        _ptr(breaks), _ptr(vals), _ptr(n_bk), nb, K, _ptr(cum), B, E,
        _ptr(ev), _ptr(pos), _ptr(mr), _ptr(ln), _ptr(ne), stream)
    if rc != 0:
        raise RuntimeError(f"aligned walk kernel launch failed: cudaError {rc}")
    aligned_steps.launches += 1
    aligned_steps.launches_by_budget[E] = aligned_steps.launches_by_budget.get(E, 0) + 1
    return ev, pos, mr, ln, ne


aligned_steps.launches = 0
aligned_steps.launches_by_budget = {}  # event budget E -> launches at that E


def unaligned_steps(walk_keys, m_ref, mixtures, max_steps: int):
    """Unaligned walk: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  Returns (words [B, E] i32, pos, middle_ref, l_new, n_steps)."""
    if not m_ref.is_cuda:
        return unaligned_steps_plain(walk_keys, m_ref, mixtures, max_steps)
    lib = LIBRARY.load()
    dev = m_ref.device
    B, E = m_ref.shape[0], int(max_steps)
    wk = _as_u32_words(walk_keys)
    mref = m_ref.to(torch.int32).contiguous()
    cdf = mixtures.cdf_t.to(torch.float32).contiguous()
    _check_cuda("unaligned_steps", dev, wk, cdf)
    ev, (pos, mr, ln, ne) = _outputs(B, E, dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    rc = lib.launch_unaligned_walk(
        _ptr(wk), _ptr(mref), _ptr(cdf), cdf.shape[1], B, E,
        _ptr(ev), _ptr(pos), _ptr(mr), _ptr(ln), _ptr(ne), stream)
    if rc != 0:
        raise RuntimeError(f"unaligned walk kernel launch failed: cudaError {rc}")
    unaligned_steps.launches += 1
    return ev, pos, mr, ln, ne


unaligned_steps.launches = 0
