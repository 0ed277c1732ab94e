"""The error walks in plain PyTorch: a frozen copy of the port's plain
versions of its walk kernels (K1, the aligned walk; K2, the unaligned walk)
and of the walk drivers around them, run on the CPU by the benchmark's
reference.

Each lane is the reference's per-read `error_list` loop (aligned) or
`unaligned_error_list` loop (unaligned): draws are counter-addressed threefry
uniforms of (slot key, step), so one lane's walk does not depend on the
other lanes of its batch.  Event words are ``pos2x | len << 19 | type << 30``
(mis/del at 2*pos, an aligned insertion at 2*pos - 1, an unaligned one at
2*pos + 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import rng
from .tables import EcdfDevice, MixtureDevice, TransErrorDevice

UNROLL = 8  # steps per termination check
MASK32 = 0xFFFFFFFF


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


E_MIS, E_INS, E_DEL = 0, 1, 2


class WalkResult(NamedTuple):
    """Batched walk outputs; events_* are [B, E] with per-lane prefix validity
    (zeros past each lane's prefix)."""

    events_pos2x: torch.Tensor
    events_type: torch.Tensor
    events_len: torch.Tensor
    events_valid: torch.Tensor
    middle_ref: torch.Tensor  # [B] int32
    l_new: torch.Tensor  # [B] int32
    overflow: torch.Tensor  # [B] bool
    n_events: torch.Tensor  # [B] int32
    ecnt_mis: torch.Tensor
    ecnt_ins: torch.Tensor
    ecnt_match: torch.Tensor


def _unpack(words: torch.Tensor):
    w = words.long() & MASK32
    ev_pos2x = (w & 0x7FFFF).to(torch.int32)
    ev_type = (w >> 30).to(torch.int32)
    ev_len = ((w >> 19) & 0x7FF).to(torch.int32)
    return ev_pos2x, ev_type, ev_len


def first_match(walk_keys: torch.Tensor, table: EcdfDevice) -> torch.Tensor:
    """First match length (simulator.py:1843-1856): step 0's draw, >= 2."""
    B = walk_keys.shape[0]
    steps = torch.zeros(1, dtype=torch.int64, device=walk_keys.device)
    u0 = step_uniforms(walk_keys, steps, 1)[0, :, 0]
    fm = table.invert(torch.zeros(B, dtype=torch.int64, device=walk_keys.device), u0)
    return fm.to(torch.int32).clamp_min(2)


def error_walk(slot_keys, m_ref, first_match_t: EcdfDevice, match_markov: EcdfDevice,
               mixtures: MixtureDevice, trans: TransErrorDevice,
               max_events: int) -> WalkResult:
    """The aligned walk (steps 1..max_events)."""
    E = max_events
    walk_keys = rng.site_keys(slot_keys, rng.SITE_WALK)
    fm = first_match(walk_keys, first_match_t)
    words, pos, middle_ref, l_new, n_events = aligned_steps_plain(
        walk_keys, m_ref.to(torch.int32), fm, match_markov, mixtures, trans, E)
    ev_pos2x, ev_type, ev_len = _unpack(words)
    ar = torch.arange(E, dtype=torch.int32, device=m_ref.device)
    ev_valid = ar[None, :] < n_events[:, None]
    # Per-type base counts from the event prefix; every consumed reference
    # base is a match, mismatch, or deletion, and the overshoot extension ends
    # each completed lane at pos == middle_ref, so matches = middle_ref - mis
    # - del (overflow lanes are rejected and resampled downstream).
    vlen = torch.where(ev_valid, ev_len, 0)
    ecnt_mis = torch.where(ev_type == E_MIS, vlen, 0).sum(dim=1).to(torch.int32)
    ecnt_ins = torch.where(ev_type == E_INS, vlen, 0).sum(dim=1).to(torch.int32)
    ecnt_del = torch.where(ev_type == E_DEL, vlen, 0).sum(dim=1).to(torch.int32)
    return WalkResult(
        events_pos2x=ev_pos2x, events_type=ev_type, events_len=ev_len,
        events_valid=ev_valid, middle_ref=middle_ref, l_new=l_new,
        overflow=pos < middle_ref, n_events=n_events,
        ecnt_mis=ecnt_mis, ecnt_ins=ecnt_ins,
        ecnt_match=middle_ref - ecnt_mis - ecnt_del,
    )


def unaligned_walk(slot_keys, m_ref, mixtures: MixtureDevice, max_steps: int) -> WalkResult:
    """Unaligned/gap error synthesis (simulator.py:1784-1830).

    Fixed per-step type probabilities match/mis/ins/del = 0.4/0.3/0.15/0.15;
    each step advances pos by 1 (match), the error length (mis/del), or stays
    (ins; consecutive insertions share key pos + 0.1 and merge downstream).
    Event slots are allocated per *step*; matches are stored with length 0.
    """
    E = max_steps
    walk_keys = rng.site_keys(slot_keys, rng.SITE_UNALIGNED_WALK)
    words, pos, middle_ref, l_new, n_steps = unaligned_steps_plain(
        walk_keys, m_ref.to(torch.int32), mixtures, E)
    ev_pos2x, ev_type, ev_len = _unpack(words)
    ar = torch.arange(E, dtype=torch.int32, device=m_ref.device)
    ev_valid = (ar[None, :] < n_steps[:, None]) & (ev_len > 0)
    zero = torch.zeros_like(n_steps)
    return WalkResult(
        events_pos2x=ev_pos2x, events_type=ev_type, events_len=ev_len,
        events_valid=ev_valid, middle_ref=middle_ref, l_new=l_new,
        overflow=pos < middle_ref, n_events=n_steps,
        ecnt_mis=zero, ecnt_ins=zero, ecnt_match=zero,
    )
