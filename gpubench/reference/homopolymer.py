"""Homopolymer simulation (`-hp -k`): error suppression + run resizing.

Reference semantics:

* mutate_read first DROPS any error event overlapping a homopolymer run of
  length >= k in the extracted reference segment (simulator.py:1920-1950);
  for FASTQ the dropped events' bases become match-class.
* mutate_homo then rewrites every run of length >= k in the MUTATED read:
  the new length is round(Normal(mu, sigma)) clamped at 0 with mu/sigma from
  the piecewise/linear homopolymer regressions (AT vs CG pooled), and each
  emitted base mismatches with probability hp_mis_rate (uniform over the
  other three bases) (simulator.py:618-705).  Resizes are NOT written to the
  ground-truth error log (the reference never logs them either).

Device mapping: run detection is two segmented running-maximum passes
(forward + flipped), event suppression is two gathers into the run-coverage
prefix sum, and resizing compacts runs to a [B, R] table (k-th-set-bit binary
search), turns them into del/ins events in the pass-1 read's coordinates, and
reuses the same cumsum gather-map machinery; extension bases come from the
"source to the left" map so they replicate the run base.  The [B, L] gather
of the packed base|class values is gather.gather_u8 (the plain version of the
program's K4), as are the small [B, R] gathers.

Every cumulative sum passes ``dtype=torch.int32`` and every gather index is
clamped first, as in ops/apply_errors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gather, rng
from .apply_errors import (CLASS_INS, CLASS_MIS, _ascii_to_code, _code_to_ascii,
                           build_gather_map)

_I32 = torch.int32


def _run_starts(sb: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Running maximum of the run-start positions (where(sb, i, 0)): the
    start of the run each position lies in.  The values are non-negative
    positions, so the maximum is exact in any integer type; int64 is the one
    torch.cummax takes on every backend."""
    marked = torch.where(sb, i, torch.zeros_like(i)).long()
    return torch.cummax(marked, dim=1).values.to(_I32)


def run_info(seq: torch.Tensor, lengths: torch.Tensor):
    """Per-position homopolymer run structure.

    Returns (run_start [B, L] i32, run_len [B, L] i32, is_start [B, L] bool)
    over the valid prefix of each lane.
    """
    B, L = seq.shape
    i = torch.arange(L, dtype=_I32, device=seq.device)[None, :].expand(B, L)
    in_seq = i < lengths[:, None]
    first = torch.zeros((B, 1), dtype=seq.dtype, device=seq.device)
    prev = torch.cat([first, seq[:, :-1]], dim=1)
    sb = (seq != prev) | (i == 0)
    sb = sb & in_seq

    run_start = _run_starts(sb, i)
    cnt_fwd = i - run_start + 1  # position index within the run (1-based)

    # backward pass on the flipped array gives the count to the run's end
    seq_r = torch.flip(seq, dims=(1,))
    prev_r = torch.cat([first, seq_r[:, :-1]], dim=1)
    sb_r = (seq_r != prev_r) | (i == 0)
    start_r = _run_starts(sb_r, i)
    cnt_bwd = torch.flip(i - start_r + 1, dims=(1,))

    run_len = torch.where(in_seq, cnt_fwd + cnt_bwd - 1, 0)
    return run_start, run_len, sb & in_seq


def suppress_hp_errors(
    ref_seg: torch.Tensor,  # [B, L] extracted (IUPAC-resolved) reference
    middle_ref: torch.Tensor,  # [B]
    ev_pos2x: torch.Tensor,  # [B, E]
    ev_type: torch.Tensor,
    ev_len: torch.Tensor,
    ev_valid: torch.Tensor,
    k: int,
):
    """Events overlapping >= k runs are dropped (simulator.py:1920-1950).

    Overlap test on real intervals: a mis/del [p, p+len) overlaps a run
    covering any integer position in [p, p+len); an ins with key p - 0.5
    overlaps one covering any position in [p-1, p+len-1].
    Returns the new ev_valid mask.
    """
    _, run_len, _ = run_info(ref_seg, middle_ref)
    in_hp = run_len >= k
    cum = torch.cumsum(in_hp.to(_I32), dim=1, dtype=_I32)  # inclusive prefix

    L = ref_seg.shape[1]
    is_ins = ev_type == 1
    p = (ev_pos2x + 1) // 2
    lo = torch.where(is_ins, p - 1, ev_pos2x // 2)
    hi = torch.where(is_ins, p + ev_len - 1, ev_pos2x // 2 + ev_len - 1)  # inclusive
    lo_c = lo.clamp(0, L - 1).long()
    hi_c = hi.clamp(0, L - 1).long()
    cum_hi = torch.gather(cum, 1, hi_c)
    cum_lo = torch.gather(cum, 1, lo_c)
    at_lo = torch.gather(in_hp, 1, lo_c)
    covered = (cum_hi - cum_lo) > 0
    covered = covered | (at_lo & (lo >= 0))
    return ev_valid & ~covered


def _batched_kth_set_bit(cum: torch.Tensor, r_max: int):
    """Positions of the r-th set bit per row from an inclusive prefix sum.

    Returns [B, r_max] int32 positions (L where absent)."""
    B, L = cum.shape
    dev = cum.device
    targets = torch.arange(1, r_max + 1, dtype=_I32, device=dev)[None, :]
    lo = torch.zeros((B, r_max), dtype=_I32, device=dev)
    hi = torch.full((B, r_max), L, dtype=_I32, device=dev)
    for _ in range(max(1, L.bit_length())):
        mid = (lo + hi) // 2
        cmid = torch.gather(cum, 1, mid.clamp(0, L - 1).long())
        go_right = cmid < targets
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo  # first index with cum >= target


def _count_breaks_le(breaks: torch.Tensor, row: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """count(breaks[row] <= u) per element of row/u, without the
    [B, R, N] buffer a row gather would need (the table is thousands of
    columns wide when the profile's sd regression is).

    Every row is sorted with values in [0, 2], so the whole table is one
    sorted float64 sequence under the key 4 * row + value, and one
    right-sided search of 4 * row + u, less the row's offset, is the count.
    The keys are exact in float64 (a float32 value plus a small integer), so
    the search makes the same float32 comparisons, value for value."""
    n_rows, n = breaks.shape
    offs = 4.0 * torch.arange(n_rows, dtype=torch.float64, device=breaks.device)
    keys = (breaks.double() + offs[:, None]).reshape(-1)
    q = (u.double() + 4.0 * row.double()).reshape(-1)
    return torch.searchsorted(keys, q, right=True).reshape(row.shape) - row * n


def resize_homopolymers(
    sk: torch.Tensor,  # [B, 2] slot keys
    read_mid: torch.Tensor,  # [B, L] pass-1 mutated read
    qclass_mid: torch.Tensor,  # [B, L] pass-1 classes
    l_new: torch.Tensor,  # [B] pass-1 read length
    hp_breaks: torch.Tensor,  # [2*(M+1), N] f32 exact u-space breakpoints
    hp_vals: torch.Tensor,  # [2*(M+1), N] i32 new-size values
    hp_mis_rate: float,
    k: int,
    r_max: int,
    l_cap: int,
):
    """mutate_homo as a second gather-map pass.

    The new run size is an exact inverse-CDF table lookup on a per-run
    uniform (ops/tables.build_hp_breakpoints defines the step function in
    f64; pure f32 comparisons here make it bit-identical on every device and
    in the C++ and numpy host reconstructions).  Run lengths beyond the table
    use its last row.

    Returns (read [B, L], qclass [B, L], new_len [B], ok [B]).
    ok is False when a lane exceeds the run-table capacity (callers treat it
    as capacity overflow and re-run through a bigger-r_max program).
    """
    B, L = read_mid.shape
    dev = read_mid.device
    run_start, run_len, is_start = run_info(read_mid, l_new)
    big = run_len >= k
    start_mask = is_start & big
    cum_sm = torch.cumsum(start_mask.to(_I32), dim=1, dtype=_I32)
    n_runs = cum_sm[:, -1]
    ok = n_runs <= r_max

    s_r = _batched_kth_set_bit(cum_sm, r_max)  # [B, R]
    has_run = torch.arange(r_max, dtype=_I32, device=dev)[None, :] < n_runs[:, None]
    s_rc = s_r.clamp(0, L - 1).long()
    m_r = torch.where(has_run, torch.gather(run_len, 1, s_rc), 0)
    c_r = torch.gather(read_mid, 1, s_rc)  # run base ASCII

    # new size = table(pool, run length, u) pooled AT vs CG (get_nd_par,
    # model_homopolymer_lengths.py:246-260; sampling simulator.py:639-665)
    is_at = (c_r == ord("A")) | (c_r == ord("T"))
    M = hp_breaks.shape[0] // 2 - 1
    u = rng.uniform_per_slot(sk, rng.SITE_HOMOPOLYMER, (r_max,))  # [B, R]
    row = (torch.where(is_at, 0, M + 1) + m_r.clamp_max(M)).long()
    cnt = _count_breaks_le(hp_breaks, row, u)
    # the 0.0 sentinel that opens every row makes cnt >= 1; the clamp only
    # guards the gather against a table without it
    n_r = hp_vals[row, (cnt - 1).clamp_min(0)]
    n_r = torch.where(has_run, n_r.clamp_max(l_cap // 2), m_r).to(_I32)

    # del/ins events in pass-1 read coordinates
    shrink = n_r < m_r
    grow = n_r > m_r
    ev_pos2x = torch.where(
        shrink, 2 * (s_r + n_r), 2 * (s_r + m_r) - 1
    )  # del at s+n; ins before s+m
    ev_type = torch.where(shrink, 2, 1).to(_I32)
    ev_len = (n_r - m_r).abs()
    ev_valid = has_run & (shrink | grow)

    gm = build_gather_map(ev_pos2x, ev_type, ev_len, ev_valid, l_new, L)

    # materialize: kept positions copy pass-1 bases+classes; extension
    # positions replicate the run base (source-to-the-left self-correction);
    # in-run mismatches at hp_mis_rate
    src = torch.where(gm.qclass == CLASS_INS, gm.src_left, gm.src)
    src = src.clamp(0, L - 1)
    # base | class << 8 as a 16-bit value (int16: the classes stay below 128)
    packed = read_mid.to(torch.int16) | (qclass_mid.to(torch.int16) << 8)
    fetched = gather.gather_u8(packed, src)
    base = (fetched & 0xFF).to(torch.uint8)
    cls = torch.where(gm.qclass == CLASS_INS, CLASS_INS, (fetched >> 8).to(_I32))

    # new-run coverage in output coordinates: positions whose source (or left
    # source) lies inside a >= k run of the pass-1 read
    src_big = torch.gather(big, 1, src.long())
    u = rng.uniform_per_slot(sk, rng.SITE_HP_QUAL, (L,))
    # reference draws p = random.random() and mutates when 0 < p <= rate; the
    # rate is compared as float32, as the host reconstructions take it
    rate = torch.tensor(np.float32(hp_mis_rate), dtype=torch.float32, device=dev)
    do_mis = src_big & (u <= rate) & (u > 0)
    code = _ascii_to_code(base)
    # own site: SITE_HOMOPOLYMER's counter stream is consumed by the per-run
    # size draws above; sharing it here would correlate the mis-base
    # choices at low positions with the run-size draws
    u2 = rng.uniform_per_slot(sk, rng.SITE_HP_MIS_BASE, (L,))
    off = 1 + torch.floor(u2 * 3.0).to(torch.uint8).clamp_max(2)
    mis_base = _code_to_ascii((code + off) % 4)
    base = torch.where(do_mis, mis_base, base)
    cls = torch.where(do_mis, CLASS_MIS, cls).to(_I32)

    base = torch.where(gm.valid, base, 0).to(torch.uint8)
    return base, cls, gm.read_len, ok
