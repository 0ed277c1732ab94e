"""The chimeric-read batch program in plain PyTorch: a frozen copy of the
port's `chimeric_batch`, its read-emitting program for genome reads (KDE
lengths, not perfect), every (slot, segment) and (slot, gap) pair on a lane
of its own, with the capacity planning of its simulator.

A read draws a geometric segment count; each segment is an aligned read's
middle (the full walk), consecutive segments are joined by gaps mutated by
the unaligned walk, and one head/tail and strand decision covers the whole
read (simulator.py:1266-1454).  Every draw is (slot, part)-addressed, so the
program's packed walk lanes give the same per-slot results.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import apply_errors, extract, homopolymer, rng, seqops, xla_math
from . import walk as error_walk
from .bundles import SimTables, plan_event_budget, plan_ht_capacity, plan_ref_capacity
from .genome_mode import _first_valid, _kde_draw, draw_ht
from .unaligned_mode import QCLASS_UNMAPPED

_I32 = torch.int32


class ChimericBatchOut(NamedTuple):
    read: torch.Tensor  # [B, L_out] uint8, final orientation
    quals: torch.Tensor  # [B, L_out] uint8 phred+33
    valid: torch.Tensor  # [B]
    total_len: torch.Tensor  # [B]
    head: torch.Tensor  # [B]
    tail: torch.Tensor  # [B]
    n_seg: torch.Tensor  # [B] int32
    seg_middle_ref: torch.Tensor  # [B, S] int32
    seg_l_new: torch.Tensor  # [B, S] int32
    seg_offset: torch.Tensor  # [B, S] int32 read-coordinate start of each seg (pre-reverse)
    gap_len: torch.Tensor  # [B, S-1] int32 mutated gap lengths
    chrom: torch.Tensor  # [B, S] int32
    local_pos: torch.Tensor  # [B, S] int64
    is_reversed: torch.Tensor  # [B]
    ev_pos2x: torch.Tensor  # [S*B, E] segment-major
    ev_type: torch.Tensor  # [S*B, E]
    ev_len: torch.Tensor  # [S*B, E]
    n_events: torch.Tensor  # [B, S]
    seg_read_prehp: torch.Tensor  # [S*B, l_cap] pass-1 mutated segments (log source)


def _geometric(u: torch.Tensor, p: float) -> torch.Tensor:
    """np.random.geometric semantics: support 1.., P(k) = p (1-p)^(k-1).

    The precisions are the JAX program's: log1p(-u) in float32 (XLA's), the
    denominator log1p(-p) of the Python float in float64 rounded once to
    float32, a float32 division."""
    den = torch.tensor(np.float32(math.log1p(-p)), dtype=torch.float32, device=u.device)
    return torch.ceil(xla_math.log1p_f32(-u) / den).to(_I32)


def _part_table(head, tail, seg_lnew, gap_lens, S: int):
    """Part lengths head, (seg s, gap s)*, tail -> offsets [B, 2S + 2]."""
    B = head.shape[0]
    n_parts = 2 * S + 1
    part_len = torch.zeros((B, n_parts), dtype=_I32, device=head.device)
    part_len[:, 0] = head
    for s in range(S):
        part_len[:, 1 + 2 * s] = seg_lnew[:, s]
        if s < S - 1:
            part_len[:, 2 + 2 * s] = gap_lens[:, s]
    part_len[:, n_parts - 1] = tail
    return torch.cat([torch.zeros((B, 1), dtype=_I32, device=head.device),
                      torch.cumsum(part_len, dim=1, dtype=_I32)], dim=1)


def chimeric_batch(
    base_key: torch.Tensor,
    slots: torch.Tensor,  # [B]
    genome: extract.GenomeDevice,
    tables: SimTables,
    *,
    l_cap: int,
    l_out: int,
    ht_cap: int,
    e_max: int,
    gap_cap: int,
    gap_steps: int,
    s_max: int,
    fastq: bool,
    circular_dna: bool,
    min_len: int,
    max_len: float,
    segment_mean: float,
    kmer_bias: Optional[int] = None,
    hp_r_max: int = 256,
) -> ChimericBatchOut:
    B = slots.shape[0]
    S = s_max
    dev = slots.device
    sk = rng.slot_keys(base_key, slots)
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=dev)

    # --- segment counts (simulator.py:1276-1279) ---
    if segment_mean > 1.0 and S > 1:
        u_seg = rng.uniform_per_slot(sk, rng.SITE_SEGMENTS)
        n_seg = _geometric(u_seg, 1.0 / segment_mean).clamp_max(S)
    else:
        n_seg = torch.ones(B, dtype=_I32, device=dev)

    seg_active = (
        torch.arange(S, dtype=_I32, device=dev).repeat_interleave(B) < n_seg.repeat(S)
    )  # [S*B] segment-major
    sk_seg = torch.cat([rng.part_slot_keys(sk, rng.PART_SEGMENT_BASE, s) for s in range(S)],
                       dim=0)
    seg_live = seg_active
    if S > 1:
        gap_active = (
            torch.arange(S - 1, dtype=_I32, device=dev).repeat_interleave(B)
            < (n_seg - 1).repeat(S - 1)
        )  # [(S-1)*B] gap-major
        sk_gap = torch.cat([rng.part_slot_keys(sk, rng.PART_GAP_BASE, s) for s in range(S - 1)],
                           dim=0)
        gap_live = gap_active

    def per_slot(x, n):  # flattened [n*B] part-major -> [B, n]
        return x.reshape(n, B).T

    # --- per-segment aligned lengths (iid conditional on the reference's
    # filter: (0, max] aligned; simulator.py:832-850) ---
    ref_c = _kde_draw(sk_seg, rng.SITE_REF_LENGTH, tables.kde_aligned, 2)
    ref_f, ref_ok = _first_valid(ref_c, (ref_c > 0) & (ref_c <= f32(max_len)))
    m_ref_lane = torch.where(seg_live, xla_math.f32_to_i32(ref_f).clamp(0, l_cap), 0)
    seg_len_ok = torch.where(seg_live, ref_ok & (ref_f <= f32(l_cap)), True)

    remainder, head, tail, ht_ok = draw_ht(sk, tables, ht_cap)

    # --- segment error walks on the flattened batch ---
    walk = error_walk.error_walk(
        sk_seg, m_ref_lane, tables.first_match, tables.match_markov,
        tables.mixtures, tables.trans, e_max,
    )
    seg_mref = per_slot(walk.middle_ref, S)  # [B, S]
    seg_lnew = per_slot(torch.where(seg_live, walk.l_new, 0), S)
    walk_ok = per_slot(
        torch.where(seg_live,
                    ~walk.overflow & (walk.middle_ref <= l_cap) & (walk.l_new <= l_cap),
                    True), S).all(dim=1)

    # --- gap lengths + gap synthesis (simulator.py:1298-1299, 1552-1568) ---
    if S > 1:
        gap_f = _kde_draw(sk_gap, rng.SITE_GAP, tables.kde_gap, 1)[:, 0]
        gap_ref = torch.where(gap_live, gap_f.clamp_min(0).to(_I32), 0)
        gap_ref = gap_ref.clamp_max(gap_cap)
        gwalk = error_walk.unaligned_walk(sk_gap, gap_ref, tables.mixtures, gap_steps)
        gap_ok = per_slot(
            torch.where(gap_live, ~gwalk.overflow & (gwalk.l_new <= gap_cap), True),
            S - 1).all(dim=1)
        g_chrom, g_pos, g_pos_ok = extract.sample_genome_positions(
            sk_gap, gwalk.middle_ref, genome, circular_dna
        )
        gap_ok &= per_slot(torch.where(gap_live, g_pos_ok, True), S - 1).all(dim=1)
        gap_seg = extract.gather_segments(genome, g_chrom, g_pos, gwalk.middle_ref, gap_cap)
        gu_iupac, gu_mis = rng.uniform2_per_slot(sk_gap, rng.SITE_IUPAC, (gap_cap,))
        gap_seg = seqops.resolve_iupac(gap_seg, gu_iupac)
        # gap (unaligned) walk: mutate_read's reverse splicing of the
        # pos + 0.1 insertion keys makes same-pos mis/del act on contiguous
        # POST-insertion positions (build_unaligned_map)
        ggm, g_under_ins, g_map_ov = apply_errors.build_unaligned_map(
            gwalk.events_pos2x, gwalk.events_type, gwalk.events_len, gwalk.events_valid,
            gwalk.middle_ref, gap_cap,
        )
        gu_ins, _ = rng.uniform2_per_slot(sk_gap, rng.SITE_INS_BASE, (gap_cap,))
        gap_read = apply_errors.materialize_read(
            ggm.src, ggm.qclass, ggm.valid, gap_seg, gu_mis, gu_ins,
            under_ins=g_under_ins,
        )  # [(S-1)*B, gap_cap]
        gap_ok &= per_slot(torch.where(gap_live, ~g_map_ov, True), S - 1).all(dim=1)
        gap_lens = per_slot(torch.where(gap_live, gwalk.l_new, 0), S - 1)  # [B, S-1]
    else:
        gap_ok = torch.ones(B, dtype=torch.bool, device=dev)
        gap_read = torch.zeros((B, gap_cap), dtype=torch.uint8, device=dev)
        gap_lens = torch.zeros((B, 1), dtype=_I32, device=dev)

    # --- total-length filter (simulator.py:1354-1368; genome mode does not
    # count the gaps) ---
    total0 = remainder + seg_lnew.sum(dim=1, dtype=_I32)
    valid = (
        ht_ok
        & walk_ok
        & gap_ok
        & per_slot(seg_len_ok, S).all(dim=1)
        & (total0 >= min_len)
        & (total0.double() <= max_len)
    )

    # --- segment extraction ---
    chrom_f, pos_f, pos_ok = extract.sample_genome_positions(
        sk_seg, walk.middle_ref, genome, circular_dna
    )
    valid &= per_slot(torch.where(seg_live, pos_ok, True), S).all(dim=1)
    u_strand = rng.uniform_per_slot(sk, rng.SITE_STRAND)
    is_rev = u_strand > tables.strandness_rate

    ref_seg = extract.gather_segments(genome, chrom_f, pos_f, walk.middle_ref, l_cap)
    su_iupac, su_mis = rng.uniform2_per_slot(sk_seg, rng.SITE_IUPAC, (l_cap,))
    ref_seg = seqops.resolve_iupac(ref_seg, su_iupac)
    ev_len_seg = walk.events_len
    if kmer_bias is not None:
        keep = homopolymer.suppress_hp_errors(
            ref_seg, walk.middle_ref, walk.events_pos2x, walk.events_type,
            ev_len_seg, walk.events_valid, kmer_bias,
        )
        ev_len_seg = torch.where(keep, ev_len_seg, 0)
    gm = apply_errors.build_gather_map(
        walk.events_pos2x, walk.events_type, ev_len_seg, walk.events_valid,
        walk.middle_ref, l_cap,
    )
    su_ins, _ = rng.uniform2_per_slot(sk_seg, rng.SITE_INS_BASE, (l_cap,))
    seg_read = apply_errors.materialize_read(
        gm.src, gm.qclass, gm.valid, ref_seg, su_mis, su_ins,
    )  # [S*B, l_cap]
    seg_read_prehp = seg_read
    seg_qclass, seg_read_len = gm.qclass, gm.read_len
    if kmer_bias is not None:
        seg_read, seg_qclass, seg_read_len, hp_ok = homopolymer.resize_homopolymers(
            sk_seg, seg_read, seg_qclass, seg_read_len,
            tables.hp_breaks, tables.hp_vals,
            tables.hp_mis_rate, kmer_bias, hp_r_max, l_cap,
        )
        valid &= per_slot(torch.where(seg_active, hp_ok, True), S).all(dim=1)
    # realized segment lengths: dict-overwritten duplicate insertions (and
    # hp resizes) are reflected in gm.read_len, not the walk's l_new
    seg_lnew = per_slot(torch.where(seg_active, seg_read_len, 0), S)

    # --- parts assembly: head, (seg s, gap s)*, tail ---
    n_parts = 2 * S + 1
    part_off = _part_table(head, tail, seg_lnew, gap_lens, S)  # [B, n_parts+1]
    total = part_off[:, -1]
    valid &= (total >= min_len) & (total.double() <= max_len) & (total <= l_out)
    seg_offset = part_off[:, 1 : 1 + 2 * S : 2]  # [B, S] read-coordinate seg starts

    j = torch.arange(l_out, dtype=_I32, device=dev)[None, :]
    part = torch.searchsorted(part_off.contiguous(), j.expand(B, l_out).contiguous(),
                              right=True) - 1  # [B, l_out] int64
    part = part.clamp(0, n_parts - 1)
    inner = j - torch.gather(part_off, 1, part)

    is_head = part == 0
    is_tail = part == n_parts - 1
    is_seg = (part % 2 == 1) & ~is_tail
    seg_idx = ((part - 1) // 2).clamp(0, S - 1)
    gap_idx = ((part - 2) // 2).clamp(0, S - 2) if S > 1 else torch.zeros_like(part)

    b_col = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    seg_flat_idx = ((seg_idx * B + b_col) * l_cap + inner.clamp(0, l_cap - 1)).clamp(
        0, S * B * l_cap - 1)
    seg_bases = seg_read.reshape(-1)[seg_flat_idx]
    if S > 1:
        gap_flat_idx = ((gap_idx * B + b_col) * gap_cap + inner.clamp(0, gap_cap - 1)).clamp(
            0, gap_read.numel() - 1)
        gap_bases = gap_read.reshape(-1)[gap_flat_idx]
    else:
        gap_bases = seg_bases

    u_ht = rng.uniform_per_slot(sk, rng.SITE_HEAD_TAIL, (ht_cap,))
    ht_idx = torch.where(is_tail, head[:, None] + inner, inner)
    ht_bases = seqops.random_bases(torch.gather(u_ht, 1, ht_idx.clamp(0, ht_cap - 1).long()))
    is_ht = is_head | is_tail
    base = torch.where(is_seg, seg_bases, torch.where(is_ht, ht_bases, gap_bases))
    in_read = j < total[:, None]
    base = torch.where(in_read, base, 0).to(torch.uint8)

    rc = seqops.reverse_complement(base, total)
    read = torch.where(is_rev[:, None], rc, base)

    quals = torch.zeros((B, l_out), dtype=torch.uint8, device=dev)
    if fastq:
        seg_cls = seg_qclass.reshape(-1)[seg_flat_idx]
        cls = torch.where(
            is_seg, seg_cls,
            torch.where(is_ht, apply_errors.QCLASS_HT, QCLASS_UNMAPPED).to(_I32)
        )
        u_q = rng.uniform_per_slot(sk, rng.SITE_QUAL, (l_out,))
        q = tables.qual.sample(cls, u_q)
        q = torch.where(in_read, q, 0)
        q = torch.where(is_rev[:, None], seqops.reverse_quals(q, total), q)
        quals = torch.where(in_read, (q + 33).to(torch.uint8), 0).to(torch.uint8)

    return ChimericBatchOut(
        read=read,
        quals=quals,
        valid=valid,
        total_len=total,
        head=head,
        tail=tail,
        n_seg=n_seg,
        seg_middle_ref=seg_mref,
        seg_l_new=seg_lnew,
        seg_offset=seg_offset,
        gap_len=gap_lens,
        chrom=per_slot(chrom_f, S),
        local_pos=per_slot(pos_f, S),
        is_reversed=is_rev,
        ev_pos2x=walk.events_pos2x,
        ev_type=walk.events_type,
        ev_len=ev_len_seg,
        n_events=per_slot(torch.where(seg_active, walk.n_events, 0), S),
        seg_read_prehp=seg_read_prehp,
    )


def chimeric_plan(profile, genome, *, min_len: int = 50, max_len: float = float("inf"),
                  kmer_bias: Optional[int] = None, fastq: bool = True,
                  circular_dna: bool = False, s_max: int = 8) -> dict:
    """The keyword arguments of `chimeric_batch` that the port's chimeric
    simulator derives from the profile and the genome."""
    max_len = min(max_len, genome.max_chrom)
    l_cap = plan_ref_capacity(profile, max_len, genome.max_chrom)
    ht_cap = plan_ht_capacity(profile)
    gap_support = 10.0 ** (float(np.max(profile.kde_gap.data)) + 6 * profile.kde_gap.bandwidth)
    gap_cap = max(128, int(-(-min(gap_support * 1.4, 1e5) // 128) * 128))
    return dict(
        l_cap=l_cap, l_out=l_cap * 2 + gap_cap * 2 + ht_cap, ht_cap=ht_cap,
        e_max=plan_event_budget(profile, l_cap, slack=2.5), gap_cap=gap_cap,
        gap_steps=-(-(int(gap_cap * 1.3) + 64) // 8) * 8, s_max=s_max, fastq=fastq,
        circular_dna=circular_dna, min_len=min_len, max_len=max_len,
        segment_mean=profile.segment_mean, kmer_bias=kmer_bias,
        hp_r_max=max(128, l_cap // 32),
    )
