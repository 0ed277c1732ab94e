"""The aligned-read batch program in plain PyTorch: a frozen copy of the
port's `genome_batch` (its read-emitting program, KDE lengths, the fused
read or the homopolymer path) with the capacity planning of its simulator,
run on the CPU by the benchmark's reference.

Every draw is a counter-addressed threefry uniform of (seed, stream, slot,
site, position), so a batch of any slot ids gives, lane by lane, what the
program's batches give for the same slots: the reference runs only the
slots it checks.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from . import apply_errors, assemble, extract, homopolymer, rng, seqops, xla_math
from . import walk as error_walk
from .bundles import (FULL_EVENT_SLACK, SimTables, plan_event_budget, plan_ht_capacity,
                      plan_ref_capacity)


class BatchOut(NamedTuple):
    """Per-lane results of a batch program (all [B] unless noted)."""

    valid: torch.Tensor  # bool
    total_len: torch.Tensor  # int32
    head: torch.Tensor  # int32
    tail: torch.Tensor  # int32
    middle_ref: torch.Tensor  # int32
    l_new: torch.Tensor  # int32
    chrom: torch.Tensor  # int32
    local_pos: torch.Tensor  # int64
    is_reversed: torch.Tensor  # bool
    ev_pos2x: torch.Tensor  # [B, E] int32
    ev_type: torch.Tensor  # [B, E] int32
    ev_len: torch.Tensor  # [B, E] int32
    ev_valid: torch.Tensor  # [B, E] bool
    n_events: torch.Tensor  # int32
    # capacity overflow (walk budget / l_cap / l_out exceeded): the slot is
    # NOT statistically rejected — it must be rerun with a larger budget
    capacity_overflow: torch.Tensor
    # the walk's INPUT length (clipped KDE draw) — with the slot id this
    # fully determines the event list, enabling host-side walk replay
    m_ref_init: torch.Tensor
    # the read-emitting program only (None in the meta-only program):
    read: Optional[torch.Tensor] = None  # [B, L] uint8 ASCII, final orientation
    quals: Optional[torch.Tensor] = None  # [B, L] uint8 phred+33 (zeros unless fastq)
    # homopolymer mode only: the pass-1 mutated middle before run resizing
    # (the ground-truth error log slices its seq bases from it)
    read_prehp: Optional[torch.Tensor] = None  # [B, l_cap] uint8 ASCII


def _ndtri(q: torch.Tensor) -> torch.Tensor:
    sqrt2 = torch.tensor(2.0, dtype=torch.float32, device=q.device).sqrt()
    return sqrt2 * xla_math.erfinv_f32(2.0 * q - 1.0)


def _kde_draw(sk, site, kde, n_cand=1):
    """Per-slot KDE draws: [B, n_cand] samples."""
    u = rng.uniform_per_slot(sk, site, (n_cand, 2))
    comp = u[..., 0].reshape(-1)
    lo = torch.tensor(1e-7, dtype=torch.float32, device=u.device)
    hi = torch.tensor(1 - 1e-7, dtype=torch.float32, device=u.device)
    z = _ndtri(torch.minimum(torch.maximum(u[..., 1].reshape(-1), lo), hi))
    out = kde.sample(comp, z)
    return out.reshape(u.shape[0], n_cand)


def _first_valid(cands, valid):
    """Pick the first valid candidate per lane; (value, any_valid)."""
    idx = valid.to(torch.int32).argmax(dim=1)
    return cands.gather(1, idx[:, None])[:, 0], valid.any(dim=1)


def draw_ht(sk, tables: SimTables, ht_cap: int):
    """Head/tail remainder + ratio draws with the reference's filters
    (remainder >= 0, 0 <= ratio <= 1; simulator.py:1456-1479).

    Returns (remainder i32, head i32, tail i32, ok bool).
    """
    rem_c = _kde_draw(sk, rng.SITE_REMAINDER, tables.kde_ht, 4)
    rem, rem_ok = _first_valid(rem_c, rem_c >= 0)
    ratio_c = _kde_draw(sk, rng.SITE_HT_RATIO, tables.kde_ht_ratio, 4)
    ratio, ratio_ok = _first_valid(ratio_c, (ratio_c >= 0) & (ratio_c <= 1))
    remainder = rem.to(torch.int32)  # int() truncation
    head = torch.round(remainder * ratio).to(torch.int32)
    head = torch.where(remainder == 0, torch.zeros_like(head), head)
    tail = remainder - head
    ok = rem_ok & ratio_ok & (remainder <= ht_cap)
    return remainder, head, tail, ok


def assemble_read(
    read_mid: torch.Tensor,  # [B, l_cap] uint8 mutated middle
    qclass_mid: torch.Tensor,  # [B, l_cap] int32
    l_new: torch.Tensor,
    head: torch.Tensor,
    tail: torch.Tensor,
    sk: torch.Tensor,
    tables: SimTables,
    l_out: int,
    ht_cap: int,
    fastq: bool,
):
    """Head bases + middle + tail bases; per-base classes; strand flip; quals.

    Mirrors simulator.py:1421-1443: head/tail random bases, ht-class
    qualities at both flanks, reverse complement at 1 - strandness.

    Bases and classes are packed into 16-bit values (base | class << 8), the
    mutated middle and the random head/tail pool; ops/assemble_cuda places
    them (the CUDA kernel on the card), the strand flip and the class
    reversal riding along.
    """
    total = head + l_new + tail

    u_ht = rng.uniform_per_slot(sk, rng.SITE_HEAD_TAIL, (ht_cap,))
    ht_bases = seqops.random_bases(u_ht)  # [B, ht_cap]

    packed_mid = read_mid.to(torch.int16) | (qclass_mid.to(torch.int16) << 8)
    packed_ht = ht_bases.to(torch.int16) | (apply_errors.QCLASS_HT << 8)

    u_strand = rng.uniform_per_slot(sk, rng.SITE_STRAND)
    is_rev = u_strand > tables.strandness_rate
    out = assemble.assemble_rolls(packed_mid, packed_ht, head, l_new, total, is_rev, l_out)
    read = (out & 0xFF).to(torch.uint8)

    quals = torch.zeros_like(read)
    if fastq:
        cls = (out >> 8).to(torch.int32)
        u_q = rng.uniform_per_slot(sk, rng.SITE_QUAL, (l_out,))
        q = tables.qual.sample(cls, u_q)
        in_read = torch.arange(l_out, device=read.device)[None, :] < total[:, None]
        quals = torch.where(in_read, (q + 33).to(torch.uint8), 0).to(torch.uint8)

    return read, quals, total, is_rev


def genome_batch(
    base_key: torch.Tensor,
    slots: torch.Tensor,  # [B] int64 global slot ids
    genome: extract.GenomeDevice,
    tables: SimTables,
    *,
    l_cap: int,
    l_out: int,
    ht_cap: int,
    e_max: int,
    min_len: int,
    max_len: float,
    fastq: bool = False,
    circular_dna: bool = False,
    kmer_bias: Optional[int] = None,
    hp_r_max: int = 256,
) -> BatchOut:
    """The aligned-read batch program, read-emitting: KDE lengths, the
    walk, positions, and the fused read (K3's gather), or with kmer_bias
    (homopolymer mode, `-hp -k`) suppression -> gather map ->
    materialization -> run resizing (at most hp_r_max runs per lane) ->
    assembly."""
    sk = rng.slot_keys(base_key, slots)
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=slots.device)

    # --- aligned-region length (simulator.py:1284-1296) ---
    ref_len_f = _kde_draw(sk, rng.SITE_REF_LENGTH, tables.kde_aligned, 1)[:, 0]
    remainder, head, tail, ht_ok = draw_ht(sk, tables, ht_cap)
    valid = (ht_ok & (ref_len_f > 0) & (ref_len_f <= f32(max_len))
             & (ref_len_f <= f32(l_cap)))
    m_ref = xla_math.f32_to_i32(ref_len_f).clamp(0, l_cap)

    walk = error_walk.error_walk(
        sk, m_ref, tables.first_match, tables.match_markov, tables.mixtures, tables.trans,
        e_max)
    middle_ref, l_new = walk.middle_ref, walk.l_new
    cap_over = (walk.overflow | (middle_ref > l_cap) | (l_new > l_cap)
                | (ref_len_f > f32(l_cap)))
    total0 = remainder + l_new
    cap_over |= (total0 > l_out) & (total0.double() <= max_len)
    valid &= ~cap_over
    valid &= (total0 >= min_len) & (total0.double() <= max_len)

    # --- extraction (simulator.py:1694-1781) ---
    chrom, local_pos, pos_ok = extract.sample_genome_positions(
        sk, middle_ref, genome, circular_dna)
    valid &= pos_ok
    u_strand = rng.uniform_per_slot(sk, rng.SITE_STRAND)
    is_rev = u_strand > tables.strandness_rate

    read_prehp = None
    ev_len = walk.events_len
    if kmer_bias is not None:
        # the hp run analysis needs the aligned per-byte extraction
        ref_seg = extract.gather_segments(genome, chrom, local_pos, middle_ref, l_cap)
        u_iupac, u_mis = rng.uniform2_per_slot(sk, rng.SITE_IUPAC, (l_cap,))
        ref_seg = seqops.resolve_iupac(ref_seg, u_iupac)
        # drop error events overlapping >= k homopolymer runs
        # (mutate_read, simulator.py:1920-1950); zero-length events are
        # no-ops downstream and skipped by the log writers
        keep = homopolymer.suppress_hp_errors(
            ref_seg, middle_ref, walk.events_pos2x, walk.events_type, ev_len,
            walk.events_valid, kmer_bias)
        ev_len = torch.where(keep, ev_len, 0)
        gm = apply_errors.build_gather_map(
            walk.events_pos2x, walk.events_type, ev_len, walk.events_valid, middle_ref, l_cap)
        u_ins, _ = rng.uniform2_per_slot(sk, rng.SITE_INS_BASE, (l_cap,))
        read_prehp = apply_errors.materialize_read(gm.src, gm.qclass, gm.valid, ref_seg,
                                                   u_mis, u_ins)
        # resize homopolymer runs in the mutated read (mutate_homo,
        # simulator.py:618-705)
        read_mid, qclass_mid, l_new, hp_ok = homopolymer.resize_homopolymers(
            sk, read_prehp, gm.qclass, gm.read_len, tables.hp_breaks, tables.hp_vals,
            tables.hp_mis_rate, kmer_bias, hp_r_max, l_cap)
        # run-table overflow (and post-resize middles beyond the l_cap
        # buffer) are CAPACITY conditions, not statistical rejections: the
        # reference has no such limits, so the lane is re-run through the
        # rescue program (whose r_max = l_cap // k + 1 can never overflow) to
        # keep read numbering reference-exact
        cap_over |= ~hp_ok | (l_new > l_cap)
        valid &= hp_ok & (l_new <= l_cap)
        read, quals, total, _ = assemble_read(
            read_mid, qclass_mid, l_new, head, tail, sk, tables, l_out, ht_cap, fastq)
    else:
        # chunked extraction for linear DNA (whole 256-byte rows, the
        # intra-chunk offset folded into the code gather); circular wrap
        # needs the per-byte path
        if not circular_dna:
            ref_seg, seg_off = extract.gather_segments_padded(genome, chrom, local_pos, l_cap)
            u_iupac, _ = rng.uniform2_per_slot(sk, rng.SITE_IUPAC, (l_cap + extract.CHUNK,))
        else:
            seg_off = None
            ref_seg = extract.gather_segments(genome, chrom, local_pos, middle_ref, l_cap)
            u_iupac, _ = rng.uniform2_per_slot(sk, rng.SITE_IUPAC, (l_cap,))
        ref_seg = seqops.resolve_iupac(ref_seg, u_iupac)
        # substitution/insertion uniforms and head/tail bases are addressed
        # by output position, so values do not depend on buffer widths
        u_mis, u_ins = rng.uniform2_per_slot(sk, rng.SITE_MIS_BASE, (l_out,))
        ref_codes = apply_errors._pack_codes4(ref_seg)
        pad = (-ref_codes.shape[1]) % 128
        if pad:
            ref_codes = torch.nn.functional.pad(ref_codes, (0, pad))
        read, qclass, l_new, total = apply_errors.fused_read_v2(
            walk.events_pos2x, walk.events_type, walk.events_len, walk.events_valid,
            middle_ref, head, tail, is_rev, ref_codes, ref_seg.shape[1], seg_off, sk,
            u_mis, u_ins, l_out, ht_cap, rng.SITE_HEAD_TAIL)
        quals = torch.zeros_like(read)
        if fastq:
            u_q = rng.uniform_per_slot(sk, rng.SITE_QUAL, (l_out,))
            q = tables.qual.sample(qclass, u_q)
            in_read = torch.arange(l_out, device=read.device)[None, :] < total[:, None]
            quals = torch.where(in_read, (q + 33).to(torch.uint8), 0).to(torch.uint8)
    # final length filter (simulator.py:1429-1430).  Homopolymer mode must
    # NOT re-filter on the post-resize total: the reference's min/max check
    # runs on error_list's pre-mutation total only (simulator.py:1367-1368)
    # and mutate_homo never re-checks — that filter already ran on total0.
    if kmer_bias is None:
        valid &= (total >= min_len) & (total.double() <= max_len)
    cap_over |= total > l_out
    valid &= ~cap_over
    return BatchOut(
        valid=valid, total_len=total, head=head, tail=tail, middle_ref=middle_ref,
        l_new=l_new, chrom=chrom, local_pos=local_pos, is_reversed=is_rev,
        ev_pos2x=walk.events_pos2x, ev_type=walk.events_type, ev_len=ev_len,
        ev_valid=walk.events_valid, n_events=walk.n_events,
        capacity_overflow=cap_over, m_ref_init=m_ref, read=read, quals=quals,
        read_prehp=read_prehp,
    )


def aligned_plan(profile, genome, *, min_len: int = 50, max_len: float = float("inf"),
                 kmer_bias: Optional[int] = None, fastq: bool = True,
                 circular_dna: bool = False) -> dict:
    """The keyword arguments of `genome_batch` that the port's simulator
    derives from the profile and the genome, at the rescue-grade budget (the
    full event budget; in homopolymer mode a run table that cannot
    overflow), under which a lane is accepted exactly when the program
    emits it."""
    max_len = min(max_len, genome.max_chrom)
    l_cap = plan_ref_capacity(profile, max_len, genome.max_chrom)
    ht_cap = plan_ht_capacity(profile)
    return dict(
        l_cap=l_cap, l_out=-(-(l_cap + ht_cap) // 1024) * 1024, ht_cap=ht_cap,
        e_max=plan_event_budget(profile, l_cap, slack=FULL_EVENT_SLACK), min_len=min_len,
        max_len=max_len, fastq=fastq, circular_dna=circular_dna, kmer_bias=kmer_bias,
        hp_r_max=(l_cap // max(kmer_bias, 1) + 1) if kmer_bias is not None else 256,
    )
