"""Chimeric-read simulation (the genome aligned pass with `--chimeric`).

The reference draws a Geometric segment count per read, synthesizes each
aligned segment with the full error pipeline, joins segments with
unaligned-error "gap" sequences, and applies one head/tail + strand decision
to the whole read (simulator.py:1266-1454).

Device mapping: segments are extra lanes — the walk/extraction/mutation
pipeline runs once over a flattened [S * B] batch (inactive segments are dead
lanes that exit the walk immediately), gaps over [(S-1) * B] with the
unaligned walk, and a parts table (head, seg0, gap0, seg1, ..., tail) is
assembled into the final read by a row-wise search over part offsets.  The
segment walks run the aligned-walk kernel and the gap walks the unaligned-walk
kernel of ops/walk_cuda.py; the read-emitting program's byte gathers run the
gather kernel of ops/gather_cuda.py.

Segment counts are capped at `s_max` (default 8); with the typical
segment_mean ~1.3 the clamp probability is < 1e-5 (the reference has no cap;
clamped draws are counted).

Two routes, as for plain genome reads.  Linear DNA runs the meta-only program
with packed walks (only the active (slot, segment) pairs get a walk lane); one
[B, K] int64 meta row per lane goes to the host, which replays the segment
and gap walks with part-keyed streams, checks each against the device
checksum and emits with the C++ emitter.  Circular DNA, NANOSIM_TPU_RECON=0
and homopolymer mode run the read-emitting program and transfer the reads.

The metagenome variant of this program (per-segment species, the lognormal
median/sd lengths and perfect reads) is not part of the genome CLI's
`--chimeric` and comes with the metagenome mode.
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import apply_errors, error_walk, homopolymer, rng, seqops, xla_math
from . import extract
from .bundles import SimTables, build_tables, plan_event_budget, plan_ht_capacity, plan_ref_capacity
from .compact import event_checksum as _ev_checksum  # the host replay recomputes it per lane
from .genome_mode import (_first_valid, _kde_draw, check_circular, device_of, draw_ht,
                          run_prefetched, want_recon)
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
    seg_offset: torch.Tensor  # [B, S] int32 — read-coordinate start of each seg (pre-reverse)
    gap_len: torch.Tensor  # [B, S-1] int32 mutated gap lengths
    chrom: torch.Tensor  # [B, S] int32
    local_pos: torch.Tensor  # [B, S] int64
    is_reversed: torch.Tensor  # [B]
    ev_pos2x: torch.Tensor  # [B*S, E] (dummy [1,1] in meta-only outputs)
    ev_type: torch.Tensor  # [B*S, E]
    ev_len: torch.Tensor  # [B*S, E]
    n_events: torch.Tensor  # [B, S]
    seg_read_prehp: torch.Tensor  # [B*S, l_cap] pass-1 mutated segments (log source)
    # walk INPUT lengths + gap-walk provenance (bit-identity replay inputs;
    # tiny next to the event buffers)
    seg_mref_init: Optional[torch.Tensor] = None  # [B, S] int32
    gap_mref_init: Optional[torch.Tensor] = None  # [B, S-1] int32
    gap_chrom: Optional[torch.Tensor] = None  # [B, S-1] int32
    gap_pos: Optional[torch.Tensor] = None  # [B, S-1] int64
    gap_ev_pos2x: Optional[torch.Tensor] = None  # [B*(S-1), Eg] (per-STEP, matches len 0)
    gap_ev_type: Optional[torch.Tensor] = None
    gap_ev_len: Optional[torch.Tensor] = None
    gap_n_steps: Optional[torch.Tensor] = None  # [B, S-1]
    # host-reconstruction extras (meta-only program)
    gap_middle: Optional[torch.Tensor] = None  # [B, S-1] int32 gap walk ref spans
    seg_cksum: Optional[torch.Tensor] = None  # [B, S] uint32 (in int64) event-word checksums
    gap_cksum: Optional[torch.Tensor] = None  # [B, S-1] uint32 (in int64) step-word checksums
    packed_spill: Optional[torch.Tensor] = None  # [] bool — packed lane capacity exceeded
    # (host must re-run the batch through the unpacked program)


def _geometric(u: torch.Tensor, p: float) -> torch.Tensor:
    """np.random.geometric semantics: support 1.., P(k) = p (1-p)^(k-1).

    The precisions are the JAX program's: log1p(-u) in float32 (XLA's), the
    denominator log1p(-p) of the Python float in float64 rounded once to
    float32, a float32 division."""
    den = torch.tensor(np.float32(math.log1p(-p)), dtype=torch.float32, device=u.device)
    return torch.ceil(xla_math.log1p_f32(-u) / den).to(_I32)


def _packed_capacity(mean_act: float, sd_act: float, n_pairs: int, packed_cap) -> int:
    """Packed lane-block capacity: mean + 10 sigma of the active-pair count,
    in blocks of 128 lanes, at most all pairs; packed_cap clamps it."""
    cap = min(n_pairs, -(-int(mean_act + 10 * sd_act + 64) // 128) * 128)
    if packed_cap is not None:
        cap = min(cap, max(int(packed_cap), 1))
    return cap


def _pack_lanes(active: torch.Tensor, cap: int):
    """Route the active pairs of a flattened [N] layout to a [cap] lane block.

    Returns (lane_src [cap] int64: the pair each lane computes, N for a dead
    lane; spill [] bool: more active pairs than lanes).  Dead pairs scatter
    into the one dump slot `cap`, which is sliced off: only that slot is
    written more than once."""
    N = active.shape[0]
    dev = active.device
    a32 = active.to(_I32)
    rank = torch.cumsum(a32, dim=0, dtype=_I32) - 1
    spill = a32.sum() > cap
    scat = torch.where(active & (rank < cap), rank, cap).long()
    lane_src = torch.full((cap + 1,), N, dtype=torch.int64, device=dev)
    lane_src[scat] = torch.arange(N, dtype=torch.int64, device=dev)
    return lane_src[:cap], spill


def _unpacker(lane_src: Optional[torch.Tensor], n: int):
    """(xk, fill) -> the [n] flattened layout: scatter of a packed lane block
    (dead lanes land in the dump slot n), or the identity when unpacked."""
    if lane_src is None:
        return lambda xk, fill: xk

    def unpack(xk, fill):
        buf = torch.full((n + 1,), fill, dtype=xk.dtype, device=xk.device)
        buf[lane_src] = xk
        return buf[:n]

    return unpack


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
    count_gap_in_total: bool,
    metagenome: bool = False,
    perfect: bool = False,
    kmer_bias: Optional[int] = None,
    hp_r_max: int = 256,
    median_len: Optional[float] = None,
    sd_len: Optional[float] = None,
    emit_reads: bool = True,
    packed_walks: bool = True,
    # test/override clamp on the packed lane-block capacities (forces the
    # spill->unpacked-re-run path deterministically; None = mean+10-sigma)
    packed_cap: Optional[int] = None,
) -> ChimericBatchOut:
    if metagenome or perfect or median_len is not None:
        raise NotImplementedError(
            "chimeric_batch: metagenome=True, perfect=True and median_len belong to the "
            "metagenome slice and are not ported yet")
    assert emit_reads or kmer_bias is None, (
        "meta-only chimeric program supports the plain aligned path (not -hp)"
    )
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

    SB = S * B
    seg_active = (
        torch.arange(S, dtype=_I32, device=dev).repeat_interleave(B) < n_seg.repeat(S)
    )  # [S*B] segment-major

    # Dense segment packing (meta-only program).  The flattened [S*B] layout
    # spends a full walk lane on every POSSIBLE segment, but with the typical
    # segment_mean ~1.3 only ~1.3*B pairs are real — most of the walk width
    # is dead lanes that still pay every step.  Here only the ACTIVE
    # (slot, segment) pairs are routed to a [K] lane block; per-lane keys are
    # (slot, part)-addressed, so WHERE a pair computes cannot change its
    # draws, and results scatter back into the [S*B] layout.  If the active
    # count ever exceeds K (vanishingly unlikely at K=2B: mean ~1.33B,
    # sd ~0.6*sqrt(B)), packed_spill is set and the host re-runs the batch
    # through this same program unpacked — acceptance stays slot-pure.
    packed = packed_walks and not emit_reads and S > 1
    spill = torch.zeros((), dtype=torch.bool, device=dev)
    if packed:
        # capacity = mean + 10 sigma of the active-pair count (sum of B
        # truncated geometrics with mean segment_mean); spill is then a
        # >10-sigma event, handled by the unpacked re-run
        k_cap = _packed_capacity(B * segment_mean, math.sqrt(B) * segment_mean, SB, packed_cap)
        lane_src, spill = _pack_lanes(seg_active, k_cap)
        seg_live = lane_src < SB
        src_c = lane_src.clamp_max(SB - 1)  # dead lanes mirror a real pair
        sk_seg = rng.part_slot_keys(sk[src_c % B], rng.PART_SEGMENT_BASE, src_c // B)
        seg_unpack = _unpacker(lane_src, SB)
    else:
        # per-(slot, segment) keys, all S*B pairs
        seg_keys = [rng.part_slot_keys(sk, rng.PART_SEGMENT_BASE, s) for s in range(S)]
        sk_seg = torch.cat(seg_keys, dim=0)  # [S*B, 2] (segment-major)
        seg_live = seg_active
        seg_unpack = _unpacker(None, SB)

    if S > 1:
        GB = (S - 1) * B
        gap_active = (
            torch.arange(S - 1, dtype=_I32, device=dev).repeat_interleave(B)
            < (n_seg - 1).repeat(S - 1)
        )  # [(S-1)*B] gap-major
        if packed:
            # gaps: mean active = (segment_mean - 1) * B
            kg_cap = _packed_capacity(B * (segment_mean - 1.0), math.sqrt(B) * segment_mean,
                                      GB, packed_cap)
            gap_lane_src, gspill = _pack_lanes(gap_active, kg_cap)
            spill = spill | gspill
            gap_live = gap_lane_src < GB
            gsrc_c = gap_lane_src.clamp_max(GB - 1)
            sk_gap = rng.part_slot_keys(sk[gsrc_c % B], rng.PART_GAP_BASE, gsrc_c // B)
            gap_unpack = _unpacker(gap_lane_src, GB)
        else:
            gap_keys = [rng.part_slot_keys(sk, rng.PART_GAP_BASE, s) for s in range(S - 1)]
            sk_gap = torch.cat(gap_keys, dim=0)  # [(S-1)*B, 2]
            gap_live = gap_active
            gap_unpack = _unpacker(None, GB)

    def per_slot(x, n):  # flattened [n*B] part-major -> [B, n]
        return x.reshape(n, B).T

    # --- per-segment aligned lengths (iid conditional on the reference's
    # filter (0, max]; simulator.py:832-850) ---
    ref_c = _kde_draw(sk_seg, rng.SITE_REF_LENGTH, tables.kde_aligned, 2)
    ref_f, ref_ok = _first_valid(ref_c, (ref_c > 0) & (ref_c <= f32(max_len)))
    m_ref_lane = torch.where(seg_live, ref_f.to(_I32).clamp(0, l_cap), 0)
    seg_len_ok = seg_unpack(torch.where(seg_live, ref_ok & (ref_f <= f32(l_cap)), True), True)
    seg_mref_init = seg_unpack(m_ref_lane, 0)

    # --- head/tail ---
    remainder, head, tail, ht_ok = draw_ht(sk, tables, ht_cap)

    # --- segment error walks on the flattened batch ---
    walk = error_walk.error_walk(
        sk_seg, m_ref_lane, tables.first_match, tables.match_markov,
        tables.mixtures, tables.trans, e_max,
    )
    seg_mref = per_slot(seg_unpack(walk.middle_ref, 0), S)  # [B, S]
    seg_lnew = per_slot(seg_unpack(torch.where(seg_live, walk.l_new, 0), 0), S)
    walk_ok = per_slot(seg_unpack(
        torch.where(seg_live,
                    ~walk.overflow & (walk.middle_ref <= l_cap) & (walk.l_new <= l_cap),
                    True),
        True,
    ), S).all(dim=1)

    # --- gap lengths + gap synthesis (simulator.py:1298-1299, 1552-1568) ---
    G = max(S - 1, 1)
    if S > 1:
        gap_f = _kde_draw(sk_gap, rng.SITE_GAP, tables.kde_gap, 1)[:, 0]
        gap_ref = torch.where(gap_live, gap_f.clamp_min(0).to(_I32), 0)
        gap_ref = gap_ref.clamp_max(gap_cap)
        gwalk = error_walk.unaligned_walk(sk_gap, gap_ref, tables.mixtures, gap_steps)
        gap_ok = per_slot(gap_unpack(
            torch.where(gap_live, ~gwalk.overflow & (gwalk.l_new <= gap_cap), True), True
        ), S - 1).all(dim=1)

        # gap extraction + mutation
        g_chrom, g_pos, g_pos_ok = extract.sample_genome_positions(
            sk_gap, gwalk.middle_ref, genome, circular_dna
        )
        gap_ok &= per_slot(gap_unpack(
            torch.where(gap_live, g_pos_ok, True), True
        ), S - 1).all(dim=1)
        if emit_reads:
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
        else:
            # closed form of build_unaligned_map's presentation overflow
            g_tot_ins = torch.where(
                gwalk.events_valid & (gwalk.events_type == 1), gwalk.events_len, 0).sum(dim=1)
            g_map_ov = (gwalk.middle_ref + g_tot_ins) > apply_errors.presentation_cap(gap_cap)
            gap_read = torch.zeros((1, 1), dtype=torch.uint8, device=dev)
        gap_ok &= per_slot(gap_unpack(
            torch.where(gap_live, ~g_map_ov, True), True
        ), S - 1).all(dim=1)

        def gap_field(x):
            return per_slot(gap_unpack(torch.where(gap_live, x, 0), 0), S - 1)

        gap_lens = gap_field(gwalk.l_new)  # [B, S-1]
        gap_mref_init = gap_field(gap_ref)
        gap_chrom = gap_field(g_chrom)
        gap_pos = gap_field(g_pos)
        if emit_reads:
            gap_ev = (gwalk.events_pos2x, gwalk.events_type, gwalk.events_len)
        else:  # meta-only: the host replays gap walks from the meta row
            gap_ev = tuple(torch.zeros((1, 1), dtype=_I32, device=dev) for _ in range(3))
        gap_n_steps = gap_field(gwalk.n_events)
        gap_middle = gap_field(gwalk.middle_ref)
        gap_cksum = per_slot(gap_unpack(_ev_checksum(
            gwalk.events_pos2x, gwalk.events_type, gwalk.events_len,
            torch.where(gap_live, gwalk.n_events, 0),
        ), 0), S - 1)
    else:
        gap_ok = torch.ones(B, dtype=torch.bool, device=dev)
        gap_read = torch.zeros((G * B, gap_cap), dtype=torch.uint8, device=dev)
        gap_lens = torch.zeros((B, G), dtype=_I32, device=dev)
        gap_mref_init = torch.zeros((B, G), dtype=_I32, device=dev)
        gap_chrom = torch.zeros((B, G), dtype=_I32, device=dev)
        gap_pos = torch.zeros((B, G), dtype=torch.int64, device=dev)
        gap_ev = tuple(torch.zeros((G * B, 8), dtype=_I32, device=dev) for _ in range(3))
        gap_n_steps = torch.zeros((B, G), dtype=_I32, device=dev)
        gap_middle = torch.zeros((B, G), dtype=_I32, device=dev)
        gap_cksum = torch.zeros((B, G), dtype=torch.int64, device=dev)

    # --- total-length filter (simulator.py:1354-1368; genome mode does not
    # count the gaps) ---
    total0 = remainder + seg_lnew.sum(dim=1, dtype=_I32)
    if count_gap_in_total:
        total0 = total0 + gap_lens.sum(dim=1, dtype=_I32)
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
    valid &= per_slot(seg_unpack(torch.where(seg_live, pos_ok, True), True), S).all(dim=1)
    u_strand = rng.uniform_per_slot(sk, rng.SITE_STRAND)
    is_rev = u_strand > tables.strandness_rate

    if not emit_reads:
        # Meta-only program (host reconstruction): no gathers, no gather map,
        # no materialization, no [B, l_out] assembly.  seg_l_new is the
        # dict-overwrite-aware read length (gm.read_len's closed form).
        # inactive lanes masked to 0 so packed and unpacked meta rows are
        # byte-identical (dead-lane draws are meaningless either way)
        chrom_flat = seg_unpack(torch.where(seg_live, chrom_f, 0), 0)
        pos_flat = seg_unpack(torch.where(seg_live, pos_f, 0), 0)
        eff = apply_errors.effective_lens(
            walk.events_pos2x, walk.events_type, walk.events_len, walk.events_valid
        )
        d_sum = torch.where(walk.events_valid & (walk.events_type == 2), eff, 0).sum(dim=1)
        i_sum = torch.where(walk.events_valid & (walk.events_type == 1), eff, 0).sum(dim=1)
        lnew_lane = (walk.middle_ref - d_sum + i_sum).to(_I32)
        seg_lnew = per_slot(seg_unpack(torch.where(seg_live, lnew_lane, 0), 0), S)
        seg_cksum = per_slot(seg_unpack(_ev_checksum(
            walk.events_pos2x, walk.events_type, walk.events_len,
            torch.where(seg_live, walk.n_events, 0),
        ), 0), S)

        part_off = _part_table(head, tail, seg_lnew, gap_lens, S)
        total = part_off[:, -1]
        valid &= (total >= min_len) & (total.double() <= max_len) & (total <= l_out)
        valid &= ~spill  # spilled batches re-run unpacked; never half-trust
        seg_offset = part_off[:, 1 : 1 + 2 * S : 2]
        dummy = torch.zeros((B, 4), dtype=torch.uint8, device=dev)
        dummy_ev = torch.zeros((1, 1), dtype=_I32, device=dev)
        return ChimericBatchOut(
            read=dummy,
            quals=dummy,
            valid=valid,
            total_len=total,
            head=head,
            tail=tail,
            n_seg=n_seg,
            seg_middle_ref=seg_mref,
            seg_l_new=seg_lnew,
            seg_offset=seg_offset,
            gap_len=gap_lens,
            chrom=per_slot(chrom_flat, S),
            local_pos=per_slot(pos_flat, S),
            is_reversed=is_rev,
            ev_pos2x=dummy_ev,
            ev_type=dummy_ev,
            ev_len=dummy_ev,
            n_events=per_slot(seg_unpack(torch.where(seg_live, walk.n_events, 0), 0), S),
            seg_read_prehp=dummy,
            seg_mref_init=per_slot(seg_mref_init, S),
            gap_mref_init=gap_mref_init,
            gap_chrom=gap_chrom,
            gap_pos=gap_pos,
            gap_ev_pos2x=gap_ev[0],
            gap_ev_type=gap_ev[1],
            gap_ev_len=gap_ev[2],
            gap_n_steps=gap_n_steps,
            gap_middle=gap_middle,
            seg_cksum=seg_cksum,
            gap_cksum=gap_cksum,
            packed_spill=spill,
        )

    ref_seg = extract.gather_segments(genome, chrom_f, pos_f, walk.middle_ref, l_cap)
    su_iupac, su_mis = rng.uniform2_per_slot(sk_seg, rng.SITE_IUPAC, (l_cap,))
    ref_seg = seqops.resolve_iupac(ref_seg, su_iupac)
    del su_iupac
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
    del ref_seg, su_mis, su_ins
    seg_read_prehp = seg_read
    seg_qclass, seg_read_len = gm.qclass, gm.read_len
    del gm
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

    # --- parts assembly ---
    # parts per read: head, (seg s, gap s)*, tail  -> 2S+1 part slots
    n_parts = 2 * S + 1
    part_off = _part_table(head, tail, seg_lnew, gap_lens, S)  # [B, n_parts+1]
    total = part_off[:, -1]
    valid &= (total >= min_len) & (total.double() <= max_len) & (total <= l_out)
    seg_offset = part_off[:, 1 : 1 + 2 * S : 2]  # [B, S] read-coordinate seg starts

    j = torch.arange(l_out, dtype=_I32, device=dev)[None, :]
    # part index per output base: count(part_off <= j) - 1 over the 2S+2
    # non-decreasing offsets, as a row-wise sorted search
    part = torch.searchsorted(part_off.contiguous(), j.expand(B, l_out).contiguous(),
                              right=True) - 1  # [B, l_out] int64
    part = part.clamp(0, n_parts - 1)
    inner = j - torch.gather(part_off, 1, part)

    is_head = part == 0
    is_tail = part == n_parts - 1
    is_seg = (part % 2 == 1) & ~is_tail
    seg_idx = ((part - 1) // 2).clamp(0, S - 1)
    gap_idx = ((part - 2) // 2).clamp(0, S - 2) if S > 1 else torch.zeros_like(part)
    del part

    # gather bases: segment buffer is [S*B, l_cap] segment-major
    b_col = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    seg_flat_idx = ((seg_idx * B + b_col) * l_cap + inner.clamp(0, l_cap - 1)).clamp(
        0, SB * l_cap - 1)
    seg_bases = seg_read.reshape(-1)[seg_flat_idx]
    if S > 1:
        gap_flat_idx = ((gap_idx * B + b_col) * gap_cap + inner.clamp(0, gap_cap - 1)).clamp(
            0, gap_read.numel() - 1)
        gap_bases = gap_read.reshape(-1)[gap_flat_idx]
        del gap_flat_idx
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
        seg_mref_init=per_slot(seg_mref_init, S),
        gap_mref_init=gap_mref_init,
        gap_chrom=gap_chrom,
        gap_pos=gap_pos,
        gap_ev_pos2x=gap_ev[0],
        gap_ev_type=gap_ev[1],
        gap_ev_len=gap_ev[2],
        gap_n_steps=gap_n_steps,
        gap_middle=gap_middle,
    )


CHI_META_SCALARS = 7  # valid, total, head, tail, n_seg, rev, spill
CHI_META_SEG = 8  # mref, lnew, off, chrom, pos, mref_init, n_ev, cksum
CHI_META_GAP = 7  # len, mref_init, chrom, pos, n_steps, middle, cksum


def pack_chimeric_meta(out: ChimericBatchOut) -> torch.Tensor:
    """ONE [B, K] int64 transfer with every per-lane scalar the recon writer
    needs (events stay on device; the host replays them)."""
    sp = out.packed_spill
    if sp is None:
        sp = torch.zeros((), dtype=torch.bool, device=out.valid.device)
    scal = [out.valid, out.total_len, out.head, out.tail, out.n_seg,
            out.is_reversed, sp.expand(out.valid.shape)]
    segs = [out.seg_middle_ref, out.seg_l_new, out.seg_offset, out.chrom,
            out.local_pos, out.seg_mref_init, out.n_events, out.seg_cksum]
    gaps = [out.gap_len, out.gap_mref_init, out.gap_chrom, out.gap_pos,
            out.gap_n_steps, out.gap_middle, out.gap_cksum]
    parts = [torch.stack([c.long() for c in scal], dim=1)]
    parts += [x.long() for x in segs]
    parts += [x.long() for x in gaps]
    return torch.cat(parts, dim=1)


def decode_chimeric_meta(meta: np.ndarray, S: int) -> dict:
    d = {}
    names = ["valid", "total", "head", "tail", "n_seg", "rev", "spill"]
    for i, nm in enumerate(names):
        d[nm] = meta[:, i]
    d["valid"] = d["valid"].astype(bool)
    d["rev"] = d["rev"].astype(bool)
    d["spill"] = d["spill"].astype(bool)
    off = CHI_META_SCALARS
    for nm in ("seg_mref", "seg_lnew", "seg_off", "chrom", "pos",
               "seg_mref_init", "n_events", "seg_cksum"):
        d[nm] = meta[:, off : off + S]
        off += S
    G = max(S - 1, 1)
    for nm in ("gap_len", "gap_mref_init", "gap_chrom", "gap_pos",
               "gap_n_steps", "gap_middle", "gap_cksum"):
        d[nm] = meta[:, off : off + G]
        off += G
    return d


class ChimericReconHandle:
    """A dispatched meta-only chimeric batch."""

    def __init__(self, meta_dev, slots, sim, seed):
        self.meta_dev = meta_dev
        self.slots = slots
        self.sim = sim
        self.seed = seed


class ChimericGenomeSimulator:
    """Host-side runner of chimeric genome mode: batches, slot accounting, output."""

    def __init__(
        self,
        genome,
        profile,
        *,
        fastq: bool = False,
        circular_dna: bool = False,
        min_len: int = 50,
        max_len: float = float("inf"),
        batch: int = 128,
        s_max: int = 8,
        kmer_bias: Optional[int] = None,
        device="cuda",
    ):
        if profile.kde_gap is None or profile.segment_mean is None:
            raise ValueError("chimeric reads need a profile loaded with chimeric=True")
        if fastq and profile.base_quals is None:
            raise ValueError("fastq=True needs a profile loaded with fastq=True")
        if kmer_bias is not None and profile.hp_params is None:
            raise ValueError("kmer_bias needs a profile loaded with homopolymer=True")
        check_circular(genome, circular_dna)
        self.device = device_of(device)
        self.genome_host = genome
        self.profile = profile
        max_len = min(max_len, genome.max_chrom)
        self.fastq = fastq
        self.batch = batch
        self.s_max = s_max
        self.kmer_bias = kmer_bias

        self.l_cap = plan_ref_capacity(profile, max_len, genome.max_chrom)
        self.ht_cap = plan_ht_capacity(profile)
        gap_support = 10.0 ** (float(np.max(profile.kde_gap.data)) + 6 * profile.kde_gap.bandwidth)
        self.gap_cap = max(128, int(-(-min(gap_support * 1.4, 1e5) // 128) * 128))
        self.gap_steps = -(-(int(self.gap_cap * 1.3) + 64) // 8) * 8
        self.l_out = self.l_cap * 2 + self.gap_cap * 2 + self.ht_cap
        self.e_max = plan_event_budget(profile, self.l_cap, slack=2.5)

        self.tables = build_tables(profile, self.device)
        self.genome_dev = extract.GenomeDevice.from_packed(genome, self.device)
        self.kw = dict(
            l_cap=self.l_cap,
            l_out=self.l_out,
            ht_cap=self.ht_cap,
            e_max=self.e_max,
            gap_cap=self.gap_cap,
            gap_steps=self.gap_steps,
            s_max=s_max,
            fastq=fastq,
            circular_dna=circular_dna,
            min_len=min_len,
            max_len=max_len,
            segment_mean=profile.segment_mean,
            count_gap_in_total=False,  # genome-mode quirk (simulator.py:1354-1368)
            packed_cap=(int(os.environ["NANOSIM_TPU_PACKED_CAP"])
                        if os.environ.get("NANOSIM_TPU_PACKED_CAP") else None),
            kmer_bias=kmer_bias,
            hp_r_max=max(128, self.l_cap // 32),
        )

    def batch_fn(self, **overrides):
        """The batch program (read-emitting unless emit_reads=False is
        passed) over this simulator's genome, tables and capacities."""
        return functools.partial(
            chimeric_batch,
            genome=self.genome_dev,
            tables=self.tables,
            **{**self.kw, **overrides},
        )

    def chimeric_meta_unpacked(self, slots, seed):
        """Spill fallback: re-run a batch through the UNPACKED meta program.
        Only reachable when the batch's active segment count exceeded the
        packed lane capacity (P ~ 0 at 2B); per-slot results are identical
        because every draw is (slot, part)-addressed."""
        base = rng.base_key(seed, rng.STREAM_ALIGNED, device=self.device)
        fn = self.batch_fn(emit_reads=False, packed_walks=False)
        out = fn(base, torch.as_tensor(np.asarray(slots), device=self.device))
        return pack_chimeric_meta(out).cpu().numpy()

    def run(self, n_reads, writer, seed=0, max_batches=None):
        """Simulate n_reads chimeric aligned reads into `writer`.

        Linear DNA without homopolymer mode reconstructs on the host (the
        meta-only program with packed walks, part-keyed C++ walk replays and
        the C++ splice/emit; ~100 B/lane crosses the link) unless
        NANOSIM_TPU_RECON=0; everything else runs the read-emitting program.
        The route is never changed quietly: without the native library the
        reconstruction route raises."""
        base = rng.base_key(seed, rng.STREAM_ALIGNED, device=self.device)

        recon = self.kmer_bias is None and want_recon(self.kw["circular_dna"])
        if recon:
            from ..io.native import UnalignedWalkReplayer, WalkReplayer

            self._seg_replayer = WalkReplayer(
                self.profile, seed, rng.STREAM_ALIGNED, rng.SITE_WALK,
                e_guard=self.e_max,
            )
            self._gap_replayer = UnalignedWalkReplayer(
                self.profile, seed, rng.STREAM_ALIGNED, rng.SITE_UNALIGNED_WALK,
                e_guard=self.gap_steps,
            )
            if not (self._seg_replayer.available and self._gap_replayer.available):
                raise RuntimeError(
                    "chimeric host reconstruction needs native/fastwriter.cpp built with g++")
            fn = self.batch_fn(emit_reads=False)

            def make_batch(slot_start):
                slots = np.arange(slot_start, slot_start + self.batch, dtype=np.int64)
                out = fn(base, torch.as_tensor(slots, device=self.device))
                return ChimericReconHandle(pack_chimeric_meta(out), slots, self, seed)

            return run_prefetched(make_batch, self.batch, n_reads, writer, self, max_batches)

        fn = self.batch_fn()

        def make_batch(slot_start):
            slots = torch.arange(slot_start, slot_start + self.batch, dtype=torch.int64,
                                 device=self.device)
            return fn(base, slots)

        return run_prefetched(make_batch, self.batch, n_reads, writer, self, max_batches)
