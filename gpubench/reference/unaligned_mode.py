"""The unaligned-read batch program in plain PyTorch: a frozen copy of the
port's `unaligned_batch` (its read-emitting program, KDE lengths) with the
capacity planning of its simulator."""

from __future__ import annotations


import numpy as np
import torch

from . import apply_errors, extract, rng, seqops, xla_math
from . import walk as error_walk
from .bundles import SimTables
from .genome_mode import BatchOut, _kde_draw


QCLASS_UNMAPPED = 4


def unaligned_batch(
    base_key: torch.Tensor,
    slots: torch.Tensor,
    genome: extract.GenomeDevice,
    tables: SimTables,
    *,
    l_cap: int,
    e_max: int,
    min_len: int,
    max_len: float,
    fastq: bool = False,
    circular_dna: bool = False,
) -> BatchOut:
    """The unaligned-read batch program, read-emitting, KDE lengths."""
    B = slots.shape[0]
    sk = rng.slot_keys(base_key, slots)

    ref_len_f = _kde_draw(sk, rng.SITE_REF_LENGTH, tables.kde_unaligned, 1)[:, 0]
    # a saturated draw past 2**31 fails m_ref <= l_cap, as in the JAX program
    m_ref = xla_math.f32_to_i32(ref_len_f).clamp_min(0)
    valid = (ref_len_f > 0) & (m_ref <= l_cap)

    m_walk = m_ref.clamp_max(l_cap)
    walk = error_walk.unaligned_walk(sk, m_walk, tables.mixtures, e_max)
    middle_ref, l_new = walk.middle_ref, walk.l_new
    cap_over = walk.overflow | (m_ref > l_cap) | (middle_ref > l_cap) | (l_new > l_cap)
    # length filter on middle_ref (simulator.py:1503-1504)
    valid &= ~cap_over & (middle_ref >= min_len) & (middle_ref.double() <= max_len)

    chrom, local_pos, pos_ok = extract.sample_genome_positions(
        sk, middle_ref, genome, circular_dna)
    valid &= pos_ok
    u_strand = rng.uniform_per_slot(sk, rng.SITE_STRAND)
    is_rev = u_strand > tables.strandness_rate

    ref_seg = extract.gather_segments(genome, chrom, local_pos, middle_ref, l_cap)
    u_iupac, u_mis = rng.uniform2_per_slot(sk, rng.SITE_IUPAC, (l_cap,))
    ref_seg = seqops.resolve_iupac(ref_seg, u_iupac)
    # unaligned walk: mutate_read's reverse splicing of the pos + 0.1
    # insertion keys makes same-pos mis/del act on contiguous
    # POST-insertion positions (build_unaligned_map)
    gm, under_ins, map_ov = apply_errors.build_unaligned_map(
        walk.events_pos2x, walk.events_type, walk.events_len, walk.events_valid,
        middle_ref, l_cap)
    valid &= ~map_ov
    u_ins, _ = rng.uniform2_per_slot(sk, rng.SITE_INS_BASE, (l_cap,))
    read = apply_errors.materialize_read(gm.src, gm.qclass, gm.valid, ref_seg, u_mis,
                                         u_ins, under_ins=under_ins)
    read = torch.where(is_rev[:, None], seqops.reverse_complement(read, l_new), read)
    quals = torch.zeros_like(read)
    if fastq:
        u_q = rng.uniform_per_slot(sk, rng.SITE_QUAL, (l_cap,))
        q = tables.qual.sample(torch.full(read.shape, QCLASS_UNMAPPED, dtype=torch.int32,
                                          device=read.device), u_q)
        j = torch.arange(l_cap, device=read.device)[None, :]
        quals = torch.where(j < l_new[:, None], (q + 33).to(torch.uint8), 0).to(torch.uint8)
    # mutated-length filter (simulator.py:1517-1518)
    valid &= (l_new >= min_len) & (l_new.double() <= max_len)
    zero = torch.zeros(B, dtype=torch.int32, device=slots.device)
    return BatchOut(
        valid=valid, total_len=l_new, head=zero, tail=zero, middle_ref=middle_ref,
        l_new=l_new, chrom=chrom, local_pos=local_pos, is_reversed=is_rev,
        ev_pos2x=walk.events_pos2x, ev_type=walk.events_type, ev_len=walk.events_len,
        ev_valid=walk.events_valid, n_events=walk.n_events,
        capacity_overflow=cap_over, m_ref_init=m_walk, read=read, quals=quals,
    )


def unaligned_plan(profile, genome, *, min_len: int = 50, max_len: float = float("inf"),
                   fastq: bool = True, circular_dna: bool = False) -> dict:
    """The keyword arguments of `unaligned_batch` that the port's unaligned
    simulator derives from the profile and the genome."""
    max_len = min(max_len, genome.max_chrom)
    kde = profile.kde_unaligned
    support = float(np.max(kde.data)) + 6.0 * kde.bandwidth
    l_cap = max(256, int(-(-min(support * 1.4 + 64, float(genome.max_chrom)) // 256) * 256))
    return dict(l_cap=l_cap, e_max=-(-(int(l_cap * 1.25) + 64) // 8) * 8, min_len=min_len,
                max_len=max_len, fastq=fastq, circular_dna=circular_dna)
