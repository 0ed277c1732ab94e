"""The plain reference of `simulate metagenome --chimeric`: the reads that
given slots of a job produce, worked out on the CPU from the benchmark's own
genome list, dna-type list, abundance file and model directory.

What differs from `simulate genome --chimeric` is written here; the rest is
the frozen genome reference (walks, tables, error application, records).

* The community: every species' FASTA sequences in genome-list order, local
  files circular unless the dna-type list says otherwise (simulator.py:284-339).
* The species of a segment come from NanoSim's greedy base-quota packing
  (`assign_species`, simulator.py:758-811), with the port's documented
  departure: a read keeps its (read, segment) length binding, and reads are
  walked in (segment count desc, slot) order.  The packing draws from the
  host generator `SeedSequence([seed, 0xA55])`, batch after batch; a batch's
  quotas hold the reference bases of every read accepted before it, added to
  the species of the chromosome each segment landed on.
* A segment's chromosome is a uniform one of its species; a segment longer
  than it goes to a uniform longer chromosome of the species, else of any
  other species (simulator.py:1704-1747).  Circular chromosomes start
  anywhere in [0, length] and wrap; linear ones in [0, length - segment].
* A gap's species is uniform over the community (simulator.py:1556), and
  the read's length filter counts its gaps (simulator.py:935-946).
* Names are `<species>-<chrom>_<pos>` components joined by ';' with a
  `gap_<length>` component between two segments (simulator.py:966-984).

Because a slot's species depend on every batch before it, a job's packing
is replayed from slot 0 (once per seed, then kept): the phase-A draws (each
segment's count and length), the packing, and which reads the job accepts,
worked out from the reference's own lanes.  The reads that are checked are
then run through the read-emitting program with those species.  A replay
runs on one torch thread (its ops are small: more threads make it slower);
the replays of the jobs to come run in worker processes (`prefetch`) while
the reads of the jobs before them are checked.
"""

from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing
import os
import re
import weakref
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import Optional

import numpy as np
import torch

from . import apply_errors, extract, records, rng, seqops, xla_math
from . import walk as error_walk
from .bundles import (SimTables, build_tables, plan_event_budget, plan_ht_capacity,
                      plan_ref_capacity)
from .chimeric_mode import ChimericBatchOut, _geometric, _part_table
from .fastx import mangle_name, read_fastx
from .genome import PackedGenome
from .genome_mode import _first_valid, _kde_draw, draw_ht
from .oracle import CHUNK_LANES, Lane, _uniform_precision
from .profile import load_profile
from .unaligned_mode import QCLASS_UNMAPPED, unaligned_batch, unaligned_plan

_I32 = torch.int32
BLOCK_BATCHES = 64  # most batches whose walks the replay runs in one call
REPLAY_WORKERS = 8  # most processes that replay jobs at once
PACKING_STREAM = 0xA55  # the host generator of the packing: SeedSequence([seed, 0xA55])


# --- the community ------------------------------------------------------------


@dataclasses.dataclass
class Community:
    """Every species' sequences as one packed genome, grouped by species."""

    genome: PackedGenome
    species: list  # names as the genome list spells them, spaces as '_'
    species_of_chrom: np.ndarray  # [n_chrom] int64
    first_chrom: np.ndarray  # [n_species + 1] int64: species i holds [first[i], first[i + 1])


def _species_name(field: str) -> str:
    return "_".join(field.split())


def read_community(genome_list: str, dna_type_list: Optional[str] = None) -> Community:
    """The genome list (species, FASTA path) and the dna-type list (species,
    sequence, circular|linear); a local FASTA's sequences are circular unless
    the list says otherwise."""
    species, names, seqs, owner = [], [], [], []
    first = [0]
    with open(genome_list) as f:
        rows = [ln.split("\t") for ln in f if ln.strip()]
    for i, row in enumerate(rows):
        species.append(_species_name(row[0]))
        for name, seq, _ in read_fastx(row[1].strip("\n")):
            names.append(mangle_name(name))
            seqs.append(np.frombuffer(seq.upper().encode(), np.uint8))
            owner.append(i)
        first.append(len(names))
    circular = np.ones(len(names), bool)
    if dna_type_list:
        at = {(species[o], n): c for c, (o, n) in enumerate(zip(owner, names))}
        with open(dna_type_list) as f:
            for ln in f:
                if not ln.strip():
                    continue
                sp, chrom, kind = ln.split("\t")[:3]
                chrom = "-".join(re.split(r"[_\s]\s*", chrom.partition(" ")[0])).split(".")[0]
                c = at.get((_species_name(sp), chrom))
                if c is not None:
                    circular[c] = kind.strip("\n") == "circular"
    lengths = np.array([len(s) for s in seqs], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    genome = PackedGenome(flat=np.concatenate(seqs), names=names, lengths=lengths,
                          offsets=offsets, circular=circular)
    return Community(genome, species, np.array(owner, np.int64), np.array(first, np.int64))


def read_abundance(path: str, species) -> tuple:
    """The abundance file's read counts (its header) and each sample's
    percentages in the community's species order."""
    with open(path) as f:
        counts = [int(x) for x in f.readline().strip().split("\t")[1:]]
        pct = {}
        for ln in f:
            if ln.strip():
                fields = ln.split("\t")
                pct[_species_name(fields[0])] = [float(x) for x in fields[1:1 + len(counts)]]
    return counts, [np.array([pct[sp][i] for sp in species], np.float64)
                    for i in range(len(counts))]


def inflated(abun_pct: np.ndarray, inflation: float) -> np.ndarray:
    """The probability that a later segment stays in the previous one's
    species: 1 - (1 - abundance) * inflation (simulator.py:2018-2022)."""
    return 1 - (1 - abun_pct / 100) * inflation


# --- the species-quota packing ------------------------------------------------------


def assign_species(m_ref: np.ndarray, n_seg: np.ndarray, current_bases: np.ndarray,
                   abun: np.ndarray, stay: Optional[np.ndarray], gen, taken=None) -> np.ndarray:
    """Each segment's species, [B, S] int32 (0 past a read's segments).

    A species' quota is its share of every base packed so far and of this
    batch's segment lengths, less the bases it already holds.  A read's
    first segment goes to a uniform species with room for it (else with
    any quota left, else any); a later one stays in the previous segment's
    species with probability `stay` while that species has quota, else goes
    to a uniform other species with room, else as a first segment does.
    `taken` (a dict) counts the branches taken."""
    B, S = m_ref.shape
    n = len(abun)
    everyone = np.arange(n)
    total = int(m_ref.sum()) + int(current_bases.sum())
    left = total * abun / abun.sum() - current_bases
    out = np.zeros((B, S), np.int32)
    taken = {} if taken is None else taken

    def uniform(cands, branch):
        taken[branch] = taken.get(branch, 0) + 1
        return int(cands[int(gen.random() * len(cands))])

    def as_first(ln):
        room = np.nonzero(left - ln > 0)[0]
        if len(room):
            return uniform(room, "room")
        some = np.nonzero(left > 0)[0]
        if len(some):
            return uniform(some, "quota_left")
        return uniform(everyone, "any")

    for b in sorted(range(B), key=lambda r: (-int(n_seg[r]), r)):
        prev = -1
        for s in range(int(n_seg[b])):
            ln = int(m_ref[b, s])
            if s == 0:
                sp = as_first(ln)
            else:
                others = np.nonzero((left - ln > 0) & (everyone != prev))[0]
                p = gen.uniform(0, 100)
                if stay is not None and p <= stay[prev] * 100 and left[prev] > 0:
                    sp = prev
                    taken["stayed"] = taken.get("stayed", 0) + 1
                elif len(others):
                    sp = uniform(others, "other_room")
                else:
                    sp = as_first(ln)
            out[b, s] = sp
            left[sp] -= ln
            prev = sp
    return out


# --- positions ---------------------------------------------------------------------


@dataclasses.dataclass
class CommunityDevice:
    gdev: extract.GenomeDevice
    species_of_chrom: torch.Tensor  # [n_chrom] int64
    first_chrom: torch.Tensor  # [n_species + 1] int64

    @property
    def n_species(self) -> int:
        return self.first_chrom.shape[0] - 1


def metagenome_positions(keys: torch.Tensor, species: torch.Tensor, lengths: torch.Tensor,
                         cd: CommunityDevice, taken=None):
    """(chrom [N] int32, pos [N] int64, ok [N] bool) of N parts of the given
    species and lengths, from three float64 uniforms of the part's SITE_SPECIES
    key: the chromosome, the fallback's pick, the start.  `taken` (a dict)
    counts the parts that outgrew their chromosome and those that went to
    another species'."""
    u = rng.uniform_f64(rng.site_keys(keys, rng.SITE_SPECIES), (3,))
    g = cd.gdev
    sp = species.long()
    ln = lengths.long()
    lo = cd.first_chrom[sp]
    n_own = cd.first_chrom[sp + 1] - lo
    chrom = lo + torch.minimum((u[:, 0] * n_own).long(), n_own - 1)
    fits = ln <= g.lengths[chrom]

    longer = ln[:, None] < g.lengths[None, :]
    own = cd.species_of_chrom[None, :] == sp[:, None]
    cands = torch.where((longer & own).any(dim=1, keepdim=True), longer & own, longer & ~own)
    n_c = cands.sum(dim=1)
    kth = torch.minimum((u[:, 1] * n_c).long(), (n_c - 1).clamp_min(0))
    # the kth candidate in chromosome order (chromosome 0 where there is none)
    pick = (torch.cumsum(cands.long(), dim=1) > kth[:, None]).long().argmax(dim=1)
    chrom = torch.where(fits, chrom, pick)
    ok = fits | (n_c > 0)
    if taken is not None:
        elsewhere = ok & (cd.species_of_chrom[chrom] != sp)
        for branch, n in (("outgrew", ~fits), ("elsewhere", elsewhere)):
            taken[branch] = taken.get(branch, 0) + int(n.sum())

    clen = g.lengths[chrom]
    span = torch.where(g.circular[chrom], clen, clen - ln)
    pos = torch.minimum((u[:, 2] * (span + 1)).long(), span)
    return chrom.to(_I32), pos, ok


# --- the read-emitting program ---------------------------------------------------------


def metagenome_batch(base_key, slots, cd: CommunityDevice, tables: SimTables, species, *,
                     l_cap: int, l_out: int, ht_cap: int, e_max: int, gap_cap: int,
                     gap_steps: int, s_max: int, fastq: bool, min_len: int, max_len: float,
                     segment_mean: float) -> ChimericBatchOut:
    """The chimeric metagenome read of each slot, every (slot, segment) and
    (slot, gap) pair on a lane of its own; species [B, S] int32."""
    genome = cd.gdev
    B = slots.shape[0]
    S = s_max
    dev = slots.device
    sk = rng.slot_keys(base_key, slots)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731

    if segment_mean > 1.0 and S > 1:
        n_seg = _geometric(rng.uniform_per_slot(sk, rng.SITE_SEGMENTS),
                           1.0 / segment_mean).clamp_max(S)
    else:
        n_seg = torch.ones(B, dtype=_I32, device=dev)
    seg_live = torch.arange(S, dtype=_I32, device=dev).repeat_interleave(B) < n_seg.repeat(S)
    sk_seg = torch.cat([rng.part_slot_keys(sk, rng.PART_SEGMENT_BASE, s) for s in range(S)])

    def per_slot(x, n):  # [n*B] part-major -> [B, n]
        return x.reshape(n, B).T

    ref_c = _kde_draw(sk_seg, rng.SITE_REF_LENGTH, tables.kde_aligned, 2)
    ref_f, ref_ok = _first_valid(ref_c, (ref_c > 0) & (ref_c <= f32(max_len)))
    m_ref = torch.where(seg_live, xla_math.f32_to_i32(ref_f).clamp(0, l_cap), 0)
    seg_len_ok = torch.where(seg_live, ref_ok & (ref_f <= f32(l_cap)), True)
    remainder, head, tail, ht_ok = draw_ht(sk, tables, ht_cap)

    walk = error_walk.error_walk(sk_seg, m_ref, tables.first_match, tables.match_markov,
                                 tables.mixtures, tables.trans, e_max)
    seg_lnew = per_slot(torch.where(seg_live, walk.l_new, 0), S)
    walk_ok = per_slot(torch.where(
        seg_live, ~walk.overflow & (walk.middle_ref <= l_cap) & (walk.l_new <= l_cap), True),
        S).all(dim=1)

    if S > 1:
        gap_live = (torch.arange(S - 1, dtype=_I32, device=dev).repeat_interleave(B)
                    < (n_seg - 1).repeat(S - 1))
        sk_gap = torch.cat([rng.part_slot_keys(sk, rng.PART_GAP_BASE, s) for s in range(S - 1)])
        gap_f = _kde_draw(sk_gap, rng.SITE_GAP, tables.kde_gap, 1)[:, 0]
        gap_ref = torch.where(gap_live, gap_f.clamp_min(0).to(_I32), 0).clamp_max(gap_cap)
        gwalk = error_walk.unaligned_walk(sk_gap, gap_ref, tables.mixtures, gap_steps)
        # the gap's species: uniform over the community, one float32 uniform
        # of fold_in(gap key, 1)
        n_sp = cd.n_species
        g_sp = torch.clamp_max((rng.uniform_per_slot(sk_gap, 1) * n_sp).to(_I32), n_sp - 1)
        g_chrom, g_pos, g_pos_ok = metagenome_positions(sk_gap, g_sp, gwalk.middle_ref, cd)
        gap_seg = extract.gather_segments(genome, g_chrom, g_pos, gwalk.middle_ref, gap_cap)
        gu_iupac, gu_mis = rng.uniform2_per_slot(sk_gap, rng.SITE_IUPAC, (gap_cap,))
        gap_seg = seqops.resolve_iupac(gap_seg, gu_iupac)
        ggm, g_under_ins, g_map_ov = apply_errors.build_unaligned_map(
            gwalk.events_pos2x, gwalk.events_type, gwalk.events_len, gwalk.events_valid,
            gwalk.middle_ref, gap_cap)
        gu_ins, _ = rng.uniform2_per_slot(sk_gap, rng.SITE_INS_BASE, (gap_cap,))
        gap_read = apply_errors.materialize_read(ggm.src, ggm.qclass, ggm.valid, gap_seg, gu_mis,
                                                 gu_ins, under_ins=g_under_ins)
        gap_ok = per_slot(torch.where(
            gap_live, ~gwalk.overflow & (gwalk.l_new <= gap_cap) & g_pos_ok & ~g_map_ov, True),
            S - 1).all(dim=1)
        gap_lens = per_slot(torch.where(gap_live, gwalk.l_new, 0), S - 1)
    else:
        gap_ok = torch.ones(B, dtype=torch.bool, device=dev)
        gap_read = torch.zeros((B, gap_cap), dtype=torch.uint8, device=dev)
        gap_lens = torch.zeros((B, 1), dtype=_I32, device=dev)

    total0 = remainder + seg_lnew.sum(dim=1, dtype=_I32) + gap_lens.sum(dim=1, dtype=_I32)
    valid = (ht_ok & walk_ok & gap_ok & per_slot(seg_len_ok, S).all(dim=1)
             & (total0 >= min_len) & (total0.double() <= max_len))

    s_sp = torch.cat([species[:, s] for s in range(S)])
    chrom_f, pos_f, pos_ok = metagenome_positions(sk_seg, s_sp, walk.middle_ref, cd)
    valid &= per_slot(torch.where(seg_live, pos_ok, True), S).all(dim=1)
    is_rev = rng.uniform_per_slot(sk, rng.SITE_STRAND) > tables.strandness_rate

    ref_seg = extract.gather_segments(genome, chrom_f, pos_f, walk.middle_ref, l_cap)
    su_iupac, su_mis = rng.uniform2_per_slot(sk_seg, rng.SITE_IUPAC, (l_cap,))
    ref_seg = seqops.resolve_iupac(ref_seg, su_iupac)
    gm = apply_errors.build_gather_map(walk.events_pos2x, walk.events_type, walk.events_len,
                                       walk.events_valid, walk.middle_ref, l_cap)
    su_ins, _ = rng.uniform2_per_slot(sk_seg, rng.SITE_INS_BASE, (l_cap,))
    seg_read = apply_errors.materialize_read(gm.src, gm.qclass, gm.valid, ref_seg, su_mis, su_ins)
    seg_lnew = per_slot(torch.where(seg_live, gm.read_len, 0), S)

    n_parts = 2 * S + 1
    part_off = _part_table(head, tail, seg_lnew, gap_lens, S)
    total = part_off[:, -1]
    valid &= (total >= min_len) & (total.double() <= max_len) & (total <= l_out)
    j = torch.arange(l_out, dtype=_I32, device=dev)[None, :]
    part = (torch.searchsorted(part_off.contiguous(), j.expand(B, l_out).contiguous(),
                               right=True) - 1).clamp(0, n_parts - 1)
    inner = j - torch.gather(part_off, 1, part)
    is_head, is_tail = part == 0, part == n_parts - 1
    is_seg = (part % 2 == 1) & ~is_tail
    seg_idx = ((part - 1) // 2).clamp(0, S - 1)
    gap_idx = ((part - 2) // 2).clamp(0, S - 2) if S > 1 else torch.zeros_like(part)
    b_col = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    seg_flat = ((seg_idx * B + b_col) * l_cap + inner.clamp(0, l_cap - 1)).clamp(
        0, S * B * l_cap - 1)
    seg_bases = seg_read.reshape(-1)[seg_flat]
    if S > 1:
        gap_flat = ((gap_idx * B + b_col) * gap_cap + inner.clamp(0, gap_cap - 1)).clamp(
            0, gap_read.numel() - 1)
        gap_bases = gap_read.reshape(-1)[gap_flat]
    else:
        gap_bases = seg_bases
    u_ht = rng.uniform_per_slot(sk, rng.SITE_HEAD_TAIL, (ht_cap,))
    ht_idx = torch.where(is_tail, head[:, None] + inner, inner)
    ht_bases = seqops.random_bases(torch.gather(u_ht, 1, ht_idx.clamp(0, ht_cap - 1).long()))
    is_ht = is_head | is_tail
    base = torch.where(is_seg, seg_bases, torch.where(is_ht, ht_bases, gap_bases))
    in_read = j < total[:, None]
    base = torch.where(in_read, base, 0).to(torch.uint8)
    read = torch.where(is_rev[:, None], seqops.reverse_complement(base, total), base)

    quals = torch.zeros((B, l_out), dtype=torch.uint8, device=dev)
    if fastq:
        cls = torch.where(is_seg, gm.qclass.reshape(-1)[seg_flat],
                          torch.where(is_ht, apply_errors.QCLASS_HT, QCLASS_UNMAPPED).to(_I32))
        q = tables.qual.sample(cls, rng.uniform_per_slot(sk, rng.SITE_QUAL, (l_out,)))
        q = torch.where(in_read, q, 0)
        q = torch.where(is_rev[:, None], seqops.reverse_quals(q, total), q)
        quals = torch.where(in_read, (q + 33).to(torch.uint8), 0).to(torch.uint8)

    return ChimericBatchOut(
        read=read, quals=quals, valid=valid, total_len=total, head=head, tail=tail, n_seg=n_seg,
        seg_middle_ref=per_slot(walk.middle_ref, S), seg_l_new=seg_lnew,
        seg_offset=part_off[:, 1:1 + 2 * S:2], gap_len=gap_lens, chrom=per_slot(chrom_f, S),
        local_pos=per_slot(pos_f, S), is_reversed=is_rev, ev_pos2x=walk.events_pos2x,
        ev_type=walk.events_type, ev_len=walk.events_len,
        n_events=per_slot(torch.where(seg_live, walk.n_events, 0), S), seg_read_prehp=seg_read)


def metagenome_plan(profile, community: Community, *, min_len: int = 50,
                    fastq: bool = True, s_max: int = 8) -> dict:
    """The keyword arguments of `metagenome_batch` that the port's
    metagenome simulator derives from the profile and the community: the
    longest read is the longest chromosome."""
    g = community.genome
    max_len = int(g.lengths.max())
    l_cap = plan_ref_capacity(profile, max_len, g.max_chrom)
    ht_cap = plan_ht_capacity(profile)
    gap_support = 10.0 ** (float(np.max(profile.kde_gap.data)) + 6 * profile.kde_gap.bandwidth)
    gap_cap = max(128, int(-(-min(gap_support * 1.4, 1e5) // 128) * 128))
    return dict(l_cap=l_cap, l_out=l_cap * 2 + gap_cap * 2 + ht_cap, ht_cap=ht_cap,
                e_max=plan_event_budget(profile, l_cap, slack=2.5), gap_cap=gap_cap,
                gap_steps=-(-(int(gap_cap * 1.3) + 64) // 8) * 8, s_max=s_max, fastq=fastq,
                min_len=min_len, max_len=max_len, segment_mean=profile.segment_mean)


# --- names ---------------------------------------------------------------------------


def read_name(community: Community, chrom, pos, gaps, idx: int, rev: bool, head: int, mids,
              tail: int) -> str:
    """`<species>-<chrom>_<pos>[;gap_<len>;...]_aligned_<idx>[_chimeric]_<F|R>_<head>_<mids>_<tail>`."""
    g = community.genome
    comps = []
    for s, (c, p) in enumerate(zip(chrom, pos)):
        comps.append(f"{community.species[community.species_of_chrom[c]]}-{g.names[c]}_{p}")
        if s < len(chrom) - 1:
            comps.append(f"gap_{gaps[s]}")
    return (";".join(comps) + f"_aligned_{idx}" + ("_chimeric" if len(chrom) > 1 else "")
            + ("_R" if rev else "_F") + f"_{head}_{';'.join(map(str, mids))}_{tail}")


# --- the replay's walks ------------------------------------------------------------
#
# The replay needs of each walk only its end: the reference span it covered,
# the length it wrote, whether it ran out of steps, and the bases it
# inserted and deleted.  These are the frozen walks' steps (walk.py), with
# no event list, over the lanes still walking (a lane that has finished is
# dropped, as it draws nothing more), and with each table row searched in
# one sorted array of (row, value bits) keys instead of compared whole: for
# non-negative float32 values the bit patterns order as the values do, so
# count(row <= u) and count(row < u) are exact.


def _row_keys(rows: torch.Tensor) -> Optional[torch.Tensor]:
    """[R, K] float32 rows -> [R * K] int64 keys (row << 32 | value bits),
    sorted, or None where a row is not non-decreasing or holds a negative."""
    rows = rows.contiguous()
    if bool((rows < 0).any()) or not bool((rows[:, 1:] >= rows[:, :-1]).all()):
        return None
    bits = rows.view(torch.int32).long()
    return ((torch.arange(rows.shape[0], dtype=torch.int64)[:, None] << 32) | bits).reshape(-1)


class _Samplers:
    """The walks' table draws, exact to tables.py's: an error length
    (`MixtureDevice.sample`), a match length (`EcdfDevice.invert` of
    `select_bin`), each a search of one sorted key array (or tables.py's own
    draw where a row does not allow it)."""

    def __init__(self, t: SimTables):
        self.t = t
        mix = t.mixtures.cdf_t
        self.mix = _row_keys(mix)
        # count(row < u) + 1 = searchsorted(keys, row << 32 | bits(u)) - (row * n - 1)
        self.mix_off = torch.arange(mix.shape[0], dtype=torch.int64) * mix.shape[1] - 1
        mm = t.match_markov
        self.bin_lo = mm.bin_lo.contiguous()
        self.ecdf = (_row_keys(mm.breaks)
                     if bool((self.bin_lo[1:] >= self.bin_lo[:-1]).all()) else None)
        # breaks are padded past a row's end with 2.0, above every uniform,
        # so count(breaks[b] <= u) <= n_bk[b] and invert's upper clamp is idle
        self.ecdf_lo = torch.arange(mm.breaks.shape[0], dtype=torch.int64) * mm.breaks.shape[1]
        self.ecdf_vals = mm.vals.reshape(-1)

    def length(self, etype, u):  # MixtureDevice.sample
        if self.mix is None:
            return self.t.mixtures.sample(etype, u)
        q = (etype.long() << 32) | u.contiguous().view(torch.int32).long()
        return (torch.searchsorted(self.mix, q) - self.mix_off[etype.long()]).to(_I32)

    def match(self, prev_match, u):  # EcdfDevice.invert(select_bin(prev_match), u)
        mm = self.t.match_markov
        if self.ecdf is None:
            return mm.invert(mm.select_bin(prev_match), u).to(_I32)
        b = (torch.searchsorted(self.bin_lo, prev_match, right=True) - 1).clamp_min(0)
        q = (b << 32) | u.contiguous().view(torch.int32).long()
        return self.ecdf_vals[torch.maximum(torch.searchsorted(self.ecdf, q, right=True) - 1,
                                            self.ecdf_lo[b])]


def _walk_ends(n: int, steps, state: dict, step_fn, out: dict) -> dict:
    """Run step_fn over the lanes still walking, UNROLL steps a group, and
    write each lane's state into `out` once it has finished (or at the end)."""
    lane = torch.arange(n)
    for t0, t1 in steps:
        live = state["pos"] < state["middle"]
        if not bool(live.all()):
            done = lane[~live]
            for k in out:
                out[k][done] = state[k][~live].long()
            lane = lane[live]
            state = {k: v[live] for k, v in state.items()}
        if lane.numel() == 0:
            return out
        step_fn(state, torch.arange(t0, t1, dtype=torch.int64))
    for k in out:
        out[k][lane] = state[k].long()
    return out


def aligned_ends(keys, m_ref, t: SimTables, smp: _Samplers, e_max: int) -> dict:
    """The aligned walk's end of each lane: middle (its reference span),
    l_new, pos (< middle where it ran out of steps), dels and ins (bases,
    an insertion overwritten by the next at its key not counted).  A step is
    walk.aligned_step_arith's, its terms folded where an active lane's
    values allow it (pos < middle)."""
    wk = rng.site_keys(keys, rng.SITE_WALK)
    n = m_ref.shape[0]
    pos = error_walk.first_match(wk, t.first_match)
    zero = torch.zeros(n, dtype=_I32)
    state = {"pos": pos, "middle": m_ref.to(_I32).clone(), "l_new": m_ref.to(_I32).clone(),
             "state": zero.clone(), "prev_match": pos.clone(), "dels": zero.clone(),
             "ins": zero.clone(), "last_ins": torch.full((n,), -1, dtype=_I32),
             "last_len": zero.clone(), "wk": wk}
    cum = t.trans.cum

    def step(st, ts):
        U = error_walk.step_uniforms(st["wk"], ts, 3)
        for k in range(ts.shape[0]):
            pos, middle, prev = st["pos"], st["middle"], st["prev_match"]
            active = pos < middle
            etype = (cum[st["state"]] <= U[k, :, 0:1]).sum(dim=-1).clamp_max(2)
            elen = smp.length(etype, U[k, :, 1])
            mstep = smp.match(prev, U[k, :, 2])
            is_ins, is_del = etype == 1, etype == 2
            after = pos + elen.masked_fill(is_ins, 0)
            l_new = (st["l_new"] + elen * (is_ins.to(_I32) - is_del.to(_I32))
                     + (after - middle).clamp_min(0))
            mid = torch.maximum(middle, after)
            mstep = mstep + ((prev == 0) & (mstep == 0)).to(_I32)  # no two zero matches
            end = after + mstep
            l_new = l_new + (end - mid).clamp_min(0)
            mid = torch.maximum(mid, end)
            new_state = (etype + 1).to(_I32) + 3 * (mstep == 0).to(_I32)
            ins = is_ins & active
            again = ins & (pos == st["last_ins"])  # same key as the previous insertion
            st["ins"] = st["ins"] + torch.where(ins, elen, 0) - torch.where(again, st["last_len"], 0)
            st["dels"] = st["dels"] + torch.where(is_del & active, elen, 0)
            st["last_ins"] = torch.where(active, pos.masked_fill(~is_ins, -1), st["last_ins"])
            st["last_len"] = torch.where(ins, elen, st["last_len"])
            st["pos"] = torch.where(active, end, pos)
            st["middle"] = torch.where(active, mid, middle)
            st["l_new"] = torch.where(active, l_new, st["l_new"])
            st["state"] = torch.where(active, new_state, st["state"])
            st["prev_match"] = torch.where(active, mstep, prev)

    steps = [(a, min(a + error_walk.UNROLL, e_max + 1))
             for a in range(1, e_max + 1, error_walk.UNROLL)]
    out = {k: torch.zeros(n, dtype=torch.int64) for k in ("pos", "middle", "l_new", "dels", "ins")}
    return _walk_ends(n, steps, state, step, out)


def unaligned_ends(keys, m_ref, t: SimTables, smp: _Samplers, max_steps: int,
                   chunk: int = 256) -> dict:
    """The unaligned (gap) walk's end of each lane: middle, l_new, pos (<
    middle where it ran out of steps), and ins (the inserted bases).

    A step's kind and length depend on its draws alone, and a lane walks
    until its position, the sum of its steps' advances (an insertion
    advances by nothing), reaches the span it was given; that step's
    overshoot extends the span and the length.  So the walk is a prefix
    sum over `chunk` steps at a time."""
    wk = rng.site_keys(keys, rng.SITE_UNALIGNED_WALK)
    n = m_ref.shape[0]
    m = m_ref.long()
    pos = torch.zeros(n, dtype=torch.int64)
    ins = torch.zeros(n, dtype=torch.int64)
    dels = torch.zeros(n, dtype=torch.int64)
    th = [torch.tensor(v, dtype=torch.float32) for v in (0.4, 0.7, 0.85)]
    lane = torch.arange(n)
    for c0 in range(0, max_steps, chunk):
        lane = lane[pos[lane] < m[lane]]
        if lane.numel() == 0:
            break
        ts = torch.arange(c0, min(c0 + chunk, max_steps), dtype=torch.int64)
        U = error_walk.step_uniforms(wk[lane], ts, 2)  # [T, L, 2]
        kind = sum((U[..., 0] >= c).to(_I32) for c in th)  # 0=match 1=mis 2=ins 3=del
        etype = (kind - 1).clamp(0, 2)
        elen = smp.length(etype.reshape(-1), U[..., 1].reshape(-1)).reshape(kind.shape).long()
        elen = torch.where(kind > 0, elen, 1)
        cum = pos[lane][None, :] + torch.cumsum(torch.where(kind == 2, 0, elen), dim=0)
        cross = cum >= m[lane][None, :]
        crossed = cross.any(dim=0)
        first = cross.to(torch.uint8).argmax(dim=0)
        taken = torch.where(crossed, first + 1, ts.shape[0])
        stepped = torch.arange(ts.shape[0])[:, None] < taken[None, :]
        ins[lane] += torch.where(stepped & (kind == 2), elen, 0).sum(dim=0)
        dels[lane] += torch.where(stepped & (kind == 3), elen, 0).sum(dim=0)
        pos[lane] = torch.where(crossed, cum.gather(0, first[None, :])[0], cum[-1])
    over = (pos - m).clamp_min(0)
    return {"pos": pos, "middle": m + over, "l_new": m + ins - dels + over, "ins": ins}


# --- the job replay -----------------------------------------------------------------


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


_WORKER = None  # a replay worker's own reference


def _worker_init(args, kwargs):
    global _WORKER
    _WORKER = MetagenomeReference(*args, **kwargs)


def _worker_replay(seed: int, n_batches: int) -> "_Job":
    return _WORKER.job(seed, n_batches)


class _Job:
    """One job's packing, batch after batch from slot 0: each batch's species
    and which of its reads are valid, and the bases each species holds."""

    def __init__(self, seed: int, n_species: int):
        self.seed = seed
        self.gen = np.random.default_rng(np.random.SeedSequence([seed, PACKING_STREAM]))
        self.bases = np.zeros(n_species, np.float64)
        self.species = []  # [B, S] int32 a batch
        self.valid = []  # [B] bool a batch
        self.taken = {}  # the packing's branches, and the segments that outgrew
        # their chromosome or went to another species' (metagenome_positions)


class MetagenomeReference:
    """The reference of the metagenome configuration and its traffic mix:
    `aligned` and `unaligned` give the lanes of a job's slots."""

    def __init__(self, genome_list: str, dna_type_list: str, abundance: str, model_prefix: str,
                 *, batch: int, fastq: bool = True, min_len: int = 50,
                 uniforms: str = "float32"):
        torch.set_num_threads(min(torch.get_num_threads(), 8))
        self.community = read_community(genome_list, dna_type_list)
        c = self.community
        _, samples = read_abundance(abundance, c.species)
        self.abun = samples[0]
        self.profile = load_profile(model_prefix, mode="genome", fastq=fastq, chimeric=True)
        self.stay = inflated(self.abun, self.profile.abun_inflation)
        self.tables = build_tables(self.profile, "cpu")
        self.samplers = _Samplers(self.tables)
        self.cd = CommunityDevice(extract.GenomeDevice.from_packed(c.genome, "cpu"),
                                  torch.as_tensor(c.species_of_chrom),
                                  torch.as_tensor(c.first_chrom))
        self.kw = metagenome_plan(self.profile, c, min_len=min_len, fastq=fastq)
        self.unaligned_kw = unaligned_plan(self.profile, c.genome, min_len=min_len, fastq=fastq)
        self.batch = batch
        self.fastq = fastq
        self.uniforms = uniforms
        self.jobs = {}
        self._spec = ((genome_list, dna_type_list, abundance, model_prefix),
                      dict(batch=batch, fastq=fastq, min_len=min_len, uniforms=uniforms))
        self._pool = None
        self._pending = {}  # seed -> the future of its replay in a worker

    # the replay ------------------------------------------------------------------

    def job(self, seed: int, n_batches: int) -> _Job:
        """The job of `seed`, replayed through at least n_batches batches."""
        self._collect(seed)
        job = self.jobs.get(seed)
        if job is None:
            job = self.jobs[seed] = _Job(seed, len(self.community.species))
        with torch.no_grad(), _uniform_precision(self.uniforms), _one_thread():
            while len(job.species) < n_batches:
                have = len(job.species)
                self._replay_block(job, have, min(n_batches - have, BLOCK_BATCHES))
        return job

    def prefetch(self, jobs):
        """Replay the jobs [(seed, batches)] in worker processes, one torch
        thread each, as many at once as there are cores but one (at most
        REPLAY_WORKERS); `job` takes a replay from there when it is asked
        for.  Fewer than two jobs are replayed where they are asked for."""
        jobs = [(int(s), int(n)) for s, n in jobs if n > 0 and s not in self.jobs]
        workers = min(len(jobs), REPLAY_WORKERS, len(os.sched_getaffinity(0)) - 1)
        if workers < 2:
            return
        self._pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                                         initializer=_worker_init, initargs=self._spec)
        # a reference dropped before it took every replay cancels the rest
        weakref.finalize(self, self._pool.shutdown, wait=False, cancel_futures=True)
        for s, n in jobs:
            self._pending[s] = self._pool.submit(_worker_replay, s, n)

    def _collect(self, seed: int):
        """The worker's replay of `seed`, if one was asked for; the pool is
        shut down once every replay has been taken.  A worker that died
        leaves the replay to this process."""
        fut = self._pending.pop(seed, None)
        if fut is not None:
            try:
                self.jobs[seed] = fut.result()
            except BrokenProcessPool:
                pass
        if self._pool is not None and not self._pending:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def _replay_block(self, job: _Job, b0: int, nb: int):
        """Batches b0..b0+nb-1: the species-free draws of every slot at once
        (a step of a walk costs about the same for one batch as for forty),
        then batch by batch the packing, the segments' chromosomes, which
        reads are valid, and the accepted reads' bases added to the quotas."""
        kw, t, B, S = self.kw, self.tables, self.batch, self.kw["s_max"]
        N = nb * B
        slots = torch.arange(b0 * B, b0 * B + N, dtype=torch.int64)
        sk = rng.slot_keys(rng.base_key(job.seed, rng.STREAM_ALIGNED), slots)
        u_seg = rng.uniform_per_slot(sk, rng.SITE_SEGMENTS)
        chimeric = kw["segment_mean"] > 1.0 and S > 1
        n_dev = (_geometric(u_seg, 1.0 / kw["segment_mean"]).clamp_max(S) if chimeric
                 else torch.ones(N, dtype=_I32))

        # phase A: the host's segment counts in float64
        if chimeric:
            u = u_seg.numpy()
            n_a = np.minimum(np.ceil(np.log1p(-u) / np.log1p(-1.0 / kw["segment_mean"])),
                             S).astype(np.int32)
        else:
            n_a = np.ones(N, np.int32)

        # the length draw of every (slot, segment) that phase A or the program
        # counts, as phase A draws them
        row = torch.arange(N).repeat_interleave(S)
        seg = torch.arange(S).repeat(N)
        drawn = seg < torch.maximum(n_dev, torch.as_tensor(n_a))[row]
        keys = rng.part_slot_keys(sk[row[drawn]], rng.PART_SEGMENT_BASE, seg[drawn])
        ref_c = _kde_draw(keys, rng.SITE_REF_LENGTH, t.kde_aligned, 2)
        mx = torch.tensor(kw["max_len"], dtype=torch.float32)
        ref_f, ref_ok = _first_valid(ref_c, (ref_c > 0) & (ref_c <= mx))
        m_all = torch.zeros(N * S, dtype=_I32)
        m_all[drawn] = xla_math.f32_to_i32(ref_f).clamp(0, kw["l_cap"])
        m_a = m_all.reshape(N, S).numpy()
        m_a = np.where(np.arange(S)[None, :] < n_a[:, None], m_a, 0)
        row, seg = row[drawn], seg[drawn]

        # the active segments' walks (species play no part in them)
        act = seg < n_dev[row]
        a_row, a_key, a_m = row[act], keys[act], m_all[drawn][act]
        w = aligned_ends(a_key, a_m, t, self.samplers, kw["e_max"])
        seg_ok = (ref_ok[act] & (ref_f[act] <= kw["l_cap"]) & (w["pos"] >= w["middle"])
                  & (w["middle"] <= kw["l_cap"]) & (w["l_new"] <= kw["l_cap"]))

        def per_row(x):
            return torch.zeros(N, dtype=torch.int64).index_add_(0, a_row, x.long())

        def bad_rows(ok, rows):
            return torch.zeros(N, dtype=torch.int64).index_add_(0, rows, (~ok).long()) > 0

        lnew_walk = per_row(w["l_new"])
        lnew = per_row(w["middle"] - w["dels"] + w["ins"])
        bad = bad_rows(seg_ok, a_row)

        # the gaps: lengths, walks and positions (a gap's species is a draw)
        gaps = torch.zeros(N, dtype=torch.int64)
        if chimeric:
            g_row = torch.arange(N).repeat_interleave(S - 1)
            g_idx = torch.arange(S - 1).repeat(N)
            g_act = g_idx < (n_dev[g_row] - 1)
            g_row, g_idx = g_row[g_act], g_idx[g_act]
            g_key = rng.part_slot_keys(sk[g_row], rng.PART_GAP_BASE, g_idx)
            g_ref = _kde_draw(g_key, rng.SITE_GAP, t.kde_gap, 1)[:, 0]
            g_ref = g_ref.clamp_min(0).to(_I32).clamp_max(kw["gap_cap"])
            gw = unaligned_ends(g_key, g_ref, t, self.samplers, kw["gap_steps"])
            n_sp = self.cd.n_species
            g_sp = torch.clamp_max((rng.uniform_per_slot(g_key, 1) * n_sp).to(_I32), n_sp - 1)
            _, _, g_pos_ok = metagenome_positions(g_key, g_sp, gw["middle"], self.cd)
            g_ok = ((gw["pos"] >= gw["middle"]) & (gw["l_new"] <= kw["gap_cap"]) & g_pos_ok
                    & (gw["middle"] + gw["ins"] <= apply_errors.presentation_cap(kw["gap_cap"])))
            gaps = torch.zeros(N, dtype=torch.int64).index_add_(0, g_row, gw["l_new"])
            bad |= bad_rows(g_ok, g_row)

        remainder, head, tail, ht_ok = draw_ht(sk, t, kw["ht_cap"])
        total0 = remainder.long() + lnew_walk + gaps
        total = head.long() + tail.long() + lnew + gaps
        lo, hi = kw["min_len"], kw["max_len"]
        valid_pre = (ht_ok & ~bad & (total0 >= lo) & (total0 <= hi) & (total >= lo)
                     & (total <= hi) & (total <= kw["l_out"]))

        # batch by batch: the packing, the segments' chromosomes, the quotas
        mid = w["middle"]
        for k in range(nb):
            rows = slice(k * B, (k + 1) * B)
            species = assign_species(m_a[rows], n_a[rows], job.bases, self.abun, self.stay,
                                     job.gen, job.taken)
            mine = (a_row >= k * B) & (a_row < (k + 1) * B)
            r = a_row[mine]
            sp = torch.as_tensor(species)[r - k * B, seg[act][mine]]
            chrom, _, pos_ok = metagenome_positions(a_key[mine], sp, mid[mine], self.cd,
                                                    job.taken)
            valid = valid_pre[rows] & ~bad_rows(pos_ok, r)[rows]
            keep = valid[r - k * B]
            np.add.at(job.bases, self.community.species_of_chrom[chrom[keep].numpy()],
                      mid[mine][keep].numpy())
            job.species.append(species)
            job.valid.append(valid.numpy())

    # the lanes ---------------------------------------------------------------------

    def species_of(self, seed: int, slots) -> np.ndarray:
        """[len(slots), S] species of the job's slots."""
        return self._of(seed, slots, "species")

    def valid_of(self, seed: int, slots) -> np.ndarray:
        """[len(slots)] whether the job's slots hold a read, by the replay."""
        return self._of(seed, slots, "valid")

    def _of(self, seed: int, slots, field: str) -> np.ndarray:
        slots = np.asarray(slots, np.int64)
        if not len(slots):
            return np.zeros((0, self.kw["s_max"]) if field == "species" else 0,
                            np.int32 if field == "species" else bool)
        job = self.job(seed, int(slots.max()) // self.batch + 1)
        rows = getattr(job, field)
        return np.stack([rows[s // self.batch][s % self.batch] for s in slots])

    def aligned(self, seed: int, slots) -> list:
        """The aligned pass's lanes at these slots of the job of `seed`: the
        replay says which hold a read, and those run through the
        read-emitting program (whose own verdict the lane keeps)."""
        slots = np.asarray(slots, np.int64)
        species = self.species_of(seed, slots)
        live = np.nonzero(self.valid_of(seed, slots))[0]
        base = rng.base_key(seed, rng.STREAM_ALIGNED)
        lanes = [Lane(False, None) for _ in slots]
        with torch.no_grad(), _uniform_precision(self.uniforms):
            for i in range(0, len(live), CHUNK_LANES):
                at = live[i:i + CHUNK_LANES]
                out = metagenome_batch(base, torch.as_tensor(slots[at]), self.cd, self.tables,
                                       torch.as_tensor(species[at]), **self.kw)
                o = {k: v.numpy() for k, v in out._asdict().items()}
                for j, lane in enumerate(at):
                    if o["valid"][j]:
                        lanes[lane] = Lane(True, self._render(o, j))
        return lanes

    def _render(self, o: dict, i: int):
        g = self.community.genome
        B = len(o["valid"])
        ns = int(o["n_seg"][i])
        chrom = [int(c) for c in o["chrom"][i, :ns]]
        pos = [int(p) for p in o["local_pos"][i, :ns]]
        mids = [int(m) for m in o["seg_middle_ref"][i, :ns]]
        gaps = [int(x) for x in o["gap_len"][i, :max(ns - 1, 0)]]
        rev = bool(o["is_reversed"][i])
        head, tail, total = int(o["head"][i]), int(o["tail"][i]), int(o["total_len"][i])
        read = o["read"][i, :total].copy()
        quals = o["quals"][i, :total].copy() if self.fastq else None
        segs = []
        for s in range(ns):
            row, n = s * B + i, int(o["n_events"][i, s])
            segs.append((o["ev_pos2x"][row, :n].copy(), o["ev_type"][row, :n].copy(),
                         o["ev_len"][row, :n].copy(), o["seg_read_prehp"][row].copy()))

        def render(idx: int):
            name = read_name(self.community, chrom, pos, gaps, idx, rev, head, mids, tail)
            rec = records.fastx_record(name, read, quals, self.fastq)
            log = b"".join(records.log_rows(name, *segs[s][:3], segs[s][3], g, chrom[s], pos[s])
                           for s in range(ns))
            return rec, log

        return render

    def unaligned(self, seed: int, slots) -> list:
        """The unaligned pass's lanes at these slots: reads of the whole
        community taken as linear sequences, named by sequence."""
        g = self.community.genome
        base = rng.base_key(seed, rng.STREAM_UNALIGNED)
        slots = np.asarray(slots, np.int64)
        lanes = []
        with torch.no_grad(), _uniform_precision(self.uniforms):
            for i in range(0, len(slots), CHUNK_LANES):
                out = unaligned_batch(base, torch.as_tensor(slots[i:i + CHUNK_LANES]),
                                      self.cd.gdev, self.tables, **self.unaligned_kw)
                o = {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in out._asdict().items()}
                ok = o["valid"] & ~o["capacity_overflow"]
                for j in range(len(ok)):
                    if not ok[j]:
                        lanes.append(Lane(False, None))
                        continue
                    chrom, pos, rev = int(o["chrom"][j]), int(o["local_pos"][j]), \
                        bool(o["is_reversed"][j])
                    mid, l_new = int(o["middle_ref"][j]), int(o["l_new"][j])
                    read = o["read"][j, :l_new].copy()
                    quals = o["quals"][j, :l_new].copy() if self.fastq else None

                    def render(idx, chrom=chrom, pos=pos, rev=rev, mid=mid, read=read,
                               quals=quals):
                        name = records.unaligned_name(g.names[chrom], pos, idx, rev, mid)
                        return records.fastx_record(name, read, quals, self.fastq), None

                    lanes.append(Lane(True, render))
        return lanes
