"""Genome-mode simulation: the batched device step + host driver.

The reference's per-read rejection loop (`simulation_aligned_genome`,
simulator.py:1266-1454) becomes a fixed-shape batch pipeline.  On the device:

  slot ids -> per-slot RNG -> KDE length draws -> error walk (CUDA kernel) ->
  position sampling + boundary rejection -> acceptance

then, in the read-emitting program only:

  reference gather -> IUPAC resolve -> fused mutation + head/tail + strand
  flip (packed-code gather: CUDA kernel) -> qualities

or, in homopolymer mode (kmer_bias set), the unfused read-emitting program:

  per-byte reference gather -> IUPAC resolve -> suppression of errors in
  >= k runs -> gather map + materialization (byte gather: CUDA kernel) ->
  run resizing (16-bit gather: same kernel) -> head | middle | tail assembly
  with the strand flip (CUDA kernel) -> qualities

On the default route the device runs the meta-only program: about 100 bytes
per lane go to the host, where the C++ emitter replays each lane's walk,
checks it against the device checksum and reconstructs the read bytes
(sim/reconstruct.py is the spec).  Circular DNA and NANOSIM_TPU_RECON=0 run
the read-emitting program and transfer the reads.  Rejected lanes (length
filters, boundary rejection, capacity overflow) are simply invalid slots; the
host driver keeps consuming fresh slot ranges until the read quota is met.
Sequence numbering is by accepted-slot order, which makes output independent
of batch scheduling.
"""

from __future__ import annotations

import functools
import math
import os
import types
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import tracing
from ..ops import apply_errors, assemble_cuda, error_walk, homopolymer, rng, seqops, xla_math
from ..profiles.profile import ReadProfile
from . import extract
from .bundles import (FULL_EVENT_SLACK, SimTables, build_tables, estimate_mean_aligned,
                      estimate_mean_match, plan_event_budget, plan_ht_capacity,
                      plan_ref_capacity)
from .route import want_recon


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


def device_of(device) -> torch.device:
    """The simulators' device, refusing a CUDA request without a card (there
    is no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was requested but no CUDA card is available")
    return dev


def check_circular(genome, circular_dna: bool) -> None:
    """Refuse circular_dna=True on a genome loaded as linear: the wrap keys off
    the per-chromosome flags at gather time, so such a genome would silently
    clamp at the 3' end."""
    if circular_dna and not bool(np.all(genome.circular)):
        raise ValueError(
            "circular_dna=True but the genome was loaded as linear; "
            'load it with PackedGenome.from_fasta(path, dna_type="circular")'
        )


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


def lognormal_len(sk, median_len: float, sd_len: float, perfect: bool) -> torch.Tensor:
    """The `-med/-sd` length draw (simulator.py:1284-1296), [B] float32 with
    the JAX package's bits: ``jnp.exp(z * sd_len + jnp.log(c))``, z =
    rng.normal_per_slot(sk, SITE_LOGNORMAL_LEN), c = median_len for perfect
    reads and the unaligned pass, median_len + sd_len**2 / 2 otherwise.

    As XLA compiles that expression on the CPU: the log is taken in float64
    (x64 is on) and rounded to a float32 constant; z is sqrt(2) * erfinv(u),
    and XLA's simplifier folds the two constant factors into one,
    ``erfinv(u) * float32(sqrt(2) * sd_len)``; that multiply and the add are
    one fused multiply-add; the exp is XLA's (xla_math.exp_f32)."""
    c = median_len if perfect else median_len + sd_len**2 / 2.0
    e = rng.erfinv_normal_per_slot(sk, rng.SITE_LOGNORMAL_LEN)
    scale = np.float32(np.float32(math.sqrt(2.0)) * np.float32(sd_len))
    shift = torch.tensor(math.log(c), dtype=torch.float32, device=e.device)
    return xla_math.exp_f32(xla_math.fma32(e, torch.tensor(scale, device=e.device), shift))


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
    out = assemble_cuda.assemble_rolls(packed_mid, packed_ht, head, l_new, total, is_rev, l_out)
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
    emit_reads: bool = True,
    kmer_bias: Optional[int] = None,
    hp_r_max: int = 256,
    perfect: bool = False,
    median_len: Optional[float] = None,
    sd_len: Optional[float] = None,
) -> BatchOut:
    """The aligned-read batch program (KDE lengths, or with median_len the
    lognormal `-med/-sd` lengths): the read-emitting program, or with
    emit_reads=False the meta-only one.

    Both accept the same lanes: the meta-only program's final length
    filters run on the DEDUP-aware l_new that the read materialization
    produces.

    kmer_bias (homopolymer mode, `-hp -k`): the read-emitting program leaves
    the fused path for suppression -> gather map -> materialization -> run
    resizing (at most hp_r_max runs per lane) -> assembly; the meta-only
    program is unchanged but for the final length filter, which homopolymer
    mode does not apply.

    perfect (`--perfect`): the length draw is the whole read's (the profile's
    aligned-reads KDE), no head or tail, no walk: zero events, so the read is
    the extracted reference, strand-flipped.  Its read-emitting program is
    the fused read's (K3), with `-hp` the per-byte extraction and the
    assembly (K5); no run is resized.
    """
    sk = rng.slot_keys(base_key, slots)
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=slots.device)

    # --- aligned-region length (simulator.py:1284-1296) ---
    lognormal = median_len is not None
    if lognormal:
        ref_len_f = lognormal_len(sk, median_len, sd_len, perfect)
    else:
        ref_len_f = _kde_draw(sk, rng.SITE_REF_LENGTH, tables.kde_aligned, 1)[:, 0]
    if perfect:
        valid = (ref_len_f >= f32(min_len)) & (ref_len_f <= f32(max_len))
        m_ref = xla_math.f32_to_i32(ref_len_f).clamp(0, l_cap)
        middle_ref = l_new = m_ref
        zero = torch.zeros_like(m_ref)
        head = tail = zero
        ev = torch.zeros((slots.shape[0], 1), dtype=torch.int32, device=slots.device)
        # the program's view of a walk that took no step
        walk = types.SimpleNamespace(events_pos2x=ev, events_type=ev, events_len=ev,
                                     events_valid=ev.bool(), n_events=zero)
        cap_over = ref_len_f > f32(l_cap)
        valid &= ~cap_over
    else:
        remainder, head, tail, ht_ok = draw_ht(sk, tables, ht_cap)
        if lognormal:
            ref_len_f = ref_len_f - remainder  # the lognormal draw is the total
        valid = (ht_ok & (ref_len_f > 0) & (ref_len_f <= f32(max_len))
                 & (ref_len_f <= f32(l_cap)))
        m_ref = xla_math.f32_to_i32(ref_len_f).clamp(0, l_cap)

        walk = error_walk.error_walk(
            sk, m_ref, tables.first_match, tables.match_markov, tables.mixtures, tables.trans,
            e_max)
        middle_ref, l_new = walk.middle_ref, walk.l_new
        # ht_cap is bucket-independent, so remainder > ht_cap stays a plain
        # rejection (inside ht_ok)
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

    read = quals = read_prehp = None
    ev_len = walk.events_len
    if not emit_reads:
        eff = apply_errors.effective_lens(walk.events_pos2x, walk.events_type,
                                          walk.events_len, walk.events_valid)
        zero = torch.zeros_like(eff)
        dsum = torch.where(walk.events_valid & (walk.events_type == 2), eff, zero).sum(dim=1)
        isum = torch.where(walk.events_valid & (walk.events_type == 1), eff, zero).sum(dim=1)
        l_new = (middle_ref - dsum + isum).to(torch.int32)
        total = head + l_new + tail
        # -hp: suppression and resizing happen host-side on the
        # reconstruction route
    elif kmer_bias is not None and perfect:
        # -hp --perfect: the perfect middle is the extraction itself (no
        # suppression, no resizing), assembled like the -hp read
        ref_seg = extract.gather_segments(genome, chrom, local_pos, middle_ref, l_cap)
        u_iupac, _ = rng.uniform2_per_slot(sk, rng.SITE_IUPAC, (l_cap,))
        ref_seg = seqops.resolve_iupac(ref_seg, u_iupac)
        read_prehp = ref_seg
        read, quals, total, _ = assemble_read(
            ref_seg, torch.zeros_like(ref_seg, dtype=torch.int32), l_new, head, tail, sk,
            tables, l_out, ht_cap, fastq)
    elif kmer_bias is not None:
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


class OverflowRescueWriter:
    """Writer shim: lanes whose walk overflowed the lean event budget
    (capacity_overflow) are re-run at the full budget through the run's own
    program (meta-only, or read-emitting when its fetcher moves the reads)
    and spliced back IN SLOT ORDER before emission, so the lean budget is
    invisible in the output.  On the host-reconstruction route the rescued
    lanes are reconstructed like every other lane (the recon design makes
    that the same bytes the read-emitting program would give).  In homopolymer mode the
    rescue always materializes on the device (its fetcher moves the reads on
    both routes): that program's run table cannot overflow.
    """

    RESCUE_BATCH = 64

    def __init__(self, sim, writer, base_key, make_fetcher):
        self.sim = sim
        self.inner = writer
        self.base = base_key
        self.make_fetcher = make_fetcher  # () -> fresh fetcher for rescue runs
        self._fn = None
        self._fetcher = None

    def _rescue(self, slots):
        """Run overflow slots through the full-budget program.

        Returns {slot: (fetched, lane)} for slots that produced valid reads.
        """
        sim = self.sim
        if self._fn is None:
            self._fetcher = self.make_fetcher()
            self._fn = sim.batch_fn(full_events=True, emit_reads=self._fetcher.with_reads)
        out = {}
        B = self.RESCUE_BATCH
        for i in range(0, len(slots), B):
            ch = np.asarray(slots[i : i + B], np.int64)
            n_real = len(ch)
            if n_real < B:
                ch = np.concatenate([ch, np.full(B - n_real, ch[-1], np.int64)])
            with tracing.span("dispatch.program"):
                batch_out = self._fn(self.base, torch.as_tensor(ch, device=sim.device))
            h = self._fetcher.dispatch(batch_out)
            h.slots = ch
            d = h.fetch()
            valid = np.asarray(d["valid"])
            for lane in range(n_real):
                if valid[lane]:
                    out[int(ch[lane])] = (d, lane)
        return out

    def write_batch(self, sim, handle, accepted_so_far: int, quota: int) -> int:
        d = handle.fetch()
        cap = np.asarray(d["cap_over"])
        valid = np.asarray(d["valid"])
        if not cap.any():
            lanes = np.nonzero(valid)[0][: quota - accepted_so_far]
            return self.inner.write_run(sim, d, lanes, accepted_so_far)

        slots = handle.slots
        from .output import RUN_STATS

        RUN_STATS.overflow_rescue_lanes += int(cap.sum())
        rescued = self._rescue(slots[cap])
        # interleave in slot order: runs of primary lanes + rescued singletons
        n = 0
        run_lanes = []
        for lane in range(len(slots)):
            if accepted_so_far + n + len(run_lanes) >= quota:
                break
            if valid[lane]:
                run_lanes.append(lane)
            elif cap[lane]:
                r = rescued.get(int(slots[lane]))
                if r is None:
                    continue
                if run_lanes:
                    n += self.inner.write_run(
                        sim, d, np.asarray(run_lanes, np.int64), accepted_so_far + n
                    )
                    run_lanes = []
                d2, lane2 = r
                n += self.inner.write_run(
                    sim, d2, np.asarray([lane2], np.int64), accepted_so_far + n
                )
        if run_lanes:
            run_lanes = run_lanes[: quota - accepted_so_far - n]
            n += self.inner.write_run(
                sim, d, np.asarray(run_lanes, np.int64), accepted_so_far + n
            )
        return n


def run_prefetched(make_batch, batch_size: int, quota: int, writer, sim,
                   max_batches=None, state=None, depth: int = 4) -> int:
    """Pipelined accept loop: up to `depth` batches are dispatched (CUDA
    work is asynchronous) ahead of the host consumer, so the device computes
    the next batches while the host formats and writes earlier ones.

    `state` (optional ResumeState): loads (slot cursor, accepted count) on
    entry and checkpoints them after every emitted batch, enabling a
    kill-and-restart to reproduce the exact remaining output (slot-keyed
    draws make the mapping deterministic).  The checkpointed cursor is the
    first UNCONSUMED batch's slot start — in-flight dispatches beyond it are
    recomputed on resume.

    Each batch's dispatch (`make_batch`) and emission (`writer.write_batch`,
    the fetch inside it included) are the spans `dispatch` and `emit`, both
    carrying the batch's first slot (tracing.py).
    """
    from collections import deque

    from .output import report_progress

    accepted = state.accepted if state else 0
    slot_start = state.slot_start if state else 0
    dispatched = 0
    q = deque()
    while accepted < quota:
        while len(q) < depth and (max_batches is None or dispatched < max_batches):
            with tracing.span("dispatch", slot_start):
                q.append((slot_start, make_batch(slot_start)))
                tracing.count("batches.dispatched")
            slot_start += batch_size
            dispatched += 1
        if not q:
            break
        first, pending = q.popleft()
        prev = accepted
        with tracing.span("emit", first):
            accepted += writer.write_batch(sim, pending, accepted, quota)
        report_progress(prev, accepted)
        if state is not None:
            state.checkpoint(slot_start - batch_size * len(q), accepted)
    return accepted


class ResumeState:
    """Batch-granular (slot cursor, accepted count) checkpointing.

    The state on disk never runs AHEAD of the output files: the writers emit
    synchronously, and the state is written right after the batch's
    emission.
    """

    def __init__(self, path: str):
        self.path = path
        self.slot_start = 0
        self.accepted = 0
        if os.path.exists(path):
            import json

            with open(path) as f:
                d = json.load(f)
            self.slot_start = int(d["slot_start"])
            self.accepted = int(d["accepted"])

    def checkpoint(self, slot_start: int, accepted: int):
        import json

        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"slot_start": slot_start, "accepted": accepted}, f)
        os.replace(tmp, self.path)


class GenomeSimulator:
    """Host driver: batches, slot accounting, acceptance, output.

    Covers KDE lengths, or with median_len and sd_len the lognormal
    `-med/-sd` lengths, with FASTA or FASTQ and the error profile: linear DNA
    on the host-reconstruction route, and the read-emitting program for
    circular DNA (a single chromosome) and for NANOSIM_TPU_RECON=0; with
    kmer_bias (homopolymer mode, `-hp -k`) and with perfect (`--perfect`,
    also with `-hp`) on both routes.  The port runs one length bucket: the
    JAX package's opt-in bucketed schedule writes the same files as its flat
    one, and a port of it ran 5x slower on an H100 with 3x the device
    memory (PERF.md, Findings), so the port runs the flat schedule only."""

    def __init__(
        self,
        genome,
        profile: ReadProfile,
        *,
        fastq: bool = False,
        circular_dna: bool = False,
        min_len: int = 50,
        max_len: float = float("inf"),
        batch: int = 256,
        kmer_bias: Optional[int] = None,
        perfect: bool = False,
        median_len: Optional[float] = None,
        sd_len: Optional[float] = None,
        device="cuda",
    ):
        if fastq and profile.base_quals is None:
            raise ValueError("fastq=True needs a profile loaded with fastq=True")
        if kmer_bias is not None and not perfect and profile.hp_params is None:
            raise ValueError("kmer_bias needs a profile loaded with homopolymer=True")
        check_circular(genome, circular_dna)
        self.device = device_of(device)
        self.genome_host = genome
        self.profile = profile
        max_len = min(max_len, genome.max_chrom)
        self.max_len = max_len
        self.min_len = min_len
        self.fastq = fastq
        self.circular_dna = circular_dna
        self.batch = batch
        self.kmer_bias = kmer_bias
        self.perfect = perfect
        self.median_len = median_len
        self.sd_len = sd_len

        self.l_cap = plan_ref_capacity(profile, max_len, genome.max_chrom)
        self.ht_cap = plan_ht_capacity(profile)
        self.l_out = -(-(self.l_cap + self.ht_cap) // 1024) * 1024
        self.e_max = plan_event_budget(profile, self.l_cap)
        # homopolymer mode: run-table capacity of the primary program (lanes
        # holding more runs of length >= k are re-run by the rescue)
        self.hp_r_max = max(128, self.l_cap // 32)

        self.tables = build_tables(profile, self.device)
        self.genome_dev = extract.GenomeDevice.from_packed(genome, self.device)

    def batch_fn(self, full_events: bool = False, emit_reads: bool = True):
        """The batch program: read-emitting, or meta-only (host
        reconstruction) with emit_reads=False; full_events=True is the
        rescue-grade program: the full event budget and, in homopolymer mode,
        a run table that cannot overflow (a length-l_cap read holds at most
        l_cap // k runs of length >= k)."""
        e_max = (plan_event_budget(self.profile, self.l_cap, slack=FULL_EVENT_SLACK)
                 if full_events else self.e_max)
        if full_events and self.kmer_bias is not None:
            hp_r_max = self.l_cap // max(self.kmer_bias, 1) + 1
        else:
            hp_r_max = self.hp_r_max
        return functools.partial(
            genome_batch, genome=self.genome_dev, tables=self.tables,
            l_cap=self.l_cap, l_out=self.l_out, ht_cap=self.ht_cap, e_max=e_max,
            min_len=self.min_len, max_len=self.max_len, fastq=self.fastq,
            circular_dna=self.circular_dna, emit_reads=emit_reads,
            kmer_bias=self.kmer_bias, hp_r_max=hp_r_max, perfect=self.perfect,
            median_len=self.median_len, sd_len=self.sd_len,
        )

    def _fetchers(self, seed: int):
        """(make_primary, make_rescue): the makers of a run's batch fetcher
        and of its overflow rescue's fetcher, on the run's route."""
        from ..io.native import PerfectReplayer, WalkReplayer
        from .output import CompactFetcher

        hp = self.kmer_bias is not None and not self.perfect
        recon = want_recon("genome", circular_dna=self.circular_dna, hp=hp)
        est_bases = estimate_mean_aligned(self.profile) * 1.1 + 64
        est_events = est_bases / (estimate_mean_match(self.profile) + 1.0)
        # the replayed walk gives the host the events: on the recon route
        # for the read bytes, on the read-emitting route for the error log
        # (but for homopolymer mode, whose log needs the device's own
        # suppression-zeroed events); no walk ran for perfect reads, whose
        # stand-in replayer checks that every lane carries zero events
        replayer = PerfectReplayer() if self.perfect else WalkReplayer(
            self.profile, seed, rng.STREAM_ALIGNED, rng.SITE_WALK,
            e_guard=plan_event_budget(self.profile, self.l_cap, slack=FULL_EVENT_SLACK),
        )

        def make_fetcher():
            return CompactFetcher(self.batch, est_events, replayer,
                                  recon_info=(seed, rng.STREAM_ALIGNED, self.ht_cap),
                                  with_reads=not recon, fastq=self.fastq, est_bases=est_bases)

        def make_hp_fetcher():
            # -hp without reconstruction: the device-materialized read, the
            # device's own (suppression-zeroed) events and the pre-resize
            # middle buffer for the ground-truth log
            return CompactFetcher(self.batch, est_events, None, with_reads=True,
                                  fastq=self.fastq, est_bases=est_bases, with_prehp=True)

        primary = make_hp_fetcher if hp and not recon else make_fetcher
        return primary, make_hp_fetcher if hp else make_fetcher

    def dispatcher(self, seed: int, full_events: bool = False, fetcher=None):
        """The batch entry of a run: ``dispatch(slots)`` queues the run's
        program on the given slot ids (numpy int64, any number of them) and
        returns the batch's handle.  A multi-host rank calls it on its own
        slot shard, with full_events=True: the rescue-grade program, whose
        lanes need no rescue (rescued lanes could not be spliced into the
        sharded numbering)."""
        if fetcher is None:
            fetcher = self._fetchers(seed)[0]()
        # the program emits reads exactly when the route's fetcher moves them
        fn = self.batch_fn(full_events=full_events, emit_reads=fetcher.with_reads)
        base = rng.base_key(seed, rng.STREAM_ALIGNED, device=self.device)

        def dispatch(slots):
            with tracing.span("dispatch.program"):
                out = fn(base, torch.as_tensor(slots, device=self.device))
            h = fetcher.dispatch(out)
            h.slots = slots
            return h

        return dispatch

    def run(self, n_reads: int, writer, seed: int = 0, max_batches: Optional[int] = None,
            resume_state: Optional[str] = None):
        """Simulate n_reads aligned reads into `writer`.

        Linear DNA runs the meta-only program and reconstructs the reads on
        the host unless NANOSIM_TPU_RECON=0; circular DNA always runs the
        read-emitting program (the reconstruction covers linear DNA only).
        Homopolymer mode runs on both; its overflow rescue always goes
        through the device-materialized program.

        resume_state: path to a (slot cursor, accepted) checkpoint file; if
        it exists the run continues from it (callers must open the output
        files in append mode), and it is updated after every batch."""
        primary, rescue = self._fetchers(seed)
        base = rng.base_key(seed, rng.STREAM_ALIGNED, device=self.device)
        wrapped = OverflowRescueWriter(self, writer, base, rescue)
        dispatch = self.dispatcher(seed, fetcher=primary())

        def make_batch(slot_start):
            return dispatch(np.arange(slot_start, slot_start + self.batch, dtype=np.int64))

        state = ResumeState(resume_state) if resume_state else None
        return run_prefetched(make_batch, self.batch, n_reads, wrapped, self,
                              max_batches, state=state)
