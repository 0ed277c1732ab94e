"""Unaligned-read simulation pass (simulation_unaligned,
simulator.py:1482-1549).

Same batch machinery as the genome aligned pass, but: lengths come from the
unaligned-length KDE, the error walk uses fixed type probabilities
(unaligned walk, CUDA kernel on the card), there is no head/tail, and FASTQ
qualities are all "unmapped"-class.  Read names end `_unaligned_<idx>_<F|R>`
with 0 head/tail and middle_ref as the middle length.  On linear DNA the
device runs the meta-only program and the host replays the step stream and
reconstructs the bytes (reconstruct_unaligned_lane is the spec); circular
DNA and NANOSIM_TPU_RECON=0 run the read-emitting program.

In transcriptome mode the read comes from a uniform transcript among those
longer than it; direct RNA reads (`uracil`) carry 'U' for 'T', which the host
reconstruction does not write, so that pass runs the read-emitting program
and moves the reads as raw bytes.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..ops import apply_errors, error_walk, rng, seqops, xla_math
from . import extract
from .bundles import SimTables, build_tables
from .genome_mode import BatchOut, _kde_draw, check_circular, device_of, lognormal_len
from .route import want_recon

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
    emit_reads: bool = True,
    uracil: bool = False,
    transcriptome_mode: bool = False,
    median_len: Optional[float] = None,
    sd_len: Optional[float] = None,
) -> BatchOut:
    """The unaligned-read batch program (KDE lengths, or with median_len the
    lognormal `-med/-sd` lengths about the median itself): the read-emitting
    program, or with emit_reads=False the meta-only one."""
    B = slots.shape[0]
    sk = rng.slot_keys(base_key, slots)

    if median_len is not None:
        ref_len_f = lognormal_len(sk, median_len, sd_len, perfect=True)
    else:
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

    if transcriptome_mode:
        # extract_read transcriptome branch: uniform transcript among those
        # strictly longer than the read (simulator.py:1695-1703)
        chrom, local_pos, pos_ok = extract.sample_uniform_chrom_positions(
            sk, middle_ref, genome)
    else:
        chrom, local_pos, pos_ok = extract.sample_genome_positions(
            sk, middle_ref, genome, circular_dna)
    valid &= pos_ok
    u_strand = rng.uniform_per_slot(sk, rng.SITE_STRAND)
    is_rev = u_strand > tables.strandness_rate

    read = quals = None
    if not emit_reads:
        # The read-emitting program rejects lanes whose presentation buffer
        # overflows; its closed form: middle_ref + total inserted bases
        # exceeds build_unaligned_map's default capacity.
        ins = walk.events_valid & (walk.events_type == 1)
        tot_ins = torch.where(ins, walk.events_len, torch.zeros_like(walk.events_len)).sum(dim=1)
        valid &= (middle_ref + tot_ins) <= apply_errors.presentation_cap(l_cap)
    else:
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
        if uracil:
            read = torch.where(read != 0, seqops.to_uracil(read), read)
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


class UnalignedBatchWriter:
    """Accept/number/emit an unaligned batch.

    Name format: `<chrom>_<pos>_unaligned_<idx>_<F|R>_0_<middle_ref>_0`
    (simulator.py:1511, 1534).  No error log is written for unaligned reads
    (the reference passes error_log=None, simulator.py:1515).
    """

    def __init__(self, fastx):
        self.fastx = fastx
        self._emitter = None

    def accepted(self, sim, out) -> np.ndarray:
        """The batch's accepted lanes, [B] bool (what write_batch emits)."""
        cb = out.fetch()
        return cb.valid & ~cb.cap_over

    def write_batch(self, sim, out, accepted_so_far: int, quota: int, lanes=None,
                    start=None) -> int:
        """Emit a compact batch: reconstructed on the host from a meta-only
        batch, or decoded from the read-emitting program's 2-bit reads.  A
        multi-host run passes its own `lanes`, numbered from `start`."""
        cb = out.fetch()
        if getattr(cb, "finish", None) is not None:
            cb.finish()  # lazy walk replay
        if lanes is None:
            lanes = np.nonzero(self.accepted(sim, out))[0][: quota - accepted_so_far]
        if start is not None:
            accepted_so_far = start
        if len(lanes) == 0:
            return 0
        g = sim.genome_host
        gnames = g.names
        names = []
        with tracing.span("emit.names"):
            for rank, b in enumerate(lanes):
                idx = accepted_so_far + rank
                strand = "R" if cb.rev[b] else "F"
                names.append(
                    f"{gnames[cb.chrom[b]]}_{cb.pos[b]}_unaligned_{idx}_{strand}"
                    f"_0_{cb.middle_ref[b]}_0"
                )
        from ..io.native import NativeEmitter

        if self._emitter is None:
            self._emitter = NativeEmitter()
        lanes = np.asarray(lanes, np.int64)
        chrom = cb.chrom[lanes]
        if cb.reads_flat is not None and not cb.pack_reads:
            # raw-byte reads (direct RNA): the Python writer, as the JAX
            # package writes them
            with tracing.span("emit.format"):
                for name, b in zip(names, lanes):
                    o, n = int(cb.read_off[b]), int(cb.total[b])
                    q = None
                    if sim.fastq:
                        qo = int(cb.qual_off[b])
                        q = cb.quals_flat[qo : qo + n]
                    self.fastx.write(name, cb.reads_flat[o : o + n], q)
            return len(lanes)
        if cb.reads_flat is None:
            qt = None
            if sim.fastq:
                qd = sim.tables.qual
                with tracing.span("fetch.copy"):
                    qt = (qd.breaks.cpu().numpy(), qd.vals.cpu().numpy())
            mv = self._emitter.emit_recon_unaligned(
                cb, lanes, names, g_off=g.offsets[chrom], genome_flat=g.flat,
                fastq=sim.fastq, qual_table=qt,
            )
        else:
            mv, _ = self._emitter.emit_flat(
                cb, lanes, names, g_off=g.offsets[chrom], g_len=g.lengths[chrom],
                g_circ=np.ascontiguousarray(g.circular[chrom], np.uint8),
                genome_flat=g.flat, fastq=sim.fastq, write_errors=False,
            )
        with tracing.span("emit.write"):
            self.fastx.flush()
            self.fastx.f.write(mv)
        return len(lanes)


class UnalignedSimulator:
    def __init__(
        self,
        genome,
        profile,
        *,
        fastq=False,
        circular_dna=False,
        min_len=50,
        max_len=float("inf"),
        median_len=None,
        sd_len=None,
        batch=256,
        uracil=False,
        transcriptome_mode=False,
        genome_dev=None,
        device="cuda",
    ):
        if profile.kde_unaligned is None or profile.mix_params is None:
            raise ValueError("the unaligned pass needs the unaligned-length KDE and "
                             "the error-length mixtures")
        check_circular(genome, circular_dna)
        self.device = device_of(device)
        self.genome_host = genome
        self.profile = profile
        self.fastq = fastq
        self.circular_dna = circular_dna
        max_len = min(max_len, genome.max_chrom)
        kde = profile.kde_unaligned
        support = float(np.max(kde.data)) + 6.0 * kde.bandwidth
        l_cap = max(256, int(-(-min(support * 1.4 + 64, float(genome.max_chrom)) // 256) * 256))
        self.l_cap = l_cap
        # The unaligned walk advances ~1.3 ref bases per step in expectation
        # (0.4 match + mixture-length errors), so the step budget is ~linear
        # in the length cap.
        self.e_max = -(-(int(l_cap * 1.25) + 64) // 8) * 8
        self.tables = build_tables(profile, self.device)
        # reuse an already-uploaded GenomeDevice (the metagenome runner
        # shares its 48+ MB upload instead of paying it twice per run)
        self.genome_dev = (genome_dev if genome_dev is not None
                           else extract.GenomeDevice.from_packed(genome, self.device))
        self.uracil = uracil
        self.kw = dict(l_cap=l_cap, e_max=self.e_max, min_len=min_len, max_len=max_len,
                       fastq=fastq, circular_dna=circular_dna, uracil=uracil,
                       transcriptome_mode=transcriptome_mode, median_len=median_len,
                       sd_len=sd_len)
        self.batch = batch

    def batch_fn(self, emit_reads: bool = True):
        return functools.partial(
            unaligned_batch, genome=self.genome_dev, tables=self.tables,
            emit_reads=emit_reads, **self.kw
        )

    def dispatcher(self, seed: int):
        """The batch entry of a run: ``dispatch(slots)`` queues the run's
        program on the given slot ids (numpy int64, any number of them; the
        pass keys them off STREAM_UNALIGNED) and returns the batch's handle.
        A multi-host rank calls it on its own slot shard.

        Linear DNA runs the meta-only program with host reconstruction
        unless NANOSIM_TPU_RECON=0; circular DNA and direct RNA reads
        (`uracil`, moved as raw bytes) the read-emitting one."""
        from ..io.native import UnalignedWalkReplayer
        from .output import CompactFetcher

        recon = want_recon("unaligned", circular_dna=self.circular_dna, direct_rna=self.uracil)
        base = rng.base_key(seed, rng.STREAM_UNALIGNED, device=self.device)
        # without reconstruction the host needs no events (no error log)
        replayer = UnalignedWalkReplayer(
            self.profile, seed, rng.STREAM_UNALIGNED, rng.SITE_UNALIGNED_WALK,
            e_guard=self.e_max,
        ) if recon else None
        est_bases = float(np.mean(self.profile.kde_unaligned.data)) * 1.2 + 64
        fetcher = CompactFetcher(self.batch, est_bases / 1.2, replayer,
                                 recon_info=(seed, rng.STREAM_UNALIGNED, 0),
                                 with_reads=not recon, fastq=self.fastq, est_bases=est_bases,
                                 pack_reads=not self.uracil)
        fn = self.batch_fn(emit_reads=not recon)

        def dispatch(slots):
            with tracing.span("dispatch.program"):
                out = fn(base, torch.as_tensor(slots, device=self.device))
            h = fetcher.dispatch(out)
            h.slots = slots
            return h

        return dispatch

    def run(self, n_reads, writer, seed=0, max_batches=None, resume_state=None):
        """Simulate n_reads unaligned reads into `writer` (the routes of
        `dispatcher`)."""
        from .genome_mode import ResumeState, run_prefetched

        dispatch = self.dispatcher(seed)

        def make_batch(slot_start):
            return dispatch(np.arange(slot_start, slot_start + self.batch, dtype=np.int64))

        state = ResumeState(resume_state) if resume_state else None
        return run_prefetched(make_batch, self.batch, n_reads, writer, self,
                              max_batches, state=state)
