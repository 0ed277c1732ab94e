"""Metagenome-mode simulation: abundance machinery + species assignment +
per-sample orchestration.

Mirrors the reference's metagenome path (simulator.py:814-1040, 2416-2527):
multi-sample abundance matrix, optional abundance variation, chimeric
same-species inflation, greedy base-quota species assignment, per-sample
output files.

The species quota packing (`assign_species`, simulator.py:758-811) is
inherently sequential, so it runs on host over each batch's length draws
(phase A replays the same per-slot RNG the device uses in phase B, so the two
phases agree without shipping state).  Divergence from the reference: reads
keep their (read, segment) length binding instead of consuming from globally
sorted pools — assignment still walks reads in (segments desc, slot) order
with identical quota rules, so per-species base targets are honored the same
way.

Both routes of the chimeric program run here: linear chromosomes on the
host-reconstruction route (the meta-only `chimeric_batch` with packed walk
lanes, part-keyed C++ replays), `NANOSIM_TPU_RECON=0` and homopolymer mode
(`-hp -k`) on the read-emitting program.  The segment walks run the
aligned-walk kernel, the gap walks and each sample's unaligned pass the
unaligned-walk kernel, and the read-emitting program's byte gathers the
element-gather kernel.
"""

from __future__ import annotations

import functools
import os
import sys
from time import strftime
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..io.genome import MetagenomeSet, PackedGenome
from ..ops import rng, xla_math
from ..profiles import profile as profile_mod
from . import extract, output
from .bundles import build_tables, plan_event_budget, plan_ht_capacity, plan_ref_capacity
from .chimeric_mode import ChimericReconHandle, chimeric_batch, pack_chimeric_meta
from .genome_mode import _first_valid, _kde_draw, device_of
from .route import want_recon


def _log(msg):
    sys.stderr.write(strftime("%Y-%m-%d %H:%M:%S") + ": " + msg + "\n")
    sys.stderr.flush()


class MetaResumeState:
    """Batch-granular metagenome checkpoint: (slot cursor, accepted count,
    per-species accepted base totals, host RNG state) — everything the
    sequential quota/abundance machinery needs to continue deterministically.
    """

    def __init__(self, path: str):
        import json
        import os

        self.path = path
        self.loaded = False
        if os.path.exists(path):
            with open(path) as f:
                d = json.load(f)
            self.slot_start = int(d["slot_start"])
            self.accepted = int(d["accepted"])
            self.current_bases = d["current_bases"]
            self.rng_state = d["rng_state"]
            self.loaded = True

    def write(self, slot_start, accepted, current_bases, rng_state):
        import json
        import os

        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "slot_start": int(slot_start),
                "accepted": int(accepted),
                "current_bases": [float(x) for x in np.asarray(current_bases)],
                "rng_state": rng_state,
            }, f)
        os.replace(tmp, self.path)


def read_abundance_matrix(path: str, species_names):
    """Parse the multi-sample abundance tsv (simulator.py:357-380).

    Returns (number_list per sample, [{species: abun}] per sample)."""
    with open(path) as f:
        header = f.readline()
        number_list = [int(x) for x in header.strip().split("\t")[1:]]
        n_samples = len(number_list)
        samples = [dict() for _ in range(n_samples)]
        for line in f:
            if not line.strip():
                continue
            fields = line.split("\t")
            if len(fields) - 1 != n_samples:
                raise ValueError(
                    "Abundance file is incorrectly formatted. Check that each row has the "
                    "same number of columns"
                )
            sp = "_".join(fields[0].split())
            if sp not in species_names:
                raise ValueError(f"You didn't provide a reference genome for {sp}")
            for i in range(n_samples):
                samples[i][sp] = float(fields[1 + i])
    return number_list, samples


def add_abundance_var(expected_abun: dict, total_len: dict, var_low: float, var_high: float, rng_py) -> dict:
    """Random abundance variation, largest |variation| to the largest genome
    (simulator.py:594-615)."""
    abun_var = [rng_py.uniform(var_low, var_high) for _ in total_len]
    per_species = {}
    for var, sp in zip(sorted(abun_var, key=abs), sorted(total_len, key=lambda k: total_len[k])):
        per_species[sp] = var
    with_var = {sp: e + e * per_species[sp] for sp, e in expected_abun.items()}
    total = sum(with_var.values())
    return {sp: a * 100 / total for sp, a in with_var.items()}


def inflate_abun(original_dict: dict, inflated_species: str, abun_inflation: float) -> float:
    """Chimeric same-species continuation probability (simulator.py:2018-2022)."""
    rest = (1 - original_dict[inflated_species]) * abun_inflation
    return 1 - rest


def _phase_a_program(base, slots, kde_aligned, *, S, min_len, max_len, l_cap, perfect):
    """Device half of phase A: the SITE_SEGMENTS uniforms and the
    per-(slot, segment) aligned-length KDE draws (asynchronous on the card
    until `_phase_a_fetch` reads them)."""
    sk = rng.slot_keys(base, slots)
    u_seg = rng.uniform_per_slot(sk, rng.SITE_SEGMENTS)
    seg_keys = [rng.part_slot_keys(sk, rng.PART_SEGMENT_BASE, s) for s in range(S)]
    sk_seg = torch.cat(seg_keys, dim=0)
    ref_c = _kde_draw(sk_seg, rng.SITE_REF_LENGTH, kde_aligned, 2)
    mx = torch.tensor(max_len, dtype=torch.float32, device=ref_c.device)
    if perfect:
        ref_f, _ = _first_valid(ref_c, (ref_c >= min_len) & (ref_c <= mx))
    else:
        ref_f, _ = _first_valid(ref_c, (ref_c > 0) & (ref_c <= mx))
    return u_seg, xla_math.f32_to_i32(ref_f).clamp(0, l_cap)


def assign_species_batch(
    m_ref: np.ndarray,  # [B, S] int
    n_seg: np.ndarray,  # [B]
    current_bases: np.ndarray,  # [n_species]
    abun: np.ndarray,  # [n_species] percentages
    abun_inflated: Optional[np.ndarray],
    rng_py,
) -> np.ndarray:
    """Greedy base-quota species packing (assign_species, simulator.py:758-811).

    Walks reads in (segment-count desc, slot) order; first segments choose
    uniformly among species with remaining quota, later segments keep the
    previous species with the inflated probability.  Counts the segments
    assigned (`species.segments`) and the later segments that kept the
    previous species (`species.kept_previous`).
    """
    B, S = m_ref.shape
    n_species = len(abun)
    bases_to_add = int(m_ref.sum())
    total_bases = bases_to_add + int(current_bases.sum())
    total_abun = abun.sum()
    quota = total_bases * abun / total_abun - current_bases

    order = sorted(range(B), key=lambda b: (-n_seg[b], b))
    species = np.zeros((B, S), np.int32)
    kept_previous = 0
    for b in order:
        prev = -1
        for s in range(int(n_seg[b])):
            ln = int(m_ref[b, s])
            if s == 0:
                avail = np.nonzero(quota - ln > 0)[0]
                if len(avail) == 0:
                    avail = np.nonzero(quota > 0)[0]
                if len(avail) == 0:
                    avail = np.arange(n_species)
                sp = int(avail[int(rng_py.random() * len(avail))])
            else:
                avail = np.nonzero((quota - ln > 0) & (np.arange(n_species) != prev))[0]
                p = rng_py.uniform(0, 100)
                if abun_inflated is not None and p <= abun_inflated[prev] * 100 and quota[prev] > 0:
                    sp = prev
                    kept_previous += 1
                elif len(avail) > 0:
                    sp = int(avail[int(rng_py.random() * len(avail))])
                else:
                    avail = np.nonzero(quota - ln > 0)[0]
                    if len(avail) == 0:
                        avail = np.nonzero(quota > 0)[0]
                    if len(avail) == 0:
                        avail = np.arange(n_species)
                    sp = int(avail[int(rng_py.random() * len(avail))])
            species[b, s] = sp
            quota[sp] -= ln
            prev = sp
    tracing.count("species.segments", int(np.sum(n_seg)))
    tracing.count("species.kept_previous", kept_previous)
    return species


def _wrap_tailed(g: PackedGenome, tail: int) -> PackedGenome:
    """The host genome of the reconstruction route: `g` with each circular
    chromosome followed by its first min(length, tail) bases.  The C++
    emitters read a segment as flat[offsets[c] + pos:][:length]; with the
    tail, a segment or gap that runs past a circular chromosome's origin
    reads on into its first bases, as the device's gathers wrap.  `offsets`
    are then the chromosomes' starts in the longer array (and its length
    last); names, lengths and topology are `g`'s."""
    if not g.circular.any():
        return g
    parts, starts = [], []
    at = 0
    for c in range(g.n_chrom):
        seq = g.flat[g.offsets[c]:g.offsets[c + 1]]
        starts.append(at)
        parts.append(seq)
        at += len(seq)
        if g.circular[c]:
            parts.append(seq[:tail])
            at += min(len(seq), tail)
    return PackedGenome(flat=np.concatenate(parts), names=g.names, lengths=g.lengths,
                        offsets=np.array(starts + [at], np.int64), circular=g.circular)


class MetagenomeSimulator:
    """Per-sample metagenome runner (aligned pass).  Runs on the card unless
    `device` says otherwise."""

    def __init__(
        self,
        mset: MetagenomeSet,
        profile,
        abun: dict,  # {species: percentage}
        *,
        abun_inflated: Optional[dict] = None,
        chimeric: bool = False,
        perfect: bool = False,
        fastq: bool = False,
        min_len: int = 50,
        max_len: float = float("inf"),
        median_len: Optional[float] = None,
        sd_len: Optional[float] = None,
        batch: int = 128,
        s_max: int = 8,
        kmer_bias: Optional[int] = None,
        device="cuda",
    ):
        self.device = device_of(device)
        self.mset = mset
        self.profile = profile
        self.fastq = fastq
        self.chimeric = chimeric
        self.perfect = perfect
        self.batch = batch
        self.kmer_bias = kmer_bias
        self.s_max = s_max if chimeric else 1
        max_len = min(max_len, int(mset.max_chrom_of_species().max()))
        self.max_len = max_len

        self.abun = np.array([abun[sp] for sp in mset.species_names], np.float64)
        self.abun_inflated = (
            np.array([abun_inflated[sp] for sp in mset.species_names], np.float64)
            if abun_inflated
            else None
        )
        self.current_bases = np.zeros(len(mset.species_names), np.float64)

        self.l_cap = plan_ref_capacity(profile, max_len, mset.packed.max_chrom)
        self.ht_cap = plan_ht_capacity(profile)
        if chimeric and profile.kde_gap is not None:
            gap_support = 10.0 ** (
                float(np.max(profile.kde_gap.data)) + 6 * profile.kde_gap.bandwidth
            )
            self.gap_cap = max(128, int(-(-min(gap_support * 1.4, 1e5) // 128) * 128))
        else:
            self.gap_cap = 128
        self.gap_steps = -(-(int(self.gap_cap * 1.3) + 64) // 8) * 8
        self.genome_host = _wrap_tailed(mset.packed, max(self.l_cap, self.gap_cap))
        self.l_out = self.l_cap * (2 if chimeric else 1) + self.gap_cap * 2 + self.ht_cap
        self.e_max = plan_event_budget(profile, self.l_cap, slack=2.5)

        self.tables = build_tables(profile, self.device)
        self.genome_dev = extract.GenomeDevice.from_metagenome(mset, self.device)
        self.kw = dict(
            l_cap=self.l_cap,
            l_out=self.l_out,
            ht_cap=self.ht_cap,
            e_max=self.e_max,
            gap_cap=self.gap_cap,
            gap_steps=self.gap_steps,
            s_max=self.s_max,
            fastq=fastq,
            circular_dna=False,
            min_len=min_len,
            max_len=max_len,
            segment_mean=(profile.segment_mean if chimeric else 1.0),
            metagenome=True,
            count_gap_in_total=True,  # metagenome includes gaps (simulator.py:935-946)
            packed_cap=(int(os.environ["NANOSIM_TPU_PACKED_CAP"])
                        if os.environ.get("NANOSIM_TPU_PACKED_CAP") else None),
            perfect=perfect,
            kmer_bias=kmer_bias,
            hp_r_max=max(128, self.l_cap // 32),
            median_len=median_len,
            sd_len=sd_len,
        )

    def batch_fn(self, **overrides):
        """The batch program (read-emitting unless emit_reads=False is
        passed) over this simulator's genome, tables and capacities; call it
        with `species=`."""
        return functools.partial(
            chimeric_batch, genome=self.genome_dev, tables=self.tables,
            **{**self.kw, **overrides}
        )

    def _slots(self, slot_start: int) -> np.ndarray:
        return np.arange(slot_start, slot_start + self.batch, dtype=np.int64)

    def chimeric_meta_unpacked(self, slots, seed, species):
        """Spill fallback: re-run a batch through the UNPACKED meta program
        (see ChimericGenomeSimulator.chimeric_meta_unpacked)."""
        base = rng.base_key(seed, rng.STREAM_ALIGNED, device=self.device)
        fn = self.batch_fn(emit_reads=False, packed_walks=False)
        out = fn(base, torch.as_tensor(np.asarray(slots), device=self.device),
                 species=torch.as_tensor(np.asarray(species), device=self.device))
        return pack_chimeric_meta(out).cpu().numpy()

    def _phase_a_dispatch(self, base, slots):
        """Dispatch the segment-count/length draws on the device.

        Returns an asynchronous (u_seg, m_ref_flat) handle; the host-side
        finish (`_phase_a_fetch`) keeps the original numpy f64 geometric
        arithmetic so draws stay bit-identical to the pre-fused path."""
        return _phase_a_program(
            base, torch.as_tensor(slots, device=self.device), self.tables.kde_aligned,
            S=self.s_max,
            min_len=self.kw["min_len"],
            max_len=self.max_len,
            l_cap=self.l_cap,
            perfect=self.perfect,
        )

    def _phase_a_fetch(self, handle, B):
        u_seg, m_ref_flat = (x.cpu().numpy() for x in handle)
        S = self.s_max
        if self.kw["segment_mean"] > 1.0 and S > 1:
            n_seg = np.minimum(
                np.ceil(np.log1p(-np.asarray(u_seg))
                        / np.log1p(-1.0 / self.kw["segment_mean"])),
                S,
            ).astype(np.int32)
        else:
            n_seg = np.ones(B, np.int32)
        m_ref = np.asarray(m_ref_flat).reshape(S, B).T
        seg_idx = np.arange(S)[None, :]
        m_ref = np.where(seg_idx < n_seg[:, None], m_ref, 0)
        return n_seg, m_ref

    def _phase_a(self, base, slots):
        """Host replay of the device's segment-count/length draws.

        Uses the same slot/part/site keys as chimeric_batch so phase B's
        device draws match exactly.
        """
        return self._phase_a_fetch(self._phase_a_dispatch(base, slots), len(slots))

    def dispatcher(self, seed: int):
        """The batch entry of a run: ``dispatch(slots, species)`` queues the
        run's program on the given slot ids (numpy int64, any number of them)
        with their per-segment species ([len(slots), S] int32) and returns
        the batch: a ChimericReconHandle from the meta-only program with host
        reconstruction (the part-keyed C++ walk replays and C++
        splice/emit; nothing wide crosses the link), or with
        NANOSIM_TPU_RECON=0 or homopolymer mode the read-emitting program's
        ChimericBatchOut.  A multi-host rank calls it on its own slot shard.
        The route is never changed quietly: without the native library the
        reconstruction route raises."""
        base = rng.base_key(seed, rng.STREAM_ALIGNED, device=self.device)
        if not want_recon("metagenome", hp=self.kmer_bias is not None):
            fn = self.batch_fn()

            def dispatch(slots, species):
                with tracing.span("dispatch.program"):
                    return fn(base, torch.as_tensor(slots, device=self.device),
                              species=torch.as_tensor(species, device=self.device))

            return dispatch

        from ..io.native import PerfectReplayer, UnalignedWalkReplayer, WalkReplayer

        if self.perfect:
            # no walks ran: the stand-in verifies zero events per lane
            self._seg_replayer = PerfectReplayer()
            self._gap_replayer = PerfectReplayer()
        else:
            self._seg_replayer = WalkReplayer(
                self.profile, seed, rng.STREAM_ALIGNED, rng.SITE_WALK,
                e_guard=self.kw["e_max"],
            )
            self._gap_replayer = UnalignedWalkReplayer(
                self.profile, seed, rng.STREAM_ALIGNED, rng.SITE_UNALIGNED_WALK,
                e_guard=self.kw["gap_steps"],
            )
        if not (self._seg_replayer.available and self._gap_replayer.available):
            raise RuntimeError(
                "metagenome host reconstruction needs native/fastwriter.cpp built with g++")
        fn_meta = self.batch_fn(emit_reads=False)

        def dispatch_recon(slots, species):
            with tracing.span("dispatch.program"):
                out = fn_meta(base, torch.as_tensor(slots, device=self.device),
                              species=torch.as_tensor(species, device=self.device))
            return ChimericReconHandle(pack_chimeric_meta(out), slots, self, seed,
                                       species=species)

        return dispatch_recon

    def run(self, n_reads, writer, seed=0, max_batches=None, resume_state=None):
        """Simulate n_reads aligned reads into `writer` (a ChimericBatchWriter
        with the metagenome hooks), on the routes of `dispatcher`.  The
        species quotas start from zero bases unless a resume state is
        loaded, so a run on a simulator that has run before packs as a
        fresh one.

        Spans: `dispatch` (the batch's first slot) around the species
        assignment and the program's dispatch, inside it `species.lengths`
        (the host waiting for phase A's segment counts and lengths) and
        `species.assign` (the quota packing), and `emit.queue_wait` (the
        loop blocked on the emit worker); `batches.dispatched` and the
        loop's own `species.batches` count.  The dispatcher's program call
        runs under `dispatch.program`, its pack under `dispatch.compact`."""
        base = rng.base_key(seed, rng.STREAM_ALIGNED, device=self.device)
        dispatch = self.dispatcher(seed)
        rng_py = np.random.default_rng(np.random.SeedSequence([seed, 0xA55]))
        accepted = 0
        slot_start = 0
        self.current_bases = np.zeros(len(self.mset.species_names), np.float64)
        state = MetaResumeState(resume_state) if resume_state else None
        if state is not None and state.loaded:
            slot_start = state.slot_start
            accepted = state.accepted
            self.current_bases = np.asarray(state.current_bases, np.float64)
            rng_py.bit_generator.state = state.rng_state
        writer.species_bases = self.current_bases
        batches = 0
        can_pipeline = hasattr(writer, "prepare_recon_chimeric")

        # Pipelined loop (recon path): per batch, the only SEQUENTIAL state
        # is the species-quota feedback, which needs just the meta rows —
        # so the expensive C++ replay+emit of batch i is deferred until
        # batch i+1's species are assigned and its device program (and the
        # next phase-A draws) are dispatched.  Host emission then overlaps
        # device compute instead of serializing with it, and phase A's
        # draws are always one batch ahead of the consumer.  Output bytes,
        # read numbering, quota arithmetic, and host-RNG consumption are
        # order-identical to the synchronous loop.
        pending = None  # (handle, prepared, checkpoint_snapshot)
        # the deferred emits run on a single ordered worker so the main
        # thread never blocks on throttled file writes at all; batch order
        # (and therefore output bytes) is preserved by the queue; the
        # dispatcher's route shows in its handles
        emit_io = None

        def flush_pending():
            nonlocal pending
            if pending is None:
                return
            h, prep, snap = pending
            pending = None

            def do_emit(h=h, prep=prep, snap=snap):
                writer.write_batch(self, h, snap[1], n_reads, prepared=prep)
                # checkpoint only after the batch's bytes are on disk, so
                # the state never outruns the files
                if state is not None:
                    state.write(*snap[0], snap[2], snap[3])

            if emit_io is not None:
                with tracing.span("emit.queue_wait"):
                    emit_io.submit(do_emit)
            else:
                do_emit()

        pa = self._phase_a_dispatch(base, self._slots(slot_start))
        while accepted < n_reads:
            if max_batches is not None and batches >= max_batches:
                break
            batches += 1
            slots = self._slots(slot_start)
            with tracing.span("dispatch", slot_start):
                with tracing.span("species.lengths"):
                    n_seg, m_ref = self._phase_a_fetch(pa, self.batch)
                with tracing.span("species.assign"):
                    species = assign_species_batch(
                        m_ref, n_seg, self.current_bases, self.abun, self.abun_inflated, rng_py
                    )
                out = dispatch(slots, species)
                tracing.count("batches.dispatched")
                tracing.count("species.batches")
            slot_start += self.batch
            pa = self._phase_a_dispatch(base, self._slots(slot_start))
            if can_pipeline and isinstance(out, ChimericReconHandle):
                # previous batch's emit overlaps this batch's device program
                if emit_io is None:
                    emit_io = output._OrderedIO(depth=2)
                flush_pending()
                prep = writer.prepare_recon_chimeric(self, out, accepted, n_reads)
                prev = accepted
                accepted += len(prep["lanes"])
                output.report_progress(prev, accepted)
                pending = (out, prep, (
                    (slot_start, accepted), prev,
                    np.array(self.current_bases), rng_py.bit_generator.state,
                ))
            else:
                prev = accepted
                accepted += writer.write_batch(self, out, accepted, n_reads)
                output.report_progress(prev, accepted)
                if state is not None:
                    state.write(slot_start, accepted, self.current_bases,
                                rng_py.bit_generator.state)
        flush_pending()
        if emit_io is not None:
            emit_io.close()
        return accepted


def simulate_metagenome(
    genome_list: str,
    abun_path: str,
    dna_type_list,
    model_prefix: str,
    out: str,
    *,
    perfect: bool = False,
    fastq: bool = False,
    chimeric: bool = False,
    kmer_bias=None,
    homopolymer: bool = False,
    strandness=None,
    abun_var=None,
    min_len: int = 50,
    max_len: float = float("inf"),
    median_len=None,
    sd_len=None,
    seed: int = 0,
    batch: int = 128,
    n_hosts: int = 1,
    host_id: int = 0,
    coordinator=None,
    resume: bool = False,
    device="cuda",
) -> dict:
    """Full metagenome run over all samples (simulator.py:2416-2527): per
    sample `{out}_sample<i>_aligned_reads`, `_aligned_error_profile` and
    `_unaligned_reads`.  median_len and sd_len (`-med/-sd`) draw the aligned
    reads' lengths from a lognormal; the unaligned pass keeps its KDE
    lengths, as in the JAX package.  Runs on the card unless `device` says
    otherwise.

    With n_hosts > 1 this process is rank host_id and writes
    `{out}_{sample}_aligned_*_h{host_id}` shards (their concatenation is the
    single-host output up to record order; `coordinator` as in
    run.simulate_genome); the unaligned passes run on host 0."""
    multi = n_hosts > 1
    if multi:
        from ..parallel import MultiHostMetagenomeRunner, init_distributed, rank_device

        device = rank_device(device, host_id)
    device = device_of(device)
    _log("Read in reference")
    mset = MetagenomeSet.from_genome_list(genome_list, dna_type_list)
    _log("Read in abundance profile")
    number_list, samples = read_abundance_matrix(abun_path, set(mset.species_names))

    prof = profile_mod.load_profile(
        model_prefix,
        mode="metagenome",
        perfect=perfect,
        chimeric=chimeric,
        homopolymer=homopolymer,
        fastq=fastq,
        strandness=strandness,
    )
    aligned_l, unaligned_l = profile_mod.split_aligned_unaligned(
        number_list, prof.aligned_rate, perfect
    )
    ext = ".fastq" if fastq else ".fasta"
    rng_py = np.random.default_rng(np.random.SeedSequence([seed, 0xAB]))
    totals = {}
    total_len = {
        sp: int(mset.total_len_of_species()[i]) for i, sp in enumerate(mset.species_names)
    }

    for s_idx, sample_abun in enumerate(samples):
        sample = f"sample{s_idx}"
        if abun_var:
            dict_abun = add_abundance_var(
                sample_abun, total_len, float(abun_var[0]), float(abun_var[1]), rng_py
            )
        else:
            dict_abun = sample_abun
        abun_inflated = None
        if chimeric:
            abun_inflated = {
                sp: inflate_abun(
                    {k: v / 100 for k, v in dict_abun.items()}, sp, prof.abun_inflation
                )
                for sp in dict_abun
            }
        _log(f"Simulating sample {sample}")
        sim = MetagenomeSimulator(
            mset,
            prof,
            dict_abun,
            abun_inflated=abun_inflated,
            chimeric=chimeric,
            perfect=perfect,
            fastq=fastq,
            min_len=min_len,
            max_len=max_len,
            median_len=median_len,
            sd_len=sd_len,
            batch=batch,
            kmer_bias=kmer_bias,
            device=device,
        )
        prefix = f"{out}_{sample}"
        tag = f"_h{host_id}" if multi else ""

        done_marker = prefix + ".resume_done"
        if resume and os.path.exists(done_marker):
            _log(f"Sample {sample} already complete; skipping")
            totals[sample] = aligned_l[s_idx]
            continue
        a_state = prefix + "_aligned.resume.json"
        a_resuming = resume and not multi and os.path.exists(a_state)
        fw = output.FastxWriter(prefix + "_aligned_reads" + tag + ext, fastq,
                                append=a_resuming)
        el = output.ErrorLogWriter(prefix + "_aligned_error_profile" + tag,
                                   header=(host_id == 0), append=a_resuming)
        w = output.ChimericBatchWriter(
            fw,
            el,
            species_names=mset.species_names,
            species_of_chrom=mset.species_of_chrom,
            metagenome=True,
            perfect=perfect,
        )
        if multi:
            init_distributed(coordinator, n_hosts if coordinator else None, host_id)
            got = MultiHostMetagenomeRunner(sim, n_hosts, host_id).run(
                aligned_l[s_idx], w, seed=seed + s_idx)
        else:
            got = sim.run(aligned_l[s_idx], w, seed=seed + s_idx,
                          resume_state=a_state if resume else None)
        fw.close()
        el.close()

        if not perfect and unaligned_l[s_idx] > 0 and host_id == 0:
            from .unaligned_mode import UnalignedBatchWriter, UnalignedSimulator

            usim = UnalignedSimulator(
                mset.packed,
                prof,
                fastq=fastq,
                min_len=min_len,
                max_len=max_len,
                batch=batch,
                genome_dev=sim.genome_dev,
                device=device,
            )
            u_state = prefix + "_unaligned.resume.json"
            u_resuming = resume and os.path.exists(u_state)
            ufw = output.FastxWriter(prefix + "_unaligned_reads" + ext, fastq,
                                     append=u_resuming)
            usim.run(unaligned_l[s_idx], UnalignedBatchWriter(ufw), seed=seed + s_idx,
                     resume_state=u_state if resume else None)
            ufw.close()
        if resume:
            with open(done_marker, "w") as f:
                f.write("done\n")
        totals[sample] = got
    output.RUN_STATS.report(_log)
    _log("Finished!")
    return totals
