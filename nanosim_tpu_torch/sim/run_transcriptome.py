"""Transcriptome-mode simulator, writer, and top-level run (single host).

Read names (simulator.py:1188-1219):
  `<trx>_<pos>_aligned_<idx>[_RetainedIntron_<s>-<e>;...]_<F|R>_<head>_<mid>_<tail+polyA>`
Perfect reads use `_perfect_` with 0 head and `<tail>` = polyA length.

Two routes.  The default one runs the meta-only program on the device and
reconstructs the reads on the host (C++ walk replay checked against the
device checksum, then emit_trx_recon: head | middle | polyA | tail, with the
intron-retention sources assembled here from the per-feature intervals).
`-hp` and NANOSIM_TPU_RECON=0 run the read-emitting program; only the
accepted lanes' rows cross to the host.
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
from ..io.genome import PackedGenome
from ..ops import rng
from ..profiles import profile as profile_mod
from . import extract, output
from .bundles import build_tables, plan_event_budget, plan_ht_capacity, plan_ref_capacity
from .genome_mode import ResumeState, device_of, run_prefetched
from .route import want_recon
from .transcriptome_mode import TrxReconHandle, pack_trx_meta, transcriptome_batch

POLYA_SCALE = {"albacore": 2.409858743694814, "guppy": 4.168299657168961}

_COMP_LUT = np.arange(256, dtype=np.uint8)
for _a, _b in ((ord("A"), ord("T")), (ord("C"), ord("G"))):
    _COMP_LUT[_a], _COMP_LUT[_b] = _b, _a


def _log(msg):
    sys.stderr.write(strftime("%Y-%m-%d %H:%M:%S") + ": " + msg + "\n")
    sys.stderr.flush()


def _lane_name(trx_name, pos, kind, idx, n_ir, ir_iv, rev, head, mref, tail_pa) -> str:
    name = f"{trx_name}_{pos}_{kind}_{idx}"
    if n_ir > 0:
        name += "_RetainedIntron_"
        for k in range(n_ir):
            name += f"{ir_iv[k, 0]}-{ir_iv[k, 1]};"
    name += "_R" if rev else "_F"
    return name + f"_{head}_{mref}_{tail_pa}"


class TrxBatchWriter:
    """Accept/number/emit a transcriptome batch.

    A meta-only batch (TrxReconHandle) is reconstructed on the host.  A
    read-emitting batch goes through the C++ batch formatter, whose per-event
    reference bases come from the batch's own extracted ref rows (handed to
    the emitter as its flat 'genome' at offset rank * row width), which also
    covers intron-retention reads whose sequence source is genomic intervals;
    with `-hp` or `uracil` the records and the ground-truth log are written
    here (`_log_lane`)."""

    def __init__(self, fastx, error_log=None, perfect: bool = False):
        self.fastx = fastx
        self.error_log = error_log
        self.perfect = perfect
        from ..io.native import NativeEmitter

        self._emitter = NativeEmitter()
        if not self._emitter.available:
            raise RuntimeError("the transcriptome writer needs native/fastwriter.cpp built "
                               "with g++")

    def accepted(self, sim, out) -> np.ndarray:
        """The batch's accepted lanes, [B] bool (what write_batch emits)."""
        if isinstance(out, TrxReconHandle):
            return out.decoded()["valid"]
        with tracing.span("fetch.copy"):
            return out.valid.cpu().numpy()

    def write_batch(self, sim, out, accepted_so_far: int, quota: int, lanes=None,
                    start=None) -> int:
        """Emit the batch's accepted lanes up to the quota, numbered from
        accepted_so_far; or, in a multi-host run, the given `lanes` numbered
        from `start`."""
        if lanes is None:
            lanes = np.nonzero(self.accepted(sim, out))[0][: quota - accepted_so_far]
        if start is not None:
            accepted_so_far = start
        if isinstance(out, TrxReconHandle):
            return _trx_recon_write(self, sim, out, lanes, accepted_so_far)
        k = len(lanes)
        if k == 0:
            return 0
        # only what the emitters read crosses the link: the accepted lanes'
        # rows, reads up to the longest total, events up to the longest list
        lane_t = torch.as_tensor(np.asarray(lanes, np.int64), device=out.valid.device)

        def host(x):
            return np.ascontiguousarray(x[lane_t].cpu().numpy())

        hp_mode = sim.kmer_bias is not None
        with_events = self.error_log is not None and not self.perfect
        with tracing.span("fetch.copy"):
            total = host(out.total_len)
            head = host(out.head)
            tail = host(out.tail)
            pa = host(out.polya_len)
            middle_ref = host(out.middle_ref)
            l_new = host(out.l_new)
            trx = host(out.trx)
            pos = host(out.local_pos)
            rev = host(out.is_reversed)
            ir_iv = host(out.ir_intervals)
            n_ir = host(out.n_ir)
            n_events = host(out.n_events)
            max_total = max(int(total.max()), 1)
            reads = np.ascontiguousarray(out.read[lane_t, :max_total].cpu().numpy())
            quals = (np.ascontiguousarray(out.quals[lane_t, :max_total].cpu().numpy())
                     if sim.fastq else None)
            ref_seg = host(out.ref_seg)
            if with_events:
                max_ne = max(int(n_events.max()), 1)
                ev_p = np.ascontiguousarray(out.ev_pos2x[lane_t, :max_ne].cpu().numpy())
                ev_t = np.ascontiguousarray(out.ev_type[lane_t, :max_ne].cpu().numpy())
                ev_l = np.ascontiguousarray(out.ev_len[lane_t, :max_ne].cpu().numpy())
            prehp = host(out.read_prehp) if hp_mode else None
        names_t = sim.genome_host.names
        kind = "perfect" if self.perfect else "aligned"
        with tracing.span("emit.names"):
            rec_names = [
                _lane_name(names_t[trx[r]], pos[r], kind, accepted_so_far + r, n_ir[r], ir_iv[r],
                           rev[r], head[r], middle_ref[r], tail[r] + pa[r])
                for r in range(k)
            ]

        if not hp_mode and not sim.uracil:
            # the per-event ref bases live in the accepted lanes' extracted
            # rows: hand them to the emitter as the flat "genome", lane r's
            # row at offset r * Lr, start position 0
            ranks = np.arange(k, dtype=np.int64)
            Lr = ref_seg.shape[1]
            fastx_bytes, err_bytes = self._emitter.emit(
                reads=reads, quals=quals, lanes=ranks, names=rec_names, total_len=total,
                head=head, l_new=l_new, rev=rev,
                ev_pos2x=ev_p if with_events else None,
                ev_type=ev_t if with_events else None,
                ev_len=ev_l if with_events else None,
                n_events=n_events if with_events else np.zeros(k, np.int64),
                g_off=ranks * Lr, g_len=np.full(k, Lr, np.int64), g_circ=np.zeros(k, np.uint8),
                start_pos=np.zeros(k, np.int64), genome_flat=ref_seg.reshape(-1),
                fastq=sim.fastq, write_errors=with_events,
            )
            with tracing.span("emit.write"):
                self.fastx.flush()
                self.fastx.f.write(fastx_bytes)
                if with_events:
                    self.error_log.write_bytes(err_bytes)
            return k

        rows = []
        for r in range(k):
            seq = reads[r, : total[r]]
            self.fastx.write(rec_names[r], seq, quals[r, : total[r]] if sim.fastq else None)
            if with_events and n_events[r] > 0:
                rows.extend(self._log_lane(rec_names[r], seq, head[r], l_new[r], rev[r],
                                           int(n_events[r]), ev_p[r], ev_t[r], ev_l[r],
                                           ref_seg[r], prehp[r] if hp_mode else None))
        if rows:
            with tracing.span("emit.write"):
                self.error_log.write_bytes("".join(rows).encode())
        return k

    @staticmethod
    def _log_lane(name, seq, head, l_new, rev, ne, ev_p, ev_t, ev_l, ref_row, prehp_row=None):
        """One read's ground-truth log rows, in reverse position order as
        mutate_read logs them; zero-length (suppressed or overwritten) events
        are skipped."""
        if prehp_row is not None:
            mid = prehp_row  # pass-1 coordinates (pre-hp resize)
        else:
            # the ground-truth log records pre-uracil bases (the reference
            # translates T->U after mutate_read's logging, simulator.py:1247)
            pre = np.where(seq == ord("U"), np.uint8(ord("T")), seq)
            if rev:
                pre = _COMP_LUT[pre[::-1]]
            mid = pre[head : head + l_new]
        ty = ev_t[:ne].astype(np.int64)
        keys, rpos, eff = output.event_read_positions(
            ev_p[:ne].astype(np.int64), ty, ev_l[:ne].astype(np.int64))
        rows = []
        for key, t, ln, rp in zip(keys.tolist(), ty.tolist(), eff.tolist(), rpos.tolist()):
            if ln == 0:
                continue
            if t == 1:
                ref = "-" * ln
                sq = mid[rp : rp + ln].tobytes().decode()
            else:
                ref = ref_row[key : key + ln].tobytes().decode()
                sq = mid[rp : rp + ln].tobytes().decode() if t == 0 else "-" * ln
            rows.append(f"{name}\t{key}\t{output._ETYPE_NAMES[t]}\t{ln}\t{ref}\t{sq}\n")
        rows.reverse()
        return rows


def _trx_recon_write(writer, sim, h, lanes, accepted_so_far: int) -> int:
    """Host-reconstruct + emit the given lanes of a meta-only transcriptome
    batch, numbered from accepted_so_far."""
    d = h.decoded()
    k = len(lanes)
    if k == 0:
        return 0
    slots = np.asarray(h.slots)
    trx_host = sim.genome_host
    kind = "perfect" if writer.perfect else "aligned"
    with tracing.span("emit.names"):
        names = [
            _lane_name(trx_host.names[d["trx"][b]], d["pos"][b], kind, accepted_so_far + rank,
                       d["n_ir"][b], d["ir_iv"][b], d["rev"][b], d["head"][b], d["mref"][b],
                       d["tail"][b] + d["pa"][b])
            for rank, b in enumerate(lanes)
        ]

    # replay the aligned walk for the selected lanes (checksum-verified)
    nev = d["n_events"][lanes]
    off = np.concatenate([[0], np.cumsum(nev)])[:-1]
    ev_out = np.zeros(max(int(nev.sum()), 1), np.uint32)
    with tracing.span("emit.replay"):
        ok = sim._replayer.replay(
            slots[lanes], np.ones(k, np.uint8), d["mref0"][lanes], nev,
            d["cksum"][lanes].astype(np.uint32), ev_out, off,
        )
    if not bool(ok.all()):
        raise RuntimeError(
            "transcriptome walk replay failed checksum verification; "
            "set NANOSIM_TPU_RECON=0 to materialize the reads on the device"
        )

    # sources: transcript slices, or host-assembled IR interval concats
    use_b = np.zeros(k, np.uint8)
    src_off = np.zeros(k, np.int64)
    aux_parts = []
    aux_pos = 0
    t_off = np.asarray(trx_host.offsets)
    g_off = np.asarray(sim.ir_genome_host.offsets) if sim.with_ir else None
    for rank, b in enumerate(lanes):
        if d["has_ir"][b]:
            g = sim.ir_genome_host
            goff = int(g_off[d["ir_chrom"][b]])
            # only the few features the read takes bases from (a structure
            # may have hundreds), in feature order
            used = np.nonzero(d["feat_take"][b] > 0)[0]
            chunks = [g.flat[goff + s0 : goff + s0 + take] for s0, take in
                      zip(d["feat_start"][b, used].tolist(), d["feat_take"][b, used].tolist())]
            buf = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
            use_b[rank] = 1
            src_off[rank] = aux_pos
            aux_parts.append(buf)
            aux_pos += len(buf)
        else:
            src_off[rank] = int(t_off[d["trx"][b]]) + int(d["pos"][b])
    src_b = np.concatenate(aux_parts) if aux_parts else np.zeros(1, np.uint8)

    with_events = writer.error_log is not None and not writer.perfect
    qt = None
    if sim.fastq:
        qd = sim.tables.qual
        with tracing.span("fetch.copy"):
            qt = (qd.breaks.cpu().numpy(), qd.vals.cpu().numpy())
    fastx_mv, err_mv = writer._emitter.emit_trx_recon(
        seed=h.seed, stream=rng.STREAM_ALIGNED, ht_cap=sim.ht_cap,
        slots=slots[lanes], names=names,
        total=d["total"][lanes], head=d["head"][lanes], tail=d["tail"][lanes],
        pa_len=d["pa"][lanes], l_new=d["lnew"][lanes],
        middle_ref=d["mref"][lanes], rev=d["rev"][lanes].astype(np.uint8),
        ev_flat=ev_out, ev_off=off, n_events=nev,
        src_a=trx_host.flat, src_b=src_b, use_b=use_b, src_off=src_off,
        fastq=sim.fastq, uracil=sim.uracil, write_errors=with_events, qual_table=qt,
    )
    with tracing.span("emit.write"):
        writer.fastx.flush()
        writer.fastx.f.write(fastx_mv)
        if with_events:
            writer.error_log.write_bytes(err_mv)
    return k


class TranscriptomeSimulator:
    """Host side of the aligned transcriptome pass: batches, slot
    accounting, acceptance, output.  exact_conditional draws the aligned
    lengths from the 2D KDE's exact conditional (KdeDevice.sample_conditional)
    instead of the reference's nearest-of-a-pool estimator.  Runs on the card
    unless `device` says otherwise."""

    def __init__(
        self,
        transcriptome: PackedGenome,
        profile,
        expression,
        *,
        fastq: bool = False,
        perfect: bool = False,
        uracil: bool = False,
        polya_scale: float = 0.0,
        model_ir: bool = False,
        ir_genome: Optional[PackedGenome] = None,
        max_len: float = float("inf"),
        batch: int = 256,
        kmer_bias: Optional[int] = None,
        exact_conditional: bool = False,
        device="cuda",
    ):
        if fastq and profile.base_quals is None:
            raise ValueError("fastq=True needs a profile loaded with fastq=True")
        if kmer_bias is not None and not perfect and profile.hp_params is None:
            raise ValueError("kmer_bias needs a profile loaded with homopolymer=True")
        self.device = device_of(device)
        self.genome_host = transcriptome
        self.profile = profile
        self.fastq = fastq
        self.perfect = perfect
        self.batch = batch
        self.kmer_bias = kmer_bias
        # direct RNA: the read-emitting route writes the records in Python
        # (the log records the bases BEFORE the T->U translate,
        # simulator.py:1247); the reconstruction route translates in C++
        self.uracil = uracil

        name_to_idx = transcriptome.name_index()
        # expression-eligible transcripts present in the reference
        eli_idx, weights = [], []
        for nm, w in zip(expression.names, expression.weights):
            if nm in name_to_idx:
                eli_idx.append(name_to_idx[nm])
                weights.append(w)
        if not eli_idx:
            raise ValueError("no expressed transcripts match the reference transcriptome")

        self.ir_tables = None
        self.ir_genome_dev = None
        with_ir = False
        if model_ir and profile.structures is not None and ir_genome is not None:
            from .ir import IRTables

            tables_ir, ok_mask = IRTables.build(
                profile.structures, transcriptome.names, ir_genome.names, profile.ir_markov,
                transcriptome.lengths, self.device)
            # IR mode only simulates structure-eligible transcripts
            # (simulator.py:1094-1100 rejection loop)
            keep = [(i, w) for i, w in zip(eli_idx, weights) if ok_mask[i]]
            if keep:
                eli_idx = [i for i, _ in keep]
                weights = [w for _, w in keep]
                self.ir_tables = tables_ir
                self.ir_genome_dev = extract.GenomeDevice.from_packed(ir_genome, self.device)
                self.ir_genome_host = ir_genome
                with_ir = True
            else:
                _log("WARNING: no expressed transcripts match the GFF structures; IR disabled")
        self.with_ir = with_ir

        w = np.asarray(weights, np.float64)
        w = w / w.sum()
        self.cum_weights = torch.as_tensor(np.cumsum(w), device=self.device)
        self.trx_of_eligible = torch.as_tensor(np.asarray(eli_idx, np.int32), device=self.device)
        polya_mask = np.zeros(transcriptome.n_chrom, bool)
        if profile.polya:
            for nm in profile.polya:
                if nm in name_to_idx:
                    polya_mask[name_to_idx[nm]] = True
        self.polya_mask = torch.as_tensor(polya_mask, device=self.device)

        self.l_cap = plan_ref_capacity(profile, max_len, transcriptome.max_chrom)
        self.ht_cap = plan_ht_capacity(profile)
        self.l_out = self.l_cap + self.ht_cap + 512  # + polyA slack
        self.e_max = plan_event_budget(profile, self.l_cap, slack=2.5)
        self.tables = build_tables(profile, self.device)
        self.genome_dev = extract.GenomeDevice.from_packed(transcriptome, self.device)
        self.kw = dict(
            l_cap=self.l_cap, l_out=self.l_out, ht_cap=self.ht_cap, e_max=self.e_max,
            fastq=fastq, perfect=perfect, uracil=uracil, polya_scale=polya_scale,
            with_ir=with_ir, kmer_bias=kmer_bias, hp_r_max=max(128, self.l_cap // 32),
            exact_conditional=exact_conditional,
        )

    def batch_fn(self, emit_reads: bool = True):
        """The batch program: read-emitting, or meta-only (host
        reconstruction) with emit_reads=False."""
        return functools.partial(
            transcriptome_batch, genome=self.genome_dev, tables=self.tables,
            cum_weights=self.cum_weights, trx_of_eligible=self.trx_of_eligible,
            polya_mask=self.polya_mask, ir_tables=self.ir_tables,
            ir_genome=self.ir_genome_dev, emit_reads=emit_reads, **self.kw,
        )

    def dispatcher(self, seed: int):
        """The batch entry of a run: ``dispatch(slots)`` queues the run's
        program on the given slot ids (numpy int64, any number of them) and
        returns the batch: a TrxReconHandle from the meta-only program with
        host reconstruction (about 130 bytes per lane cross the link), or with
        `-hp` or NANOSIM_TPU_RECON=0 the read-emitting program's TrxBatchOut.
        A multi-host rank calls it on its own slot shard."""
        base = rng.base_key(seed, rng.STREAM_ALIGNED, device=self.device)
        recon = want_recon("transcriptome", hp=self.kmer_bias is not None)
        if not recon:
            fn = self.batch_fn()

            def dispatch(slots):
                with tracing.span("dispatch.program"):
                    return fn(base, torch.as_tensor(slots, device=self.device))

            return dispatch

        from ..io.native import PerfectReplayer, WalkReplayer
        from .ir import MAX_IR_OUT

        if self.perfect:
            # no walk ran: verify the zero-event invariant per lane
            self._replayer = PerfectReplayer()
        else:
            self._replayer = WalkReplayer(self.profile, seed, rng.STREAM_ALIGNED,
                                          rng.SITE_WALK, e_guard=self.e_max)
            if not self._replayer.available:
                raise RuntimeError("the walk replayer needs native/fastwriter.cpp built with g++")
        fn_meta = self.batch_fn(emit_reads=False)
        # ir_intervals width is min(f_max, MAX_IR_OUT) (sim/ir.py's argsort slice)
        n_iv = min(MAX_IR_OUT, self.ir_tables.f_max) if self.with_ir else 1
        F = self.ir_tables.f_max if self.with_ir else 1

        def dispatch_recon(slots):
            with tracing.span("dispatch.program"):
                out = fn_meta(base, torch.as_tensor(slots, device=self.device))
                if self.with_ir:
                    irc = self.ir_tables.chrom[self.ir_tables.feat_offset[out.trx.long()].long()]
                else:
                    irc = torch.zeros(len(slots), dtype=torch.int32, device=self.device)
            return TrxReconHandle(pack_trx_meta(out, irc), slots, self, seed, n_iv, F)

        return dispatch_recon

    def run(self, n_reads, writer, seed=0, max_batches=None, resume_state=None):
        """Simulate n_reads aligned reads into `writer` (the routes of
        `dispatcher`)."""
        dispatch = self.dispatcher(seed)

        def make_batch(slot_start):
            return dispatch(np.arange(slot_start, slot_start + self.batch, dtype=np.int64))

        state = ResumeState(resume_state) if resume_state else None
        return run_prefetched(make_batch, self.batch, n_reads, writer, self, max_batches,
                              state=state)


def simulate_transcriptome(
    ref_t: str,
    ref_g: str,
    exp_path: str,
    model_prefix: str,
    out: str,
    number: int = 20000,
    *,
    perfect: bool = False,
    fastq: bool = False,
    kmer_bias=None,
    homopolymer: bool = False,
    strandness=None,
    model_ir: bool = True,
    polya=None,
    basecaller=None,
    uracil: bool = False,
    min_len: int = 50,
    max_len: float = float("inf"),
    seed: int = 0,
    batch: int = 256,
    n_hosts: int = 1,
    host_id: int = 0,
    coordinator=None,
    resume: bool = False,
    device="cuda",
) -> dict:
    """Full transcriptome run (reference main transcriptome branch,
    simulator.py:2322-2414): aligned reads (cDNA or direct RNA with
    `uracil`, polyA tails with `polya` + `basecaller`, intron retention with
    `model_ir` and the genome `ref_g`, `-hp` with `kmer_bias`, `--perfect`),
    then unaligned reads.  Runs on the card unless `device` says otherwise.

    With n_hosts > 1 this process is rank host_id and writes
    `{out}_aligned_*_h{host_id}` shards of the aligned pass (their
    concatenation is the single-host output up to record order; `coordinator`
    as in run.simulate_genome); the unaligned pass runs on host 0."""
    multi = n_hosts > 1
    if multi:
        from ..parallel import MultiHostModeRunner, init_distributed, rank_device

        init_distributed(coordinator, n_hosts if coordinator else None, host_id)
        device = rank_device(device, host_id)
    _log("Read in reference transcriptome")
    transcriptome = PackedGenome.from_fasta(ref_t)
    ir_genome = None
    if model_ir and ref_g:
        _log("Read in reference genome")
        ir_genome = PackedGenome.from_fasta(ref_g)

    prof = profile_mod.load_profile(
        model_prefix, mode="transcriptome", perfect=perfect, homopolymer=homopolymer,
        fastq=fastq, model_ir=model_ir, polya_path=polya, strandness=strandness,
    )
    _log("Read in expression profile")
    seq_len = dict(zip(transcriptome.names, (int(x) for x in transcriptome.lengths)))
    expression = profile_mod.load_expression(exp_path, seq_len)

    n_aligned, n_unaligned = profile_mod.split_aligned_unaligned(
        [number], prof.aligned_rate, perfect)
    polya_scale = POLYA_SCALE.get(basecaller, 0.0) if polya else 0.0
    ext = ".fastq" if fastq else ".fasta"

    _log("Start simulation of aligned reads")
    sim = TranscriptomeSimulator(
        transcriptome, prof, expression, fastq=fastq, perfect=perfect, uracil=uracil,
        polya_scale=polya_scale, model_ir=model_ir, ir_genome=ir_genome, max_len=max_len,
        batch=batch, kmer_bias=kmer_bias, device=device,
    )
    tag = f"_h{host_id}" if multi else ""
    state_path = out + "_aligned.resume.json"
    resuming = resume and not multi and os.path.exists(state_path)
    fw = output.FastxWriter(out + "_aligned_reads" + tag + ext, fastq, append=resuming)
    el = output.ErrorLogWriter(out + "_aligned_error_profile" + tag, header=(host_id == 0),
                               append=resuming)
    writer = TrxBatchWriter(fw, el, perfect=perfect)
    if multi:
        MultiHostModeRunner(sim, n_hosts, host_id).run(n_aligned[0], writer, seed=seed)
    else:
        sim.run(n_aligned[0], writer, seed=seed, resume_state=state_path if resume else None)
    fw.close()
    el.close()

    if not perfect and n_unaligned[0] > 0 and host_id == 0:
        from .unaligned_mode import UnalignedBatchWriter, UnalignedSimulator

        _log("Start simulation of random reads")
        usim = UnalignedSimulator(transcriptome, prof, fastq=fastq, min_len=min_len,
                                  max_len=max_len, batch=batch, uracil=uracil,
                                  transcriptome_mode=True, device=device)
        ustate = out + "_unaligned.resume.json"
        uresuming = resume and os.path.exists(ustate)
        ufw = output.FastxWriter(out + "_unaligned_reads" + ext, fastq, append=uresuming)
        usim.run(n_unaligned[0], UnalignedBatchWriter(ufw), seed=seed,
                 resume_state=ustate if resume else None)
        ufw.close()

    output.RUN_STATS.report(_log)
    _log("Finished!")
    return {"aligned": n_aligned[0], "unaligned": 0 if perfect else n_unaligned[0]}
