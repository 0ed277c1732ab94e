"""`simulate genome` as the benchmark drives it.

A mode module gives the harness four things, found by the traffic's `mode`:
`make_inputs` (the files the program and the reference read, made from the
seed), `load_libraries` (the program's kernel libraries and native writer,
built in a checkout's first run), `Mode` (the program, set up and run job by
job) and `reference` (the plain reference's lanes of each pass).

Set-up builds what `nanosim_tpu_torch.sim.run.simulate_genome` builds after
its arguments are parsed: the packed genome from the FASTA, the profile
from the model directory, the aligned simulator (plain or chimeric) and the
unaligned one.  A job is then what one such call does after it has read its
inputs: the aligned pass and then the unaligned pass, into fresh writers,
with the job's own seed.  The writers' files are the benchmark's sinks.

The benchmark wraps, on these objects alone, the dispatch closure of each
pass (span `dispatch`), each batch handle's `fetch` (span `fetch`: the host
waiting for the device and reading the batch), the writer's batch call
(span `emit`, less the fetch inside it: replay, formatting and writing), and
the emitter's calls, which tell it each written read's slot, name and
length: the read index to slot map that the check of `correct` follows.
"""

from __future__ import annotations

import os

import numpy as np

PASSES = ("aligned", "unaligned")


def _mark(clock, part: str):
    if clock is not None:
        clock.mark(part)


def make_inputs(config: dict, seed: int, workdir: str, sizes: dict = None, clock=None) -> dict:
    """The cell's genome FASTA, made from the run's seed, and its model
    directory, made from the configuration's fixed model seed (the model's
    sizes, and so every buffer width of the program, are the same in every
    run).  `sizes` (tests only) shrinks the genome and the model's lengths."""
    from ..harness import inputs
    from ..harness.bench import derive_seed

    sizes = sizes or {}
    scale = sizes.get("genome_scale") or 1.0
    fasta = os.path.join(workdir, "genome.fa")
    chroms = [(n, max(1000, int(ln * scale))) for n, ln in config["chromosomes"]]
    inputs.make_reference_fasta(fasta, chroms, seed=derive_seed(seed, 1))
    _mark(clock, "make_fasta")
    prefix = os.path.join(workdir, "model", "training")
    inputs.make_model_dir(prefix, **{**config["model"], **sizes.get("model", {})})
    _mark(clock, "make_model")
    return {"fasta": fasta, "model": prefix}


def load_libraries():
    """Import the program and load its kernel libraries and native writer
    (a checkout's first run builds them)."""
    from nanosim_tpu_torch.io import native
    from nanosim_tpu_torch.ops import assemble_cuda, gather_cuda, walk_cuda

    for lib in (walk_cuda.LIBRARY, gather_cuda.LIBRARY, assemble_cuda.LIBRARY):
        lib.load()
    native.get_lib()


def reference(config: dict, traffic: dict, inputs: dict, uniforms: str = "float32") -> dict:
    """The plain reference's lanes of each pass: pass -> (seed, slots) -> lanes.
    uniforms="bfloat16" is the control."""
    from ..reference.oracle import Reference

    ref = Reference(inputs["fasta"], inputs["model"], circular=config["dna_type"] == "circular",
                    fastq=bool(traffic["fastq"]), kmer_bias=traffic.get("kmer_bias"),
                    chimeric=bool(traffic.get("chimeric", False)), uniforms=uniforms)
    return {"aligned": ref.aligned, "unaligned": ref.unaligned}


def _first_counted(spans, handle, fn):
    """fn, counting `batches.consumed` at the handle's first call."""

    def call(*args, **kwargs):
        if not getattr(handle, "_bench_consumed", False):
            handle._bench_consumed = True
            spans.count("batches.consumed")
        return fn(*args, **kwargs)

    return call


class GenomeMode:
    def __init__(self, config: dict, traffic: dict, inputs: dict, *, device, spans, capture,
                 job_reads: int, batch: int, clock=None):
        from nanosim_tpu_torch.io.genome import PackedGenome
        from nanosim_tpu_torch.profiles import profile as profile_mod
        from nanosim_tpu_torch.sim.unaligned_mode import UnalignedSimulator

        self.spans = spans
        self.capture = capture
        self.fastq = bool(traffic["fastq"])
        self.chimeric = bool(traffic.get("chimeric", False))
        self.kmer_bias = traffic.get("kmer_bias")
        circular = config["dna_type"] == "circular"
        self.genome = PackedGenome.from_fasta(inputs["fasta"], dna_type=config["dna_type"])
        _mark(clock, "read_fasta")
        prof = profile_mod.load_profile(inputs["model"], mode="genome", fastq=self.fastq,
                                        chimeric=self.chimeric,
                                        homopolymer=self.kmer_bias is not None)
        n_al, n_un = profile_mod.split_aligned_unaligned([job_reads], prof.aligned_rate, False)
        self.quota = {"aligned": n_al[0], "unaligned": n_un[0]}
        _mark(clock, "read_model")
        if self.chimeric:
            from nanosim_tpu_torch.sim.chimeric_mode import ChimericGenomeSimulator

            self.sim = ChimericGenomeSimulator(self.genome, prof, fastq=self.fastq,
                                               circular_dna=circular, batch=batch,
                                               kmer_bias=self.kmer_bias, device=device)
        else:
            from nanosim_tpu_torch.sim.genome_mode import GenomeSimulator

            self.sim = GenomeSimulator(self.genome, prof, fastq=self.fastq,
                                       circular_dna=circular, batch=batch,
                                       kmer_bias=self.kmer_bias, device=device)
        self.usim = UnalignedSimulator(self.genome, prof, fastq=self.fastq,
                                       circular_dna=circular, batch=batch, device=device)
        _mark(clock, "simulators")
        for pass_name, sim in (("aligned", self.sim), ("unaligned", self.usim)):
            self._wrap_dispatcher(sim, pass_name)
        self.written = {p: [] for p in PASSES}  # (first idx, slots) a written run
        self.wanted = {p: set() for p in PASSES}
        self.longest = {p: (-1, -1) for p in PASSES}  # (length, idx) kept
        self.sinks = []

    # --- instrumentation -------------------------------------------------

    def _wrap_dispatcher(self, sim, pass_name: str):
        spans = self.spans
        make = sim.dispatcher

        def dispatcher(seed, *args, **kwargs):
            dispatch = spans.wrap("dispatch", make(seed, *args, **kwargs))

            def counted(slots):
                h = dispatch(slots)
                spans.count("batches.dispatched")
                if hasattr(h, "fetch"):
                    h.fetch = spans.wrap("fetch", _first_counted(spans, h, h.fetch))
                return h

            return counted

        sim.dispatcher = dispatcher

    def _note(self, pass_name: str, slots, names, totals, n_events):
        """A written run of reads: its slots, and the records to keep."""
        names = list(names)
        if not names:
            return
        marker = "_aligned_" if pass_name == "aligned" else "_unaligned_"
        first = int(names[0].split(marker, 1)[1].split("_", 1)[0])
        self.written[pass_name].append((first, np.asarray(slots, np.int64).copy()))
        totals = np.asarray(totals, np.int64)
        fastq = self.fastq
        rec_len = np.fromiter((len(n) for n in names), np.int64, len(names)) + (
            2 * totals + 6 if fastq else totals + 3)
        offsets = np.cumsum(rec_len) - rec_len
        frac = (np.cumsum(totals) - totals) / max(int(totals.sum()), 1)
        with_log = pass_name == "aligned"
        ranks = [i - first for i in self.wanted[pass_name] if first <= i < first + len(names)]
        best = int(np.argmax(totals))
        if totals[best] > self.longest[pass_name][0]:
            old = self.longest[pass_name][1]
            if old >= 0 and old not in self.wanted[pass_name]:
                self.capture.drop(pass_name, old)
            self.longest[pass_name] = (int(totals[best]), first + best)
            if first + best not in self.wanted[pass_name]:
                ranks.append(best)
        for r in ranks:
            self.capture.want(pass_name, first + r, names[r], int(offsets[r]), float(frac[r]),
                              with_log and int(n_events[r]) > 0)

    def _emitter_notes(self, emitter, pass_name: str):
        note = self._note

        def of_batch(method):
            def wrapped(cb, lanes, names, *args, **kwargs):
                note(pass_name, np.asarray(cb.slots)[lanes], names, cb.total[lanes],
                     cb.n_events[lanes])
                return method(cb, lanes, names, *args, **kwargs)
            return wrapped

        for m in ("emit_recon", "emit_flat", "emit_recon_hp", "emit_recon_unaligned"):
            setattr(emitter, m, of_batch(getattr(emitter, m)))

        def chimeric(method):
            def wrapped(**kw):
                n_seg = np.asarray(kw["n_seg"])
                note(pass_name, kw["slots"], kw["names"], kw["total"], n_seg)
                return method(**kw)
            return wrapped

        emitter.emit_chimeric_recon = chimeric(emitter.emit_chimeric_recon)

    def _writers(self):
        from nanosim_tpu_torch.io.native import NativeEmitter
        from nanosim_tpu_torch.sim import output
        from nanosim_tpu_torch.sim.unaligned_mode import UnalignedBatchWriter

        from ..harness.sink import Sink

        def fastx():
            fw = output.FastxWriter(os.devnull, self.fastq)
            fw.f.close()
            fw.f = Sink(self.capture, "fastx")
            self.sinks.append(fw.f)
            return fw

        el = output.ErrorLogWriter(os.devnull, header=True)
        el.f.close()
        el.f = Sink(self.capture, "log")
        self.sinks.append(el.f)
        fw = fastx()
        if self.chimeric:
            writer = output.ChimericBatchWriter(fw, el)
            write = "write_batch"
        else:
            writer = output.GenomeBatchWriter(fw, el)
            write = "write_run"
        setattr(writer, write, self.spans.wrap("emit", getattr(writer, write)))
        self._emitter_notes(writer._emitter, "aligned")
        if self.chimeric:
            decode = writer._decode_meta
            spans = self.spans

            def decode_meta(sim, h):
                return _first_counted(spans, h, lambda: decode(sim, h))()

            writer._decode_meta = spans.wrap("fetch", decode_meta)
        ufw = fastx()
        uwriter = UnalignedBatchWriter(ufw)
        uwriter._emitter = NativeEmitter()
        self._emitter_notes(uwriter._emitter, "unaligned")
        uwriter.write_batch = self.spans.wrap("emit", uwriter.write_batch)
        return (fw, el, writer), (ufw, uwriter)

    # --- jobs ----------------------------------------------------------------

    def run_job(self, seed: int, wanted=None, quota=None) -> dict:
        """One job: the aligned pass, then the unaligned pass.  `wanted`
        names the read indices a pass keeps for the check; `quota` replaces
        the job's read counts (the warm-up's).  Returns the index to slot
        map and the written bytes of each pass."""
        quota = quota or self.quota
        self.wanted = {p: set((wanted or {}).get(p, ())) for p in PASSES}
        self.written = {p: [] for p in PASSES}
        self.longest = {p: (-1, -1) for p in PASSES}
        self.sinks = []
        (fw, el, writer), (ufw, uwriter) = self._writers()
        self.sim.run(quota["aligned"], writer, seed=seed)
        fw.close()
        el.close()
        if quota["unaligned"] > 0:
            self.usim.run(quota["unaligned"], uwriter, seed=seed)
        ufw.close()
        slots = {}
        for p in PASSES:
            runs = sorted(self.written[p], key=lambda r: r[0])
            slots[p] = (np.concatenate([r[1] for r in runs]) if runs
                        else np.zeros(0, np.int64))
            starts = [r[0] for r in runs]
            lengths = [len(r[1]) for r in runs]
            slots[p + ".contiguous"] = all(
                s == (starts[i - 1] + lengths[i - 1] if i else 0) for i, s in enumerate(starts))
        return {"slots": slots, "quota": dict(quota),
                "bytes": sum(s.bytes for s in self.sinks),
                "longest": {p: self.longest[p][1] for p in PASSES}}


Mode = GenomeMode
