"""`simulate metagenome --chimeric` as the benchmark drives it.

Set-up builds what `nanosim_tpu_torch.sim.run_metagenome.simulate_metagenome`
builds after its arguments are parsed: the community from the genome list
and the dna-type list (`MetagenomeSet.from_genome_list`), the abundances
(`read_abundance_matrix`), the profile of the metagenome mode, one
`MetagenomeSimulator` for the sample and an `UnalignedSimulator` on its
device genome.  A job is then what one such call does for its one sample
after it has read its inputs: the aligned pass and then the unaligned pass,
into fresh writers, with the job's own seed, on the same simulators job
after job.  The writers' files are the benchmark's sinks.

The aligned pass emits on the program's worker thread (`output._OrderedIO`):
the loop decodes a batch, advances the species quotas and hands the batch's
replay and emit to the worker, which writes while the loop packs and
dispatches the next batch.  So the benchmark's own spans (`dispatch`,
`fetch`) are taken on the loop's thread alone; the emitter's calls, which
tell the sinks each written read's slot, name and length, run on the worker
in batch order, and the job returns only once the worker has written its
last batch.  The program's own spans (`nanosim_tpu_torch.tracing`) record on
both threads.  The sinks are `harness/literal_sink.LiteralSink`s: they keep
the records the genome mode's sinks keep, but find them by literal searches,
so that the capture does not hold the interpreter from both threads for
tenths of a second at each kept read.

The reference replays a job's species packing from slot 0, which costs
seconds a job: the mode notes each checked job's seed and the batches its
aligned pass reached (`inputs["replays"]`), and the reference replays them
all in worker processes while the check goes job by job.
"""

from __future__ import annotations

import os
import threading


from .genome import PASSES, GenomeMode, _first_counted, _mark, load_libraries  # noqa: F401


def _fasta_name(species: str) -> str:
    return species.replace(" ", "_") + ".fa"


def make_inputs(config: dict, seed: int, workdir: str, sizes: dict = None, clock=None) -> dict:
    """One FASTA a species with the community's sequences, its bases made
    from the run's seed; the genome list, the dna-type list and the
    abundance file (one sample of the configuration's reads); the model
    directory, made from the configuration's fixed model seed.  `sizes`
    (tests only) shrinks the sequences, the model's lengths, the sample and
    the batch."""
    from ..harness import inputs
    from ..harness.bench import derive_seed

    sizes = sizes or {}
    scale = sizes.get("genome_scale") or 1.0
    lengths = dict(config["chromosomes"])
    glist = os.path.join(workdir, "genome_list.tsv")
    dtypes = os.path.join(workdir, "dna_types.tsv")
    circular = set(config["circular"])
    with open(glist, "w") as gl, open(dtypes, "w") as dl:
        for i, sp in enumerate(config["species"]):
            path = os.path.join(workdir, _fasta_name(sp["name"]))
            seqs = [(n, max(500, int(lengths[n] * scale))) for n in sp["sequences"]]
            inputs.make_reference_fasta(path, seqs, seed=derive_seed(seed, 1, i))
            gl.write(f"{sp['name']}\t{path}\n")
            for n, _ in seqs:
                dl.write(f"{sp['name']}\t{n}\t{'circular' if n in circular else 'linear'}\n")
    _mark(clock, "make_fasta")
    abundance = os.path.join(workdir, "abundance.tsv")
    with open(abundance, "w") as f:
        f.write(f"Species\t{sizes.get('job_reads', config['sample_reads'])}\n")
        for sp in config["species"]:
            f.write(f"{sp['name']}\t{sp['abundance']}\n")
    prefix = os.path.join(workdir, "model", "training")
    inputs.make_model_dir(prefix, **{**config["model"], **sizes.get("model", {})})
    _mark(clock, "make_model")
    return {"genome_list": glist, "dna_types": dtypes, "abundance": abundance, "model": prefix,
            "batch": sizes.get("batch")}


def reference(config: dict, traffic: dict, inputs: dict, uniforms: str = "float32") -> dict:
    """The plain reference's lanes of each pass: pass -> (seed, slots) -> lanes.
    uniforms="bfloat16" is the control."""
    from ..reference.metagenome import MetagenomeReference

    ref = MetagenomeReference(inputs["genome_list"], inputs["dna_types"], inputs["abundance"],
                              inputs["model"], batch=inputs.get("batch") or traffic["batch"],
                              fastq=bool(traffic["fastq"]), uniforms=uniforms)
    ref.prefetch(inputs.get("replays", ()))
    return {"aligned": ref.aligned, "unaligned": ref.unaligned}


class MetagenomeMode(GenomeMode):
    """The genome mode's jobs, notes and unaligned pass (`GenomeMode.run_job`,
    `_note`, `_emitter_notes`), on the metagenome's simulators and writers."""

    def __init__(self, config: dict, traffic: dict, inputs: dict, *, device, spans, capture,
                 job_reads: int, batch: int, clock=None):
        from nanosim_tpu_torch.io.genome import MetagenomeSet
        from nanosim_tpu_torch.profiles import profile as profile_mod
        from nanosim_tpu_torch.sim.run_metagenome import (MetagenomeSimulator, inflate_abun,
                                                          read_abundance_matrix)
        from nanosim_tpu_torch.sim.unaligned_mode import UnalignedSimulator

        if not traffic.get("chimeric") or traffic.get("kmer_bias") is not None:
            raise ValueError("the metagenome mode drives --chimeric without -hp")
        self.spans = spans
        self.capture = capture
        self.fastq = bool(traffic["fastq"])
        self.batch = batch
        self.replays = inputs.setdefault("replays", [])
        self.loop_thread = threading.current_thread()
        self.mset = MetagenomeSet.from_genome_list(inputs["genome_list"], inputs["dna_types"])
        _mark(clock, "read_fasta")
        number_list, samples = read_abundance_matrix(inputs["abundance"],
                                                     set(self.mset.species_names))
        if number_list != [job_reads]:
            raise ValueError(f"the abundance file's sample of {number_list} reads is not the "
                             f"job's {job_reads}")
        prof = profile_mod.load_profile(inputs["model"], mode="metagenome", chimeric=True,
                                        fastq=self.fastq)
        n_al, n_un = profile_mod.split_aligned_unaligned(number_list, prof.aligned_rate, False)
        self.quota = {"aligned": n_al[0], "unaligned": n_un[0]}
        _mark(clock, "read_model")
        abun = samples[0]
        stay = {sp: inflate_abun({k: v / 100 for k, v in abun.items()}, sp, prof.abun_inflation)
                for sp in abun}
        self.sim = MetagenomeSimulator(self.mset, prof, abun, abun_inflated=stay, chimeric=True,
                                       fastq=self.fastq, batch=batch, device=device)
        self.usim = UnalignedSimulator(self.mset.packed, prof, fastq=self.fastq, batch=batch,
                                       genome_dev=self.sim.genome_dev, device=device)
        _mark(clock, "simulators")
        self._wrap_species_dispatcher()
        self._wrap_dispatcher(self.usim, "unaligned")
        self.written = {p: [] for p in PASSES}
        self.wanted = {p: set() for p in PASSES}
        self.longest = {p: (-1, -1) for p in PASSES}
        self.sinks = []

    def run_job(self, seed: int, wanted=None, quota=None) -> dict:
        """`GenomeMode.run_job`; a job with reads to check (not the
        warm-up) is noted for the reference's replay."""
        res = super().run_job(seed, wanted, quota)
        slots = res["slots"]["aligned"]
        if wanted is not None and len(slots):
            self.replays.append((seed, int(slots.max()) // self.batch + 1))
        return res

    # --- instrumentation -------------------------------------------------

    def _wrap_species_dispatcher(self):
        """The aligned pass's dispatch closure, `dispatch(slots, species)`,
        inside the span `dispatch`, counting `batches.dispatched`."""
        spans, sim = self.spans, self.sim
        make = sim.dispatcher

        def dispatcher(seed, *args, **kwargs):
            dispatch = spans.wrap("dispatch", make(seed, *args, **kwargs))

            def counted(slots, species):
                h = dispatch(slots, species)
                spans.count("batches.dispatched")
                return h

            return counted

        sim.dispatcher = dispatcher

    def _writers(self):
        from nanosim_tpu_torch.io.native import NativeEmitter
        from nanosim_tpu_torch.sim import output
        from nanosim_tpu_torch.sim.unaligned_mode import UnalignedBatchWriter

        from ..harness.literal_sink import LiteralSink

        def fastx():
            fw = output.FastxWriter(os.devnull, self.fastq)
            fw.f.close()
            fw.f = LiteralSink(self.capture, "fastx")
            self.sinks.append(fw.f)
            return fw

        el = output.ErrorLogWriter(os.devnull, header=True)
        el.f.close()
        el.f = LiteralSink(self.capture, "log")
        self.sinks.append(el.f)
        fw = fastx()
        writer = output.ChimericBatchWriter(fw, el, species_names=self.mset.species_names,
                                            species_of_chrom=self.mset.species_of_chrom,
                                            metagenome=True, perfect=False)
        # the emit runs on the worker thread: notes, no benchmark span
        self._emitter_notes(writer._emitter, "aligned")
        decode = writer._decode_meta
        spans, loop = self.spans, self.loop_thread
        timed = spans.wrap("fetch", lambda sim, h: _first_counted(
            spans, h, lambda: decode(sim, h))())

        def decode_meta(sim, h):
            # the benchmark's spans are one thread's timeline: the loop's
            if threading.current_thread() is loop:
                return timed(sim, h)
            return decode(sim, h)

        writer._decode_meta = decode_meta
        ufw = fastx()
        uwriter = UnalignedBatchWriter(ufw)
        uwriter._emitter = NativeEmitter()
        self._emitter_notes(uwriter._emitter, "unaligned")
        uwriter.write_batch = self.spans.wrap("emit", uwriter.write_batch)
        return (fw, el, writer), (ufw, uwriter)


Mode = MetagenomeMode
