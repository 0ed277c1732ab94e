"""`simulate metagenome --chimeric --fastq` of the port against the
benchmark's plain reference (gpubench/reference/metagenome.py), on a
community shaped as the ZymoBIOMICS Even standard: ten species, eight
bacteria of one circular chromosome each, a yeast of 16 linear chromosomes
and a circular mitochondrion, another of 14 linear chromosomes, every
length about a thousandth of the real one.

The port runs `MetagenomeSimulator` on the CPU for three batches of 64
slots into real files; the reference replays the job's species packing
from slot 0 and renders every read it accepts.  The FASTQ file and the
error log must be the reference's bytes, and every segment's species the
reference's packing.  The cases: the Even abundances; ten equal
abundances and reads of 2.5 segments, under which a batch's last segments
find no species with room left (the packing's fallbacks); and reads longer
than many chromosomes (the position fallback to a longer chromosome
of the species, or of another species).  A second `run()` on the same
simulator writes what a fresh simulator writes.
"""

import os

import numpy as np
import pytest

import test_torch_common  # noqa: F401  (one torch thread a worker)
from gpubench.harness import inputs as bench_inputs
from gpubench.reference.metagenome import MetagenomeReference
from nanosim_tpu_torch.io.genome import MetagenomeSet
from nanosim_tpu_torch.profiles import profile as tprofile
from nanosim_tpu_torch.sim import output as tout
from nanosim_tpu_torch.sim.run_metagenome import (MetagenomeSimulator, inflate_abun,
                                                  read_abundance_matrix)
from nanosim_tpu_torch.sim.unaligned_mode import UnalignedBatchWriter, UnalignedSimulator

SEED = 2**33 + 21
BATCH = 64
BATCHES = 3
UNALIGNED = 40

BACTERIA = [("Pseudomonas aeruginosa", 6792), ("Escherichia coli", 4875),
            ("Salmonella enterica", 4760), ("Bacillus subtilis", 4045),
            ("Listeria monocytogenes", 2992), ("Enterococcus faecalis", 2845),
            ("Staphylococcus aureus", 2730), ("Limosilactobacillus fermentum", 1905)]
SCER = [230, 813, 317, 1532, 577, 270, 1091, 563, 440, 746, 667, 1078, 924, 784, 1091, 948]

# case -> (abundances of the eight bacteria and of the two yeasts, mean and
# sd of the segments' lengths, segment mean)
CASES = {
    "even": ([12.0] * 8 + [2.0, 2.0], 500.0, 200.0, 1.9),
    "quota_runs_out": ([10.0] * 10, 500.0, 200.0, 2.5),
    "segment_outgrows": ([12.0] * 8 + [2.0, 2.0], 1800.0, 700.0, 1.9),
}


def _community(d: str, abun) -> tuple:
    """The genome list, dna-type list and abundance file of the community."""
    species = [b[0] for b in BACTERIA] + ["Saccharomyces cerevisiae", "Cryptococcus neoformans"]
    seqs = [[(b[0].split()[1][:4] + "-chr", b[1])] for b in BACTERIA]
    seqs.append([(f"Scer-chr{i + 1}", n) for i, n in enumerate(SCER)] + [("Scer-chrM", 86)])
    seqs.append([(f"Cneo-chr{i + 1}", 1350) for i in range(14)])
    glist, dl, ab = (os.path.join(d, f) for f in ("genomes.tsv", "dna.tsv", "abun.tsv"))
    with open(glist, "w") as g, open(dl, "w") as t, open(ab, "w") as a:
        a.write("Species\t1000\n")
        for i, (sp, chroms) in enumerate(zip(species, seqs)):
            path = os.path.join(d, f"sp{i}.fa")
            bench_inputs.make_reference_fasta(path, chroms, seed=100 + i)
            g.write(f"{sp}\t{path}\n")
            for name, _ in chroms:
                circ = i < 8 or name == "Scer-chrM"
                t.write(f"{sp}\t{name}\t{'circular' if circ else 'linear'}\n")
            a.write(f"{sp}\t{abun[i]}\n")
    return glist, dl, ab


@pytest.fixture(scope="module", params=list(CASES))
def case(request, tmp_path_factory):
    """(name, inputs, the port's set, profile, abundances) of a case."""
    abun, mean, sd, seg_mean = CASES[request.param]
    d = str(tmp_path_factory.mktemp(request.param))
    glist, dl, ab = _community(d, abun)
    prefix = os.path.join(d, "model", "training")
    bench_inputs.make_model_dir(prefix, seed=7, mean_read_len=mean, sd_read_len=sd,
                                n_kde_points=300, segment_mean=seg_mean)
    mset = MetagenomeSet.from_genome_list(glist, dl)
    _, samples = read_abundance_matrix(ab, set(mset.species_names))
    prof = tprofile.load_profile(prefix, mode="metagenome", chimeric=True, fastq=True)
    ref = MetagenomeReference(glist, dl, ab, prefix, batch=BATCH, fastq=True)
    return request.param, mset, prof, samples[0], ref, d


def _simulator(mset, prof, abun):
    stay = {sp: inflate_abun({k: v / 100 for k, v in abun.items()}, sp, prof.abun_inflation)
            for sp in abun}
    sim = MetagenomeSimulator(mset, prof, abun, abun_inflated=stay, chimeric=True, fastq=True,
                              batch=BATCH, device="cpu")
    dispatcher = sim.dispatcher
    sim.dispatched = []  # (slots, species) of every batch

    def recording(seed):
        dispatch = dispatcher(seed)

        def call(slots, species):
            sim.dispatched.append((np.array(slots), np.array(species)))
            return dispatch(slots, species)

        return call

    sim.dispatcher = recording
    return sim


def _aligned_run(sim, mset, out: str) -> tuple:
    """Three batches of the aligned pass into files: (FASTQ bytes, log rows)."""
    fw = tout.FastxWriter(out + ".fastq", True)
    el = tout.ErrorLogWriter(out + "_err", header=True)
    w = tout.ChimericBatchWriter(fw, el, species_names=mset.species_names,
                                 species_of_chrom=mset.species_of_chrom, metagenome=True)
    sim.dispatched = []
    sim.run(10**6, w, seed=SEED, max_batches=BATCHES)
    fw.close()
    el.close()
    with open(out + ".fastq", "rb") as f, open(out + "_err", "rb") as g:
        return f.read(), g.read().split(b"\n", 1)[1]


def _expected(ref, slots) -> tuple:
    lanes = [ln for ln in ref.aligned(SEED, slots) if ln.valid]
    recs = [ln.render(i) for i, ln in enumerate(lanes)]
    return b"".join(r for r, _ in recs), b"".join(g for _, g in recs), len(lanes)


def _wrapping_segments(heads, g) -> int:
    """Segments of the named reads that run past a circular chromosome's end."""
    wraps = 0
    for head in heads:
        comps, rest = head.split("_aligned_")[0], head.rsplit("_", 3)
        segs = [c for c in comps.split(";") if not c.startswith("gap_")]
        for comp, mid in zip(segs, rest[2].split(";")):
            chrom, pos = comp.split("-", 1)[1].rsplit("_", 1)
            c = g.names.index(chrom)
            wraps += bool(g.circular[c]) and int(pos) + int(mid) > g.lengths[c]
    return wraps


def test_port_equals_reference(case, tmp_path):
    """The FASTQ bytes, the error log's rows and every segment's species
    equal the reference's; the case's branches were taken, and the unaligned
    pass equals the reference's too."""
    name, mset, prof, abun, ref, _ = case
    sim = _simulator(mset, prof, abun)
    fastq, log = _aligned_run(sim, mset, str(tmp_path / "meta"))
    slots = np.arange(BATCHES * BATCH)
    want_fastq, want_log, n = _expected(ref, slots)
    assert n > BATCH and fastq.count(b"\n@") + 1 == n
    assert fastq == want_fastq
    assert log == want_log
    assert len(sim.dispatched) == BATCHES
    got_species = np.concatenate([s for _, s in sim.dispatched])
    np.testing.assert_array_equal(got_species, ref.species_of(SEED, slots))

    taken = ref.job(SEED, BATCHES).taken
    assert taken["stayed"] > 0 and taken["room"] > 0
    if name == "quota_runs_out":
        assert taken["quota_left"] > 0 and taken["other_room"] > 0, taken
    if name == "segment_outgrows":
        assert taken["outgrew"] > 0 and taken["elsewhere"] > 0, taken
    # chimeric reads, and (not vacuous) segments read past a circular origin
    heads = [h[1:].decode() for h in fastq.split(b"\n")[0::4] if h]
    assert any(";gap_" in h for h in heads)
    if name == "even":
        assert _wrapping_segments(heads, ref.community.genome) > 0

    usim = UnalignedSimulator(mset.packed, prof, fastq=True, batch=BATCH,
                              genome_dev=sim.genome_dev, device="cpu")
    ufw = tout.FastxWriter(str(tmp_path / "un.fastq"), True)
    usim.run(UNALIGNED, UnalignedBatchWriter(ufw), seed=SEED)
    ufw.close()
    lanes = [ln for ln in ref.unaligned(SEED, np.arange(2 * BATCH)) if ln.valid][:UNALIGNED]
    with open(tmp_path / "un.fastq", "rb") as f:
        assert f.read() == b"".join(ln.render(i)[0] for i, ln in enumerate(lanes))


def test_second_run_packs_as_a_fresh_simulator(case, tmp_path):
    """The species quotas start from zero bases in every run: a simulator
    that has run before writes what a fresh one writes."""
    _, mset, prof, abun, ref, _ = case
    sim = _simulator(mset, prof, abun)
    first = _aligned_run(sim, mset, str(tmp_path / "first"))
    first_species = [s for _, s in sim.dispatched]
    assert sim.current_bases.sum() > 0  # the first run left bases in the quotas
    second = _aligned_run(sim, mset, str(tmp_path / "second"))
    assert second == first
    for a, (_, b) in zip(first_species, sim.dispatched):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["even"], indirect=True)
def test_device_route_equals_reference(case, tmp_path, monkeypatch):
    """The read-emitting program (NANOSIM_TPU_RECON=0) writes the reference's
    bytes too, so both routes read a segment past a circular origin alike."""
    _, mset, prof, abun, ref, _ = case
    monkeypatch.setenv("NANOSIM_TPU_RECON", "0")
    sim = _simulator(mset, prof, abun)
    fastq, log = _aligned_run(sim, mset, str(tmp_path / "meta"))
    want_fastq, want_log, _ = _expected(ref, np.arange(BATCHES * BATCH))
    assert fastq == want_fastq
    assert log == want_log
    heads = [h[1:].decode() for h in fastq.split(b"\n")[0::4] if h]
    assert _wrapping_segments(heads, ref.community.genome) > 0


def test_replay_in_workers_equals_replay_here(case):
    """Jobs replayed in the reference's worker processes hold the packing
    replayed in this one, and a replay asked for further than a worker went
    goes on from the worker's state as this process's would."""
    _, _, _, _, ref, d = case
    other = MetagenomeReference(*(os.path.join(d, f) for f in ("genomes.tsv", "dna.tsv",
                                                               "abun.tsv")),
                                os.path.join(d, "model", "training"), batch=BATCH, fastq=True)
    seeds = (SEED, SEED + 1)
    other.prefetch([(s, BATCHES - 1) for s in seeds])
    assert sorted(other._pending) == sorted(seeds)
    for s in seeds:
        got, want = other.job(s, BATCHES), ref.job(s, BATCHES)
        for a, b in zip(got.species + got.valid, want.species + want.valid, strict=True):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.bases, want.bases)
        assert got.taken == want.taken
        assert got.gen.bit_generator.state == want.gen.bit_generator.state
    assert other._pool is None and not other._pending
