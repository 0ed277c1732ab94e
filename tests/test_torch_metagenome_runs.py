"""Whole `simulate metagenome` runs of the port against the JAX package, byte
for byte: every sample's aligned reads, error profile and unaligned reads.

The fixture of tests/test_metagenome.py (three species, two samples of 120
and 80 reads, segment mean 1.6).  Runs: plain FASTA, FASTQ, `--chimeric` on
the host-reconstruction route and with NANOSIM_TPU_RECON=0, a run whose
packed walk lanes spill on every batch, `--perfect`, `-hp -k 6`,
`--abun_var`, a run interrupted after one batch and resumed, and the CLI.
Also: the species share of bases in the port's own files, and the routes'
refusals (no quiet change of route, no CPU default).
"""

import filecmp
import functools
import os

import pytest

from nanosim_tpu_torch.sim import output as tout
from nanosim_tpu_torch.sim import run_metagenome as trm

from test_torch_common import make_metagenome_fixture, read_file

SEED = 1
BATCH = 64
SAMPLES = ("sample0", "sample1")

# tag -> (keyword arguments of simulate_metagenome, NANOSIM_TPU_RECON=0)
RUNS = {
    "plain": (dict(), False),
    "fastq": (dict(fastq=True), False),
    "chimeric": (dict(chimeric=True, fastq=True), False),
    "chimeric_recon0": (dict(chimeric=True, fastq=True), True),
    "perfect": (dict(perfect=True), False),
    "hp": (dict(kmer_bias=6, homopolymer=True, fastq=True), False),
    "abun_var": (dict(abun_var=[-0.5, 0.5]), False),
}


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return make_metagenome_fixture(str(tmp_path_factory.mktemp("metaruns")))


def _env(mp, recon0: bool, packed_cap=None):
    if recon0:
        mp.setenv("NANOSIM_TPU_RECON", "0")
    if packed_cap is not None:
        mp.setenv("NANOSIM_TPU_PACKED_CAP", str(packed_cap))


@pytest.fixture(scope="module")
def jax_runs(fx):
    """get(tag) -> output prefix of the JAX package's whole run, made once."""
    from nanosim_tpu.sim.run_metagenome import simulate_metagenome

    done = {}

    def get(tag):
        if tag not in done:
            kw, recon0 = RUNS[tag]
            out = os.path.join(fx.d, "jax_" + tag, "sim")
            os.makedirs(os.path.dirname(out))
            with pytest.MonkeyPatch.context() as mp:
                _env(mp, recon0)
                simulate_metagenome(fx.glist, fx.abun, fx.dl, fx.prefix, out, seed=SEED,
                                    batch=BATCH, **kw)
            done[tag] = out
        return done[tag]

    return get


def torch_run(fx, tag, packed_cap=None, name=None) -> str:
    """The port's whole run on the CPU -> its output prefix."""
    kw, recon0 = RUNS[tag]
    out = os.path.join(fx.d, "torch_" + (name or tag), "sim")
    os.makedirs(os.path.dirname(out))
    tout.RUN_STATS.reset()
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, recon0, packed_cap)
        totals = trm.simulate_metagenome(fx.glist, fx.abun, fx.dl, fx.prefix, out, seed=SEED,
                                         batch=BATCH, device="cpu", **kw)
    assert set(totals) == set(SAMPLES) and all(v > 0 for v in totals.values())
    assert tout.RUN_STATS.checksum_fallback_lanes == 0
    return out


def _files(tag):
    kw = RUNS[tag][0]
    ext = ".fastq" if kw.get("fastq") else ".fasta"
    sufs = ["_aligned_reads" + ext, "_aligned_error_profile"]
    if not kw.get("perfect"):
        sufs.append("_unaligned_reads" + ext)
    return [f"_{s}{suf}" for s in SAMPLES for suf in sufs]


def assert_same_files(a: str, b: str, tag: str) -> None:
    for path in _files(tag):
        assert read_file(a + path) == read_file(b + path), path


def _names(path: str):
    lines = read_file(path).split(b"\n")
    step = 4 if path.endswith(".fastq") else 2
    return [n[1:].decode() for n in lines[0::step] if n]


@pytest.mark.parametrize("tag", ["plain", "fastq", "perfect", "hp", "abun_var"])
def test_metagenome_run_byte_identical(fx, jax_runs, tag):
    b = torch_run(fx, tag)
    assert_same_files(jax_runs(tag), b, tag)
    ext = ".fastq" if RUNS[tag][0].get("fastq") else ".fasta"
    names = _names(b + "_sample0_aligned_reads" + ext)
    assert len(names) >= 108
    assert all(n.split("-")[0] in fx.species for n in names)  # <species>-<chrom>_<pos>
    if tag == "perfect":
        assert all("_perfect_" in n for n in names)
        assert not os.path.exists(b + "_sample0_unaligned_reads" + ext)
        assert read_file(b + "_sample0_aligned_error_profile").count(b"\n") == 1
    else:
        assert read_file(b + "_sample0_aligned_error_profile").count(b"\n") > 100


@pytest.fixture(scope="module")
def torch_chimeric(fx):
    return torch_run(fx, "chimeric")


def test_metagenome_chimeric_run_byte_identical(fx, jax_runs, torch_chimeric):
    """Route A: the meta-only program with packed walk lanes and per-segment
    species, the part-keyed replays and emit_chimeric_recon on the host, the
    quota advanced one batch ahead of the emit."""
    assert_same_files(jax_runs("chimeric"), torch_chimeric, "chimeric")
    names = _names(torch_chimeric + "_sample0_aligned_reads.fastq")
    chi = [n for n in names if "_chimeric_" in n]
    assert len(chi) >= 20
    # segments are joined by gap components: <sp>-<chrom>_<pos>;gap_<len>;<sp>-...
    comps = chi[0].split("_aligned_")[0].split(";")
    assert comps[1].startswith("gap_") and comps[2].split("-")[0] in fx.species


def test_metagenome_chimeric_recon0_byte_identical(fx, jax_runs, torch_chimeric):
    """NANOSIM_TPU_RECON=0: the read-emitting program; its files equal the JAX
    run with the same variable and the port's own reconstruction route."""
    b = torch_run(fx, "chimeric_recon0")
    assert_same_files(jax_runs("chimeric_recon0"), b, "chimeric_recon0")
    assert_same_files(torch_chimeric, b, "chimeric")


def test_metagenome_forced_spill_byte_identical(fx, jax_runs):
    """NANOSIM_TPU_PACKED_CAP=8: every chimeric batch is re-run through the
    unpacked program with its species; the files do not change."""
    b = torch_run(fx, "chimeric", packed_cap=8, name="spill")
    assert tout.RUN_STATS.packed_spills > 0
    assert_same_files(jax_runs("chimeric"), b, "chimeric")


def test_species_share_of_bases(fx):
    """The JAX test's bound on the port's own files: each species' share of
    sample 0's aligned bases within 12 points of the abundance file."""
    b = torch_run(fx, "plain", name="share")
    want = {"Escherichia": 60, "Bacillus": 30, "Salmonella": 10}
    lines = read_file(b + "_sample0_aligned_reads.fasta").split(b"\n")
    bases = {k: 0 for k in want}
    for name, seq in zip(lines[0::2], lines[1::2]):
        bases[name[1:].decode().split("-")[0].split("_")[0]] += len(seq)
    total = sum(bases.values())
    for sp, pct in want.items():
        assert abs(100 * bases[sp] / total - pct) < 12, (sp, bases)


def test_metagenome_kill_and_resume(fx, tmp_path):
    """As tests/test_resume_modes.py: a chimeric run stopped after one batch
    and resumed from its checkpoint (slot cursor, accepted count, species base
    totals, host RNG state) equals the uninterrupted run, and both equal the
    JAX package's."""
    from nanosim_tpu.io.genome import MetagenomeSet as JSet
    from nanosim_tpu.profiles import profile as jprofile
    from nanosim_tpu.sim import output as jout
    from nanosim_tpu.sim.run_metagenome import MetagenomeSimulator as JSim
    from nanosim_tpu_torch.io.genome import MetagenomeSet as TSet
    from nanosim_tpu_torch.profiles import profile as tprofile

    abun = {"Escherichia_coli": 50.0, "Bacillus_subtilis": 35.0, "Salmonella_enterica": 15.0}
    quota, seed = 150, 11
    tset = TSet.from_genome_list(fx.glist, fx.dl)
    tprof = tprofile.load_profile(fx.prefix, mode="metagenome", chimeric=True)

    def writer_for(out_mod, mset, fa, er, append=False):
        fw = out_mod.FastxWriter(str(tmp_path / fa), False, append=append)
        el = out_mod.ErrorLogWriter(str(tmp_path / er), append=append)
        w = out_mod.ChimericBatchWriter(fw, el, species_names=mset.species_names,
                                        species_of_chrom=mset.species_of_chrom, metagenome=True)
        return fw, el, w

    def tsim():
        return trm.MetagenomeSimulator(tset, tprof, abun, chimeric=True, batch=BATCH,
                                       device="cpu")

    jset = JSet.from_genome_list(fx.glist, fx.dl)
    jsim = JSim(jset, jprofile.load_profile(fx.prefix, mode="metagenome", chimeric=True), abun,
                chimeric=True, batch=BATCH)
    fw, el, w = writer_for(jout, jset, "jax.fasta", "jax.err")
    assert jsim.run(quota, w, seed=seed) == quota
    fw.close(); el.close()

    fw, el, w = writer_for(tout, tset, "uni.fasta", "uni.err")
    assert tsim().run(quota, w, seed=seed) == quota
    fw.close(); el.close()

    state = str(tmp_path / "m.resume.json")
    fw, el, w = writer_for(tout, tset, "res.fasta", "res.err")
    got1 = tsim().run(quota, w, seed=seed, max_batches=1, resume_state=state)
    fw.close(); el.close()
    assert 0 < got1 < quota and os.path.exists(state)
    fw, el, w = writer_for(tout, tset, "res.fasta", "res.err", append=True)
    assert tsim().run(quota, w, seed=seed, resume_state=state) == quota
    fw.close(); el.close()
    for a, b in (("uni.fasta", "res.fasta"), ("uni.err", "res.err"),
                 ("jax.fasta", "uni.fasta"), ("jax.err", "uni.err")):
        assert filecmp.cmp(str(tmp_path / a), str(tmp_path / b), shallow=False), (a, b)


def test_simulate_metagenome_resume_skips_finished_samples(fx, jax_runs):
    """--resume on a run that finished: every sample is marked done and is
    skipped, the files stay as they were (the JAX run's)."""
    out = os.path.join(fx.d, "torch_resume", "sim")
    os.makedirs(os.path.dirname(out))
    tout.RUN_STATS.reset()
    first = trm.simulate_metagenome(fx.glist, fx.abun, fx.dl, fx.prefix, out, seed=SEED,
                                    batch=BATCH, resume=True, device="cpu")
    assert all(os.path.exists(f"{out}_{s}.resume_done") for s in SAMPLES)
    again = trm.simulate_metagenome(fx.glist, fx.abun, fx.dl, fx.prefix, out, seed=SEED,
                                    batch=BATCH, resume=True, device="cpu")
    assert set(again) == set(first)
    assert_same_files(jax_runs("plain"), out, "plain")


def test_cli_metagenome_byte_identical(fx, jax_runs, monkeypatch):
    """`simulate metagenome --chimeric --fastq` through the port's CLI (its
    simulate_metagenome asked for the CPU) equals the JAX package's run."""
    from nanosim_tpu_torch import cli

    out = os.path.join(fx.d, "torch_cli", "sim")
    monkeypatch.setattr(trm, "simulate_metagenome",
                        functools.partial(trm.simulate_metagenome, device="cpu"))
    cli.main(["metagenome", "-gl", fx.glist, "-a", fx.abun, "-dl", fx.dl, "-c", fx.prefix,
              "-o", out, "--seed", str(SEED), "--batch", str(BATCH), "--chimeric", "--fastq"])
    assert_same_files(jax_runs("chimeric"), out, "chimeric")


def test_reconstruction_route_never_falls_back(fx, monkeypatch):
    """Without the native replayers Route A raises; the JAX package would
    quietly take the read-emitting program."""
    from nanosim_tpu_torch.io import native

    monkeypatch.setattr(native.WalkReplayer, "available", property(lambda self: False))
    with pytest.raises(RuntimeError, match="native/fastwriter.cpp"):
        torch_run(fx, "chimeric", name="nolib")
