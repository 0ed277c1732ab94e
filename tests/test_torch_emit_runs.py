"""Whole `simulate genome` runs through the port's read-emitting program
against the JAX package, byte for byte.

Circular DNA (FASTA and FASTQ, error profile and unaligned reads, on a
reference holding ambiguity codes, with reads crossing the origin), linear
DNA with NANOSIM_TPU_RECON=0, a forced overflow rescue and a killed and
resumed run: every file must equal the JAX package's for the same seed and
batch.  The port's NANOSIM_TPU_RECON=0 files must also equal its own
host-reconstruction route's.
"""

import os

import pytest

from nanosim_tpu.io.genome import PackedGenome as JGenome
from nanosim_tpu.profiles import profile as jprofile
from nanosim_tpu.sim import genome_mode as jgm
from nanosim_tpu.sim import output as jout
from nanosim_tpu.sim import run as jrun
from nanosim_tpu_torch.io.genome import PackedGenome as TGenome
from nanosim_tpu_torch.profiles import profile as tprofile
from nanosim_tpu_torch.sim import genome_mode as tgm
from nanosim_tpu_torch.sim import output as tout
from nanosim_tpu_torch.sim import run as trun

from test_torch_common import make_iupac_reference, make_model

SEED = 3
BATCH = 64
N = 300
CIRC_LEN = 20000
FILES = ("_aligned_reads", "_aligned_error_profile", "_unaligned_reads")


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("emitruns"))
    prefix = make_model(d, mean_read_len=500, sd_read_len=150)
    circ = os.path.join(d, "circ.fa")
    make_iupac_reference(circ, [CIRC_LEN], seed=5)
    lin = os.path.join(d, "lin.fa")
    make_iupac_reference(lin, [40000, 30000], seed=6)
    return d, prefix, circ, lin


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _assert_same_files(a, b, fastq):
    ext = ".fastq" if fastq else ".fasta"
    for suf in FILES:
        path = suf if suf.endswith("profile") else suf + ext
        assert _read(a + path) == _read(b + path), path


@pytest.fixture(scope="module")
def jax_runs(model):
    """The JAX package's whole runs, each made once per module."""
    d, prefix, circ, lin = model
    done = {}

    def get(tag, ref, fastq, dna, recon0=False):
        if tag not in done:
            out = os.path.join(d, "jax_" + tag)
            with pytest.MonkeyPatch.context() as mp:
                if recon0:
                    mp.setenv("NANOSIM_TPU_RECON", "0")
                jrun.simulate_genome(ref, prefix, out, N, seed=SEED, batch=BATCH, fastq=fastq,
                                     dna_type=dna)
            done[tag] = out
        return done[tag]

    return get


def _crossing_reads(path, genome_len):
    """Aligned reads whose reference span passes the origin (from the
    `<chrom>_<pos>_aligned_<idx>_<F|R>_<head>_<middle>_<tail>` names)."""
    n = 0
    with open(path) as f:
        for line in f:
            if line[0] in ">@" and "_aligned_" in line:
                pos = int(line[1:].split("_aligned_")[0].rsplit("_", 1)[1])
                middle = int(line.split("_")[-2])
                n += pos + middle > genome_len
    return n


@pytest.mark.parametrize("fastq", [False, True])
def test_circular_run_byte_identical(model, jax_runs, fastq):
    d, prefix, circ, _ = model
    a = jax_runs("circ_fq" if fastq else "circ_fa", circ, fastq, "circular")
    b = os.path.join(d, "torch_circ_" + ("fq" if fastq else "fa"))
    tout.RUN_STATS.reset()
    counts = trun.simulate_genome(circ, prefix, b, N, seed=SEED, batch=BATCH, fastq=fastq,
                                  dna_type="circular", device="cpu")
    assert counts["unaligned"] > 0
    assert tout.RUN_STATS.checksum_fallback_lanes == 0
    _assert_same_files(a, b, fastq)
    assert _crossing_reads(b + ("_aligned_reads.fastq" if fastq else "_aligned_reads.fasta"),
                           CIRC_LEN) > 0


def test_circular_needs_one_chromosome(model):
    d, prefix, _, lin = model
    with pytest.raises(ValueError, match="more than one chromosome"):
        trun.simulate_genome(lin, prefix, os.path.join(d, "x"), 10, dna_type="circular",
                             device="cpu")


@pytest.fixture(scope="module")
def torch_recon0(model):
    d, prefix, _, lin = model
    out = os.path.join(d, "torch_recon0")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NANOSIM_TPU_RECON", "0")
        trun.simulate_genome(lin, prefix, out, N, seed=SEED, batch=BATCH, fastq=True,
                             device="cpu")
    return out


def test_recon0_linear_fastq_byte_identical(model, jax_runs, torch_recon0):
    _, _, _, lin = model
    a = jax_runs("recon0_fq", lin, True, "linear", recon0=True)
    _assert_same_files(a, torch_recon0, fastq=True)


def test_recon0_equals_the_reconstruction_route(model, torch_recon0):
    """Two routes, same bytes: device-materialized reads (RECON=0) and the
    host reconstruction of the meta-only program."""
    d, prefix, _, lin = model
    out = os.path.join(d, "torch_recon1")
    trun.simulate_genome(lin, prefix, out, N, seed=SEED, batch=BATCH, fastq=True, device="cpu")
    _assert_same_files(torch_recon0, out, fastq=True)


def _run_aligned(sim, out_mod, path, n, **kw):
    fw = out_mod.FastxWriter(path + "_aligned_reads.fasta", False)
    el = out_mod.ErrorLogWriter(path + "_aligned_error_profile", header=True)
    got = sim.run(n, out_mod.GenomeBatchWriter(fw, el), seed=SEED, **kw)
    fw.close()
    el.close()
    return got


def test_circular_overflow_rescue_byte_identical(model):
    """A lean event budget of 16 makes many lanes overflow; both packages
    re-run them through the read-emitting program at the full budget."""
    d, prefix, circ, _ = model
    js = jgm.GenomeSimulator(JGenome.from_fasta(circ, dna_type="circular"),
                             jprofile.load_profile(prefix, mode="genome"),
                             circular_dna=True, batch=BATCH)
    ts = tgm.GenomeSimulator(TGenome.from_fasta(circ, dna_type="circular"),
                             tprofile.load_profile(prefix, mode="genome"),
                             circular_dna=True, batch=BATCH, device="cpu")
    js.e_max = ts.e_max = 16
    a, b = os.path.join(d, "jax_circ_rescue"), os.path.join(d, "torch_circ_rescue")
    jout.RUN_STATS.reset()
    tout.RUN_STATS.reset()
    assert _run_aligned(js, jout, a, 150) == _run_aligned(ts, tout, b, 150) == 150
    assert tout.RUN_STATS.overflow_rescue_lanes > 0
    assert tout.RUN_STATS.overflow_rescue_lanes == jout.RUN_STATS.overflow_rescue_lanes
    assert tout.RUN_STATS.checksum_fallback_lanes == 0
    for suf in ("_aligned_reads.fasta", "_aligned_error_profile"):
        assert _read(a + suf) == _read(b + suf), suf


def test_circular_kill_and_resume_byte_identical(model, jax_runs):
    """A circular aligned pass stopped after two batches, then
    `simulate_genome(..., resume=True)`: the files equal one uninterrupted
    JAX run, unaligned pass included."""
    d, prefix, circ, _ = model
    a = jax_runs("circ_fa", circ, False, "circular")
    b = os.path.join(d, "torch_circ_resumed")
    ts = tgm.GenomeSimulator(TGenome.from_fasta(circ, dna_type="circular"),
                             tprofile.load_profile(prefix, mode="genome"),
                             circular_dna=True, batch=BATCH, device="cpu")
    state = b + "_aligned.resume.json"  # simulate_genome's checkpoint path
    first = _run_aligned(ts, tout, b, N - 30, max_batches=2, resume_state=state)
    assert 0 < first < N - 30 and os.path.exists(state)
    trun.simulate_genome(circ, prefix, b, N, seed=SEED, batch=BATCH, resume=True,
                         dna_type="circular", device="cpu")
    _assert_same_files(a, b, fastq=False)
