"""Whole `-med/-sd` runs (lognormal read lengths) against the JAX package,
byte for byte.

Genome runs on both routes: linear DNA on the host-reconstruction route
(FASTA, FASTQ, `--perfect`) and with NANOSIM_TPU_RECON=0, and circular DNA on
a reference with ambiguity codes, each with its unaligned pass (but for
perfect reads, which have none); a spread wide enough (`-med 5000 -sd 6`)
that some draws of both passes pass 2**31 before their int32 conversion,
with `--min_len 0`, so that a lane whose length converted to 0 instead of
saturating would be written as an empty unaligned read; and a non-chimeric
two-sample metagenome.  Every file must equal the JAX package's for the same
seed and batch.
"""

import os

import pytest
import torch

from nanosim_tpu.sim import run as jrun
from nanosim_tpu_torch.ops import rng as trng
from nanosim_tpu_torch.sim import genome_mode as tgm
from nanosim_tpu_torch.sim import output as tout
from nanosim_tpu_torch.sim import run as trun

from test_torch_common import (assert_same_files, make_iupac_reference, make_metagenome_fixture,
                               make_model, read_file)

SEED = 3
BATCH = 64
N = 200
MEDIAN, SD = 450, 0.3  # about the model's KDE lengths (mean 500, sd 150)
RUNS = {  # tag -> (simulate_genome keywords, NANOSIM_TPU_RECON=0)
    "fasta": (dict(), False),
    "fastq": (dict(fastq=True), False),
    "recon0": (dict(fastq=True), True),
    "perfect": (dict(perfect=True), False),
    "circular": (dict(fastq=True, dna_type="circular"), False),
}
BIG_SD = dict(median_len=5000, sd_len=6.0, min_len=0, fastq=True, batch=256)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("lognormalruns"))
    prefix = make_model(d, mean_read_len=500, sd_read_len=150)
    lin = os.path.join(d, "lin.fa")
    make_iupac_reference(lin, [40000, 30000], seed=6)
    circ = os.path.join(d, "circ.fa")
    make_iupac_reference(circ, [20000], seed=5)
    return d, prefix, lin, circ


def _run(simulate, model, tag, kw, recon0, **extra):
    d, prefix, lin, circ = model
    out = os.path.join(d, tag)
    ref = circ if kw.get("dna_type") == "circular" else lin
    with pytest.MonkeyPatch.context() as mp:
        if recon0:
            mp.setenv("NANOSIM_TPU_RECON", "0")
        simulate(ref, prefix, out, N, seed=SEED, **{"batch": BATCH, **kw}, **extra)
    return out


def _assert_same(a, b, kw):
    if kw.get("perfect"):  # no unaligned pass
        for suf in ("_aligned_reads.fasta", "_aligned_error_profile"):
            assert read_file(a + suf) == read_file(b + suf), suf
    else:
        assert_same_files(a, b, kw.get("fastq", False))


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_lognormal_genome_run_byte_identical(model, tag):
    kw, recon0 = RUNS[tag]
    kw = dict(kw, median_len=MEDIAN, sd_len=SD)
    want = _run(jrun.simulate_genome, model, "jax_" + tag, kw, recon0)
    tout.RUN_STATS.reset()
    got = _run(trun.simulate_genome, model, "torch_" + tag, kw, recon0, device="cpu")
    assert tout.RUN_STATS.checksum_fallback_lanes == 0
    _assert_same(want, got, kw)
    ext = ".fastq" if kw.get("fastq") else ".fasta"
    assert read_file(got + "_aligned_reads" + ext).count(b"_aligned_" if not kw.get(
        "perfect") else b"_perfect_") > N // 2


def test_lognormal_draws_past_int32_byte_identical(model):
    """-med 5000 -sd 6: z > 2.2 puts a draw past 2**31 (about 1.5% of them).
    Both passes' first batch holds such draws, and the files equal the JAX
    package's, also with --min_len 0."""
    for stream, perfect in ((trng.STREAM_ALIGNED, False), (trng.STREAM_UNALIGNED, True)):
        sk = trng.slot_keys(trng.base_key(SEED, stream, device="cpu"),
                            torch.arange(BIG_SD["batch"], dtype=torch.int64))
        draws = tgm.lognormal_len(sk, BIG_SD["median_len"], BIG_SD["sd_len"], perfect)
        assert int((draws >= 2.0**31).sum()) > 0, stream
    want = _run(jrun.simulate_genome, model, "jax_bigsd", BIG_SD, False)
    got = _run(trun.simulate_genome, model, "torch_bigsd", BIG_SD, False, device="cpu")
    assert_same_files(want, got, True)


def test_lognormal_metagenome_run_byte_identical(tmp_path):
    """A non-chimeric metagenome (three species, two samples) with -med/-sd:
    each sample's aligned reads, error profile and unaligned reads."""
    from nanosim_tpu.sim.run_metagenome import simulate_metagenome as jsim
    from nanosim_tpu_torch.sim.run_metagenome import simulate_metagenome as tsim

    fx = make_metagenome_fixture(str(tmp_path))
    kw = dict(seed=SEED, batch=BATCH, fastq=True, median_len=MEDIAN, sd_len=SD)
    outs = {}
    for name, sim, extra in (("jax", jsim, {}), ("torch", tsim, {"device": "cpu"})):
        outs[name] = os.path.join(fx.d, name, "sim")
        os.makedirs(os.path.dirname(outs[name]))
        sim(fx.glist, fx.abun, fx.dl, fx.prefix, outs[name], **kw, **extra)
    for sample in ("sample0", "sample1"):
        for suf in ("_aligned_reads.fastq", "_aligned_error_profile", "_unaligned_reads.fastq"):
            path = f"_{sample}{suf}"
            assert read_file(outs["jax"] + path) == read_file(outs["torch"] + path), path
        reads = read_file(outs["torch"] + f"_{sample}_aligned_reads.fastq")
        assert reads.count(b"\n+\n") > 20 and b";" not in reads.split(b"\n", 1)[0]
