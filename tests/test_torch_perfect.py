"""Whole `simulate genome --perfect` runs of the port against the JAX package,
byte for byte: reads, qualities and the (event-free) error profile.

Linear DNA on the host-reconstruction route (FASTA and FASTQ, a reference
with IUPAC codes), circular DNA (the fused read-emitting program), linear DNA
with NANOSIM_TPU_RECON=0 (against the JAX run with the same variable, and
against the port's own reconstruction route), `-hp -k 6 --perfect` on both
routes (no run is resized: the read-emitting program assembles the
extraction), and the CLI.  Perfect reads have no unaligned pass.
"""

import functools
import os

import pytest

from nanosim_tpu.profiles import fixtures as jfixtures
from nanosim_tpu.sim import run as jrun
from nanosim_tpu_torch.sim import output as tout
from nanosim_tpu_torch.sim import run as trun

from test_torch_common import make_iupac_reference, make_model, read_file

SEED = 4
BATCH = 64
N = 200
K = 6

# id -> (reference, dna_type, fastq, kmer_bias, NANOSIM_TPU_RECON=0)
CASES = {
    "linear-fasta": ("lin", "linear", False, None, False),
    "linear-fastq": ("lin", "linear", True, None, False),
    "circular": ("circ", "circular", True, None, False),
    "recon0": ("lin", "linear", True, None, True),
    "hp-linear": ("hp", "linear", True, K, False),
    "hp-circular": ("circ", "circular", True, K, False),
}


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("perfect"))
    prefix = make_model(d, mean_read_len=500, sd_read_len=150)
    refs = {k: os.path.join(d, k + ".fa") for k in ("lin", "hp", "circ")}
    make_iupac_reference(refs["lin"], [40000, 30000], seed=21)
    jfixtures.make_reference_fasta(refs["hp"], [40000, 30000], seed=17, hp_bias=0.6)
    jfixtures.make_reference_fasta(refs["circ"], [20000], seed=18, hp_bias=0.6)
    return d, prefix, refs


def _files(fastq):
    return ("_aligned_reads" + (".fastq" if fastq else ".fasta"), "_aligned_error_profile")


def _assert_same(a, b, fastq):
    for suf in _files(fastq):
        assert read_file(a + suf) == read_file(b + suf), suf
    assert not os.path.exists(b + "_unaligned_reads" + (".fastq" if fastq else ".fasta"))


def _kw(model, case):
    _, prefix, refs = model
    ref, dna, fastq, k, _ = CASES[case]
    return (refs[ref], prefix), dict(number=N, seed=SEED, batch=BATCH, fastq=fastq,
                                     dna_type=dna, kmer_bias=k, perfect=True)


@pytest.fixture(scope="module")
def jax_runs(model):
    """get(case) -> output prefix of the JAX package's run, each made once."""
    done = {}

    def get(case):
        if case not in done:
            args, kw = _kw(model, case)
            out = os.path.join(model[0], "jax_" + case)
            with pytest.MonkeyPatch.context() as mp:
                if CASES[case][4]:
                    mp.setenv("NANOSIM_TPU_RECON", "0")
                jrun.simulate_genome(*args, out, homopolymer=kw["kmer_bias"] is not None, **kw)
            done[case] = out
        return done[case]

    return get


def _torch_run(model, case, tag, recon0=None):
    args, kw = _kw(model, case)
    out = os.path.join(model[0], "torch_" + tag)
    tout.RUN_STATS.reset()
    with pytest.MonkeyPatch.context() as mp:
        if CASES[case][4] if recon0 is None else recon0:
            mp.setenv("NANOSIM_TPU_RECON", "0")
        counts = trun.simulate_genome(*args, out, device="cpu", **kw)
    assert counts == {"aligned": N, "unaligned": 0}
    assert tout.RUN_STATS.checksum_fallback_lanes == 0
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_perfect_run_byte_identical(model, jax_runs, case):
    fastq = CASES[case][2]
    b = _torch_run(model, case, case)
    _assert_same(jax_runs(case), b, fastq)
    reads, log = (read_file(b + s) for s in _files(fastq))
    # not vacuous: every read is a perfect one and no event is logged
    assert reads.count(b"_perfect_") == N and b"_aligned_" not in reads
    assert log.count(b"\n") == 1


@pytest.mark.parametrize("case", ["recon0", "hp-linear"])
def test_perfect_routes_agree(model, case):
    """The read-emitting program (RECON=0) and the host reconstruction of the
    meta-only program give the same files, with and without `-hp`."""
    a = _torch_run(model, case, case + "_route_a", recon0=False)
    b = _torch_run(model, case, case + "_route_b", recon0=True)
    _assert_same(a, b, fastq=True)


def test_cli_perfect_byte_identical(model, jax_runs, monkeypatch):
    """`simulate genome --perfect` through the port's CLI (its simulate_genome
    asked for the CPU) equals the JAX package's run."""
    from nanosim_tpu_torch import cli

    _, prefix, refs = model
    out = os.path.join(model[0], "torch_cli")
    monkeypatch.setattr(trun, "simulate_genome",
                        functools.partial(trun.simulate_genome, device="cpu"))
    cli.main(["genome", "-rg", refs["lin"], "-c", prefix, "-o", out, "-n", str(N),
              "--seed", str(SEED), "--batch", str(BATCH), "--perfect", "--fastq"])
    _assert_same(jax_runs("linear-fastq"), out, True)
