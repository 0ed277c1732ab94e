"""The JAX package's length-bucketed genome schedule against the port, byte
for byte, on the CPU.

The JAX package's schedule (`GenomeSimulator.run(..., bucketed=True)`,
NANOSIM_TPU_BUCKETED=1) routes each slot by its drawn length to a small or
the full bucket and merges the accepted lanes in slot order, so it writes
the flat schedule's files.  The port has the flat schedule only: its files
must equal the JAX package's bucketed files.  The
heavy-tailed fixture is tests/test_genome_sim.py's (two buckets); the default
one is tests/test_torch_genome.py's.
"""

import os

import pytest

from nanosim_tpu.io.genome import PackedGenome as JGenome
from nanosim_tpu.profiles import profile as jprofile
from nanosim_tpu.sim import genome_mode as jgm
from nanosim_tpu.sim import output as jout
from nanosim_tpu_torch.io.genome import PackedGenome as TGenome
from nanosim_tpu_torch.profiles import fixtures as tfix
from nanosim_tpu_torch.profiles import profile as tprofile
from nanosim_tpu_torch.sim import genome_mode as tgm
from nanosim_tpu_torch.sim import output as tout

from test_torch_common import make_model

SEED = 11
BATCH = 64
N = 200


@pytest.fixture(scope="module")
def heavy(tmp_path_factory):
    """tests/test_genome_sim.py's heavy-tailed fixture, its reference written
    with homopolymer runs for `-hp -k 6`."""
    d = str(tmp_path_factory.mktemp("bucketed"))
    prefix = os.path.join(d, "training")
    tfix.make_model_dir(prefix, mean_read_len=2000, sd_read_len=1500, n_kde_points=400)
    ref = os.path.join(d, "ref.fa")
    tfix.make_reference_fasta(ref, [300000, 200000], seed=9, hp_bias=0.5)
    return d, prefix, ref


@pytest.fixture(scope="module")
def default(tmp_path_factory):
    """tests/test_torch_genome.py's fixture."""
    d = str(tmp_path_factory.mktemp("bucketed_default"))
    prefix = make_model(d, mean_read_len=500, sd_read_len=150)
    ref = os.path.join(d, "ref.fa")
    tfix.make_reference_fasta(ref, [60000, 40000], seed=5)
    return d, prefix, ref


def _sims(fx, fastq=False, kmer_bias=None):
    _, prefix, ref = fx
    hp = kmer_bias is not None
    js = jgm.GenomeSimulator(
        JGenome.from_fasta(ref),
        jprofile.load_profile(prefix, mode="genome", fastq=fastq, homopolymer=hp),
        fastq=fastq, batch=BATCH, kmer_bias=kmer_bias)
    ts = tgm.GenomeSimulator(
        TGenome.from_fasta(ref),
        tprofile.load_profile(prefix, mode="genome", fastq=fastq, homopolymer=hp),
        fastq=fastq, batch=BATCH, kmer_bias=kmer_bias, device="cpu")
    return js, ts


def _run(sim, out_mod, path, **kw):
    fw = out_mod.FastxWriter(path + ".fq", sim.fastq)
    el = out_mod.ErrorLogWriter(path + ".err")
    got = sim.run(N, out_mod.GenomeBatchWriter(fw, el), seed=SEED, **kw)
    fw.close()
    el.close()
    return got


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _assert_same(a, b):
    for ext in (".fq", ".err"):
        assert _read(a + ext) == _read(b + ext), ext


CASES = {
    "fastq": ({"fastq": True}, {}),  # the main path's configuration
    "hp": ({"kmer_bias": 6}, {}),
    "recon0": ({}, {"NANOSIM_TPU_RECON": "0"}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bucketed_equals_jax_and_flat(heavy, monkeypatch, case):
    """Two buckets in the JAX package: its bucketed files equal the port's
    run, which is the flat schedule."""
    kw, env = CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    d = heavy[0]
    js, ts = _sims(heavy, **kw)
    assert len(js.plan_buckets()) == 2
    a, b = (os.path.join(d, f"{case}_{t}") for t in ("jax", "torch"))
    tout.RUN_STATS.reset()
    assert _run(js, jout, a, bucketed=True) == _run(ts, tout, b) == N
    assert tout.RUN_STATS.checksum_fallback_lanes == 0
    _assert_same(a, b)


def test_bucketed_default_fixture(default, monkeypatch):
    """The default fixture through NANOSIM_TPU_BUCKETED=1: the port's files
    equal the JAX package's, whatever its plan_buckets gives there."""
    d = default[0]
    js, ts = _sims(default)
    monkeypatch.setenv("NANOSIM_TPU_BUCKETED", "1")
    a, b = os.path.join(d, "env_jax"), os.path.join(d, "env_torch")
    assert _run(js, jout, a) == _run(ts, tout, b) == N
    _assert_same(a, b)
