"""`-x` coverage: the read count for a requested coverage against the JAX
package's, and the CLI's use of it for genome and transcriptome runs.

The count is the reference size over a Monte Carlo mean read length (10
million draws from the model's aligned and unaligned length KDEs, numpy's
generator seeded with 0), times the coverage: an integer, which must equal
`nanosim_tpu.sim.run.calculate_read_number_from_coverage` exactly.
"""

import os

import pytest

from nanosim_tpu.profiles import fixtures as jfixtures
from nanosim_tpu.sim import run as jrun
from nanosim_tpu_torch import cli
from nanosim_tpu_torch.sim import run as trun
from nanosim_tpu_torch.sim import run_transcriptome as trun_trx

from test_torch_common import make_model

COVERAGE = 7.5


@pytest.fixture(scope="module")
def fixtures_(tmp_path_factory):
    """(model prefix, reference) for a genome and for a transcriptome."""
    d = str(tmp_path_factory.mktemp("coverage"))
    genome_prefix = make_model(os.path.join(d, "g"), mean_read_len=500, sd_read_len=150)
    ref = os.path.join(d, "ref.fa")
    jfixtures.make_reference_fasta(ref, [40000, 30000], seed=6)
    trx_prefix = make_model(os.path.join(d, "t"), mean_read_len=700, sd_read_len=200,
                            transcriptome=True, mean_2d_ref_len=1500)
    trx = os.path.join(d, "trx.fa")
    jfixtures.make_transcript_reference(trx, n_transcripts=25, mean_len=1800, seed=2)
    return {"genome": (genome_prefix, ref), "transcriptome": (trx_prefix, trx)}


@pytest.mark.parametrize("mode", ["genome", "transcriptome"])
def test_read_number_from_coverage_equals_jax(fixtures_, mode):
    prefix, ref = fixtures_[mode]
    want = jrun.calculate_read_number_from_coverage(ref, prefix, COVERAGE)
    got = trun.calculate_read_number_from_coverage(ref, prefix, COVERAGE)
    assert isinstance(got, int) and got == want and got > 0


@pytest.mark.parametrize("mode", ["genome", "transcriptome"])
def test_cli_runs_coverage(fixtures_, mode, tmp_path, monkeypatch):
    """`simulate <mode> -x` asks the simulator for the coverage's read
    count in place of `-n`."""
    prefix, ref = fixtures_[mode]
    calls = []
    module, name = (trun, "simulate_genome") if mode == "genome" else (
        trun_trx, "simulate_transcriptome")
    monkeypatch.setattr(module, name, lambda *a, **kw: calls.append(a))
    out = str(tmp_path / "out")
    if mode == "genome":
        cli.main(["genome", "-rg", ref, "-c", prefix, "-o", out, "-n", "10", "-x",
                  str(COVERAGE)])
        number = calls[0][3]
    else:
        cli.main(["transcriptome", "-rt", ref, "-e", "exp.tsv", "-c", prefix, "--no_model_ir",
                  "-o", out, "-n", "10", "-x", str(COVERAGE)])
        number = calls[0][5]
    assert number == jrun.calculate_read_number_from_coverage(ref, prefix, COVERAGE)
    assert number != 10
