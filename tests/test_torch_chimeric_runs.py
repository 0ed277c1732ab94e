"""Whole `simulate genome --chimeric` runs of the port against the JAX
package, byte for byte: reads, qualities, the error profile and the unaligned
reads.

Linear DNA on the host-reconstruction route (FASTA and FASTQ), circular DNA
on the read-emitting route, linear DNA with NANOSIM_TPU_RECON=0 (against the
JAX run with the same variable, and against the port's own reconstruction
route), a run whose packed walk lanes spill on every batch, the CLI, and a
failed replay checksum.  The segment mean is 1.9, so that multi-segment reads
are common.  `--chimeric -hp -k 6` and the C++ chimeric reconstruction against
its numpy spec are in tests/test_torch_chimeric_hp_runs.py.
"""

import functools
import os

import pytest

from nanosim_tpu_torch.sim import output as tout
from nanosim_tpu_torch.sim import run as trun

from test_torch_common import (CHIMERIC_BATCH, CHIMERIC_N, CHIMERIC_SEED, assert_same_files,
                               chimeric_share, jax_chimeric_runs, make_chimeric_model, read_file,
                               torch_chimeric_run)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return make_chimeric_model(str(tmp_path_factory.mktemp("chiruns")))


@pytest.fixture(scope="module")
def jax_runs(model):
    return jax_chimeric_runs(model)


@pytest.mark.parametrize("fastq", [False, True], ids=["fasta", "fastq"])
def test_chimeric_linear_run_byte_identical(model, jax_runs, fastq):
    """Route A: the meta-only program with packed walks on the device, the
    part-keyed replays and emit_chimeric_recon on the host."""
    tag = "lin_fq" if fastq else "lin_fa"
    b = torch_chimeric_run(model, tag, fastq)
    assert_same_files(jax_runs(tag, fastq), b, fastq)
    assert tout.RUN_STATS.packed_spills == 0
    n_chi, n = chimeric_share(b, fastq)
    assert n > 100 and n_chi >= 0.3 * n  # not vacuous: many multi-segment reads
    assert b";" in read_file(b + "_aligned_error_profile")  # their segments are logged


def test_chimeric_circular_run_byte_identical(model, jax_runs):
    """Route B: the read-emitting program, the reads and the active segments'
    event rows moved to the host, emit_chimeric_batch."""
    b = torch_chimeric_run(model, "circ_fq", True, dna="circular")
    assert_same_files(jax_runs("circ_fq", True, dna="circular"), b, fastq=True)
    n_chi, n = chimeric_share(b, True)
    assert n_chi >= 0.3 * n


@pytest.fixture(scope="module")
def torch_recon0(model):
    return torch_chimeric_run(model, "recon0_fq", True, recon0=True)


def test_chimeric_recon0_byte_identical(model, jax_runs, torch_recon0):
    assert_same_files(jax_runs("recon0_fq", True, recon0=True), torch_recon0, fastq=True)


def test_chimeric_recon0_equals_the_reconstruction_route(model, torch_recon0):
    """Two routes, same bytes: the device-materialized reads (RECON=0) and the
    host's reconstruction of the meta-only program."""
    assert_same_files(torch_recon0, torch_chimeric_run(model, "recon1_fq", True), fastq=True)


def test_chimeric_forced_spill_byte_identical(model, jax_runs):
    """NANOSIM_TPU_PACKED_CAP=8: every batch exceeds the packed lane capacity
    and is re-run through the unpacked program; the files do not change."""
    b = torch_chimeric_run(model, "spill_fq", True, packed_cap=8)
    assert tout.RUN_STATS.packed_spills > 0
    assert "packed_spills" in tout.RUN_STATS.summary()
    assert_same_files(jax_runs("lin_fq", True), b, fastq=True)


def test_chimeric_run_cannot_be_resumed(model):
    """As in the JAX package, a chimeric run writes no checkpoint."""
    out = torch_chimeric_run(model, "noresume", False)
    assert not os.path.exists(out + "_aligned.resume.json")
    assert os.path.exists(out + "_aligned_reads.fasta")


def test_cli_chimeric_byte_identical(model, jax_runs, monkeypatch):
    """`simulate genome --chimeric --fastq` through the port's CLI (its
    simulate_genome asked for the CPU) equals the JAX package's run."""
    from nanosim_tpu_torch import cli

    d, prefix, lin, _ = model
    out = os.path.join(d, "torch_cli")
    monkeypatch.setattr(trun, "simulate_genome",
                        functools.partial(trun.simulate_genome, device="cpu"))
    cli.main(["genome", "-rg", lin, "-c", prefix, "-o", out, "-n", str(CHIMERIC_N),
              "--seed", str(CHIMERIC_SEED), "--batch", str(CHIMERIC_BATCH), "--chimeric",
              "--fastq"])
    assert_same_files(jax_runs("lin_fq", True), out, fastq=True)


def test_failed_replay_checksum_raises(model, monkeypatch):
    """A replay that disagrees with the device ends the run: no other route."""
    from nanosim_tpu_torch.io import native

    real = native.WalkReplayer.replay

    def corrupt(self, *a, **kw):
        ok = real(self, *a, **kw)
        ok[:] = False
        return ok

    monkeypatch.setattr(native.WalkReplayer, "replay", corrupt)
    with pytest.raises(RuntimeError, match="checksum"):
        torch_chimeric_run(model, "badreplay", False)
