"""Whole `simulate transcriptome` runs of the port against the JAX package,
byte for byte: reads, qualities, the error profile and the unaligned reads.

cDNA with polyA tails (FASTA), direct RNA (uracil, FASTQ), intron retention
(on both routes, and on '-' strand structures, where the JAX package's two
routes disagree with each other: the port follows each), `--perfect`, `-hp -k
6`, NANOSIM_TPU_RECON=0 against the JAX run with the same variable and
against the port's own reconstruction route, a resumed run, and the CLI.
The fixtures are like tests/test_transcriptome.py's: 25 transcripts, up to
200 reads, batches of 64 and 128.
"""

import functools
import os

import numpy as np
import pytest

from nanosim_tpu_torch.sim import output as tout
from nanosim_tpu_torch.sim import run_transcriptome as trt

from test_torch_common import read_file

SEED = 5
FILES = ("_aligned_reads", "_aligned_error_profile", "_unaligned_reads")


def _same(a: str, b: str, fastq: bool, files=FILES) -> None:
    ext = ".fastq" if fastq else ".fasta"
    for suf in files:
        path = suf if suf.endswith("profile") else suf + ext
        if not os.path.exists(a + path):
            assert not os.path.exists(b + path), path
            continue
        assert read_file(a + path) == read_file(b + path), path


def _flip_strands(gff: str, names) -> str:
    """A copy of the structures with those of `names` on the '-' strand."""
    out = []
    with open(gff) as f:
        for line in f:
            c = line.rstrip("\n").split("\t")
            if len(c) >= 9 and c[8].split("=")[-1] in names:
                c[6] = "-"
            out.append("\t".join(c))
    with open(gff, "w") as f:
        f.write("\n".join(out) + "\n")
    return gff


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    """The model of tests/test_transcriptome.py (with homopolymer parameters
    and a retaining IR Markov table), 25 transcripts, expression and polyA
    lists; a transcriptome with long homopolymer runs for `-hp`; two
    intron-retention fixtures, one with '-' strand structures."""
    from nanosim_tpu.profiles import error_model, fixtures

    d = str(tmp_path_factory.mktemp("trxruns"))
    prefix = os.path.join(d, "training")
    fixtures.make_model_dir(prefix, mean_read_len=700, sd_read_len=200, transcriptome=True,
                            mean_2d_ref_len=1500)
    error_model.write_ir_markov(prefix + "_IR_markov_model",
                                np.array([[0.5, 0.5], [0.5, 0.5], [0.3, 0.7]]))
    trx_fa = os.path.join(d, "trx.fa")
    trxs = fixtures.make_transcript_reference(trx_fa, n_transcripts=25, mean_len=1800, seed=3)
    exp = os.path.join(d, "exp.tsv")
    fixtures.make_expression_tsv(exp, trxs, seed=4)
    polya = os.path.join(d, "polya.txt")
    with open(polya, "w") as f:
        f.write("".join(name + "\n" for name, _ in trxs[:10]))
    hp_fa = os.path.join(d, "hp_trx.fa")
    fixtures.make_reference_fasta(hp_fa, [n for _, n in trxs], seed=9, name_prefix="ENST",
                                  hp_bias=0.5)
    hp_exp = os.path.join(d, "hp_exp.tsv")
    fixtures.make_expression_tsv(hp_exp, [(f"ENST{i + 1}", n) for i, (_, n) in enumerate(trxs)],
                                 seed=4)
    ir = {}
    for tag, flip in (("plus", False), ("minus", True)):
        ird = os.path.join(d, "ir_" + tag)
        genome_fa, ir_trx, gff, ir_trxs = fixtures.make_ir_fixture(ird, n_transcripts=10, seed=7)
        if flip:
            _flip_strands(gff, {ir_trxs[i][0] for i in (1, 4, 6)})
        ir_exp = os.path.join(ird, "exp.tsv")
        fixtures.make_expression_tsv(ir_exp, ir_trxs, seed=8)
        ir_prefix = os.path.join(ird, "training")  # beside the structures' GFF3
        fixtures.make_model_dir(ir_prefix, mean_read_len=700, sd_read_len=200,
                                transcriptome=True, mean_2d_ref_len=1500)
        error_model.write_ir_markov(ir_prefix + "_IR_markov_model",
                                    np.array([[0.5, 0.5], [0.5, 0.5], [0.3, 0.7]]))
        ir[tag] = (ir_prefix, ir_trx, genome_fa, ir_exp)
    return dict(d=d, prefix=prefix, trx=trx_fa, exp=exp, polya=polya, hp_trx=hp_fa,
                hp_exp=hp_exp, ir=ir)


RUNS = {  # id -> (source, n, batch, fastq, options)
    "cdna": ("plain", 200, 128, False, dict(model_ir=False, polya="polya", basecaller="guppy")),
    "drna": ("plain", 100, 64, True, dict(model_ir=False, uracil=True, polya="polya",
                                          basecaller="guppy")),
    "perfect": ("plain", 100, 64, True, dict(model_ir=False, perfect=True)),
    "hp": ("hp", 100, 64, True, dict(model_ir=False, kmer_bias=6, homopolymer=True)),
    "ir": ("plus", 150, 128, True, dict(model_ir=True)),
    "ir_minus": ("minus", 150, 128, True, dict(model_ir=True)),
}


def _args(fx, run):
    source, n, batch, fastq, opts = RUNS[run]
    opts = dict(opts)
    if opts.get("polya"):
        opts["polya"] = fx["polya"]
    if source == "plain":
        args = (fx["trx"], "", fx["exp"], fx["prefix"])
    elif source == "hp":
        args = (fx["hp_trx"], "", fx["hp_exp"], fx["prefix"])
    else:
        prefix, trx, genome, exp = fx["ir"][source]
        args = (trx, genome, exp, prefix)
    return args, dict(number=n, batch=batch, fastq=fastq, seed=SEED, **opts)


@pytest.fixture(scope="module")
def jax_runs(fx):
    """get(run, recon0) -> output prefix of the JAX package's run, each made
    once."""
    from nanosim_tpu.sim.run_transcriptome import simulate_transcriptome

    done = {}

    def get(run, recon0=False):
        key = (run, recon0)
        if key not in done:
            args, kw = _args(fx, run)
            out = os.path.join(fx["d"], f"jax_{run}{'_r0' if recon0 else ''}")
            with pytest.MonkeyPatch.context() as mp:
                if recon0:
                    mp.setenv("NANOSIM_TPU_RECON", "0")
                simulate_transcriptome(*args, out, **kw)
            done[key] = out
        return done[key]

    return get


def torch_run(fx, run, tag, recon0=False) -> str:
    args, kw = _args(fx, run)
    out = os.path.join(fx["d"], "torch_" + tag)
    tout.RUN_STATS.reset()
    with pytest.MonkeyPatch.context() as mp:
        if recon0:
            mp.setenv("NANOSIM_TPU_RECON", "0")
        counts = trt.simulate_transcriptome(*args, out, device="cpu", **kw)
    assert counts["aligned"] > 0
    assert tout.RUN_STATS.checksum_fallback_lanes == 0
    return out


@pytest.mark.parametrize("run", ["cdna", "drna", "perfect", "hp", "ir"])
def test_transcriptome_run_byte_identical(fx, jax_runs, run):
    """Route A for cDNA, direct RNA, --perfect and intron retention (the
    meta-only program, the C++ replay, emit_trx_recon); Route B for -hp (the
    read-emitting program and the Python log)."""
    b = torch_run(fx, run, run)
    fastq = RUNS[run][3]
    _same(jax_runs(run), b, fastq)
    ext = ".fastq" if fastq else ".fasta"
    reads = read_file(b + "_aligned_reads" + ext)
    if run == "drna":  # not vacuous: U for T on both passes
        assert b"U" in reads and b"T" not in reads.split(b"\n")[1]
        assert b"U" in read_file(b + "_unaligned_reads.fastq")
    if run == "ir":
        assert reads.count(b"_RetainedIntron_") > 10
    if run == "perfect":
        assert b"_perfect_" in reads and not os.path.exists(b + "_unaligned_reads.fastq")
    if run == "cdna":  # polyA tails: a tail field past the head/tail draws
        assert read_file(b + "_aligned_error_profile").count(b"\n") > 100


@pytest.mark.parametrize("run", ["cdna", "ir"])
def test_recon0_byte_identical_and_equal_to_route_a(fx, jax_runs, run):
    """NANOSIM_TPU_RECON=0: the read-emitting program's files equal the JAX
    run with the same variable, and the port's own reconstruction route."""
    b = torch_run(fx, run, run + "_r0", recon0=True)
    fastq = RUNS[run][3]
    _same(jax_runs(run, recon0=True), b, fastq)
    _same(torch_run(fx, run, run + "_r1"), b, fastq)


def test_minus_strand_intron_retention_follows_each_jax_route(fx, jax_runs):
    """On '-' strand structures the JAX package's reconstruction route
    concatenates the retained-intron intervals without the reverse
    complement that its read-emitting program (and the reference,
    simulator.py:1177-1178) applies, so its two routes write different
    reads.  The port equals the JAX package on each route."""
    a = torch_run(fx, "ir_minus", "irm_r1")
    b = torch_run(fx, "ir_minus", "irm_r0", recon0=True)
    _same(jax_runs("ir_minus"), a, True)
    _same(jax_runs("ir_minus", recon0=True), b, True)
    assert read_file(a + "_aligned_reads.fastq") != read_file(b + "_aligned_reads.fastq")


def test_kill_and_resume_byte_identical(fx, jax_runs):
    """An aligned pass stopped after one batch, then
    `simulate_transcriptome(..., resume=True)` (the CLI's --resume): the
    files equal one uninterrupted JAX run, unaligned pass included."""
    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.profiles import profile

    args, kw = _args(fx, "cdna")
    b = os.path.join(fx["d"], "torch_resumed")
    trx = PackedGenome.from_fasta(args[0])
    prof = profile.load_profile(args[3], mode="transcriptome", polya_path=fx["polya"])
    expr = profile.load_expression(args[2], dict(zip(trx.names, (int(x) for x in trx.lengths))))
    sim = trt.TranscriptomeSimulator(trx, prof, expr, polya_scale=trt.POLYA_SCALE["guppy"],
                                     batch=kw["batch"], device="cpu")
    fw = tout.FastxWriter(b + "_aligned_reads.fasta", False)
    el = tout.ErrorLogWriter(b + "_aligned_error_profile", header=True)
    state = b + "_aligned.resume.json"  # simulate_transcriptome's checkpoint path
    n_aligned = 180  # the split of 200 reads at the model's aligned rate
    first = sim.run(n_aligned, trt.TrxBatchWriter(fw, el), seed=SEED, max_batches=1,
                    resume_state=state)
    fw.close()
    el.close()
    assert 0 < first < n_aligned and os.path.exists(state)
    trt.simulate_transcriptome(*args, b, resume=True, device="cpu", **kw)
    _same(jax_runs("cdna"), b, False)


def test_cli_transcriptome_byte_identical(fx, jax_runs, monkeypatch):
    """`simulate transcriptome` through the port's CLI (its
    simulate_transcriptome asked for the CPU) equals the JAX package's run."""
    from nanosim_tpu_torch import cli

    out = os.path.join(fx["d"], "torch_cli")
    monkeypatch.setattr(trt, "simulate_transcriptome",
                        functools.partial(trt.simulate_transcriptome, device="cpu"))
    cli.main(["transcriptome", "-rt", fx["trx"], "-e", fx["exp"], "-c", fx["prefix"], "-o", out,
              "-n", "100", "--seed", str(SEED), "--batch", "64", "--no_model_ir", "--uracil",
              "--fastq", "--polya", fx["polya"], "-b", "guppy"])
    _same(jax_runs("drna"), out, True)


def test_failed_replay_checksum_raises(fx, monkeypatch):
    """A replay that disagrees with the device ends the run: no other route."""
    from nanosim_tpu_torch.io import native

    real = native.WalkReplayer.replay

    def corrupt(self, *a, **kw):
        ok = real(self, *a, **kw)
        ok[:] = False
        return ok

    monkeypatch.setattr(native.WalkReplayer, "replay", corrupt)
    with pytest.raises(RuntimeError, match="checksum"):
        torch_run(fx, "cdna", "badreplay")
