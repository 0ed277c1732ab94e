"""The exact 2D-KDE conditional (`TranscriptomeSimulator(exact_conditional=True)`)
of the port against the JAX package, bit for bit.

The draw picks a component by ``sum(cumsum(exp(logw - logsumexp(logw))) < u)``,
so a one-ulp difference in the float32 sums moves a lane to another
component, and so to another read.  The port's `xla_math.logsumexp_f32` and
`xla_math.cumsum_f32` repeat XLA CPU's orders (a tree of 32-wide windows for
the row sum, a blocked scan of 16 for the cumulative sum); these tests hold
them, the component indices and whole runs (cDNA FASTQ, `--perfect`, intron
retention) equal to the JAX package.
"""

import os

import numpy as np
import pytest
import torch

from nanosim_tpu_torch.ops import xla_math
from nanosim_tpu_torch.ops.tables import KdeDevice

from test_torch_common import read_file

SIZES = [1, 7, 16, 17, 32, 33, 200, 1024, 4099]


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _rows(n: int, seed: int, positive: bool) -> np.ndarray:
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((48, n)) * rs.choice([1e-3, 1.0, 30.0], (48, 1))
    if positive:  # weights spanning many binades, as exp(logw) gives them
        x = np.exp(-np.abs(x) * 3.0) * rs.choice([1e-6, 1.0, 1e3], (48, n))
        # with no subnormal values, which exp_f32 flushes to zero as XLA does
        x[x < np.finfo(np.float32).tiny] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("n", SIZES)
def test_logsumexp_equals_xla(n):
    import jax

    x = _rows(n, n, positive=False)
    x[0, : max(1, n // 3)] = -np.inf  # a row's masked-out entries
    want = jax.jit(lambda a: jax.scipy.special.logsumexp(a, axis=1, keepdims=True))(x)
    got = xla_math.logsumexp_f32(torch.from_numpy(x))
    assert got.shape == (48, 1)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n", SIZES + [16 * 16 + 1, 16 * 16 * 16 + 3])
def test_cumsum_equals_xla(n):
    import jax
    import jax.numpy as jnp

    x = _rows(n, 100 + n, positive=True)
    want = jax.jit(lambda a: jnp.cumsum(a, axis=1))(x)
    got = xla_math.cumsum_f32(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if n >= 200:  # not vacuous: a left-to-right float32 sum differs somewhere
        seq = np.cumsum(x, axis=1, dtype=np.float32)
        assert not np.array_equal(_bits(seq), _bits(want))


def _kde_pair(n: int, seed: int):
    from nanosim_tpu.ops.tables import KdeDevice as JaxKde
    import jax.numpy as jnp

    rs = np.random.default_rng(seed)
    data = np.stack([rs.uniform(100, 3000, n), rs.uniform(50, 3000, n)], 1).astype(np.float32)
    bw = np.float32(rs.uniform(5.0, 300.0))
    return (JaxKde(data=jnp.asarray(data), bandwidth=jnp.asarray(bw), log_transform=False),
            KdeDevice(data=torch.from_numpy(data), bandwidth=torch.tensor(bw),
                      log_transform=False))


@pytest.mark.parametrize("n", [1, 7, 200, 1024, 4099])
def test_sample_conditional_equals_jax(n):
    """The components chosen and the samples, bit for bit, with the KDE as a
    program argument (as the transcriptome batch takes its tables)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def components(k, c, u):
        d2 = (c[:, None] - k.data[None, :, 0]) ** 2
        logw = -d2 / (2.0 * k.bandwidth**2)
        logw = logw - jax.scipy.special.logsumexp(logw, axis=1, keepdims=True)
        cum = jnp.cumsum(jnp.exp(logw), axis=1)
        return jnp.minimum(jnp.sum(cum < u[:, None], axis=1), k.data.shape[0] - 1), cum

    jk, tk = _kde_pair(n, seed=n)
    rs = np.random.default_rng(n + 1)
    B = 256
    c = rs.integers(100, 3000, B).astype(np.float32)
    u = rs.random(B).astype(np.float32)
    z = rs.standard_normal(B).astype(np.float32)
    want_i, want_cum = components(jk, c, u)
    want = jax.jit(lambda k, c, u, z: k.sample_conditional(c, u, z))(jk, c, u, z)
    got_i = tk.conditional_component(torch.from_numpy(c), torch.from_numpy(u))
    got = tk.sample_conditional(torch.from_numpy(c), torch.from_numpy(u), torch.from_numpy(z))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if n >= 200:  # not vacuous: many components are taken
        assert len(np.unique(np.asarray(want_i))) > 20
        # the weights' cumulative sums themselves, through the port's pieces
        d = torch.from_numpy(c)[:, None] - tk.data[None, :, 0]
        logw = -(d * d) / (tk.bandwidth * tk.bandwidth * 2.0)
        logw = logw - xla_math.logsumexp_f32(logw)
        cum = xla_math.cumsum_f32(xla_math.exp_f32(logw))
        np.testing.assert_array_equal(_bits(cum), _bits(want_cum))


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    """The model of tests/test_transcriptome.py, 20 transcripts with
    expression, and an intron-retention fixture."""
    from nanosim_tpu.profiles import error_model, fixtures

    d = str(tmp_path_factory.mktemp("exactcond"))
    prefix = os.path.join(d, "training")
    fixtures.make_model_dir(prefix, mean_read_len=600, sd_read_len=180, transcriptome=True,
                            mean_2d_ref_len=1300)
    trx_fa = os.path.join(d, "trx.fa")
    trxs = fixtures.make_transcript_reference(trx_fa, n_transcripts=20, mean_len=1600, seed=3)
    exp = os.path.join(d, "exp.tsv")
    fixtures.make_expression_tsv(exp, trxs, seed=4)
    ird = os.path.join(d, "ir")
    genome_fa, ir_trx, _, ir_trxs = fixtures.make_ir_fixture(ird, n_transcripts=10, seed=7)
    ir_exp = os.path.join(ird, "exp.tsv")
    fixtures.make_expression_tsv(ir_exp, ir_trxs, seed=8)
    ir_prefix = os.path.join(ird, "training")  # beside the structures' GFF3
    fixtures.make_model_dir(ir_prefix, mean_read_len=600, sd_read_len=180, transcriptome=True,
                            mean_2d_ref_len=1300)
    error_model.write_ir_markov(ir_prefix + "_IR_markov_model",
                                np.array([[0.5, 0.5], [0.5, 0.5], [0.3, 0.7]]))
    return dict(d=d, plain=(prefix, trx_fa, exp, None), ir=(ir_prefix, ir_trx, ir_exp, genome_fa))


RUNS = {  # id -> (source, reads, batch, fastq, perfect)
    "cdna": ("plain", 150, 64, True, False),
    "perfect": ("plain", 100, 64, False, True),
    "ir": ("ir", 120, 64, True, False),
}


def _run(pkg, fx, run, out, recon0=False) -> int:
    """One aligned pass of `pkg` (the JAX package or the port) with
    exact_conditional=True into `out`_aligned_reads / _aligned_error_profile."""
    import importlib

    source, n, batch, fastq, perfect = RUNS[run]
    prefix, trx_fa, exp, genome_fa = fx[source]
    io = importlib.import_module(pkg + ".io.genome")
    prof_mod = importlib.import_module(pkg + ".profiles.profile")
    out_mod = importlib.import_module(pkg + ".sim.output")
    rt = importlib.import_module(pkg + ".sim.run_transcriptome")
    trx = io.PackedGenome.from_fasta(trx_fa)
    model_ir = genome_fa is not None
    prof = prof_mod.load_profile(prefix, mode="transcriptome", perfect=perfect, fastq=fastq,
                                 model_ir=model_ir)
    expr = prof_mod.load_expression(exp, dict(zip(trx.names, (int(x) for x in trx.lengths))))
    kw = dict(fastq=fastq, perfect=perfect, model_ir=model_ir, batch=batch,
              exact_conditional=True)
    if model_ir:
        kw["ir_genome"] = io.PackedGenome.from_fasta(genome_fa)
    if pkg == "nanosim_tpu_torch":
        kw["device"] = "cpu"
    sim = rt.TranscriptomeSimulator(trx, prof, expr, **kw)
    ext = ".fastq" if fastq else ".fasta"
    fw = out_mod.FastxWriter(out + "_aligned_reads" + ext, fastq)
    el = out_mod.ErrorLogWriter(out + "_aligned_error_profile", header=True)
    with pytest.MonkeyPatch.context() as mp:
        if recon0:
            mp.setenv("NANOSIM_TPU_RECON", "0")
        got = sim.run(n, rt.TrxBatchWriter(fw, el, perfect=perfect), seed=7)
    fw.close()
    el.close()
    return got


@pytest.mark.parametrize("run", sorted(RUNS))
def test_exact_conditional_run_byte_identical(fx, run):
    """Whole aligned passes (Route A, the meta-only program with the host
    reconstruction) equal the JAX package's, file for file; the draw differs
    from the default nearest-of-a-pool one, so the flag is not ignored."""
    a = os.path.join(fx["d"], "jax_" + run)
    b = os.path.join(fx["d"], "torch_" + run)
    n = RUNS[run][1]
    assert _run("nanosim_tpu", fx, run, a) == n
    assert _run("nanosim_tpu_torch", fx, run, b) == n
    ext = ".fastq" if RUNS[run][3] else ".fasta"
    for suf in ("_aligned_reads" + ext, "_aligned_error_profile"):
        assert read_file(a + suf) == read_file(b + suf), suf
    reads = read_file(b + "_aligned_reads" + ext)
    if run == "ir":
        assert reads.count(b"_RetainedIntron_") > 5
    if run == "perfect":
        assert b"_perfect_" in reads


def test_exact_conditional_read_emitting_route_equals_route_a(fx):
    """NANOSIM_TPU_RECON=0 (the read-emitting program) gives the files of
    the reconstruction route, which equal the JAX package's."""
    a = os.path.join(fx["d"], "torch_cdna_r1")
    b = os.path.join(fx["d"], "torch_cdna_r0")
    _run("nanosim_tpu_torch", fx, "cdna", a)
    _run("nanosim_tpu_torch", fx, "cdna", b, recon0=True)
    for suf in ("_aligned_reads.fastq", "_aligned_error_profile"):
        assert read_file(a + suf) == read_file(b + suf), suf


def test_exact_conditional_changes_the_lengths(fx):
    """The flag reaches the draw: the aligned lengths of the exact
    conditional differ from those of the nearest-of-a-pool estimator at the
    same seed."""
    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.profiles import profile
    from nanosim_tpu_torch.sim.run_transcriptome import TranscriptomeSimulator

    prefix, trx_fa, exp, _ = fx["plain"]
    trx = PackedGenome.from_fasta(trx_fa)
    prof = profile.load_profile(prefix, mode="transcriptome", model_ir=False)
    expr = profile.load_expression(exp, dict(zip(trx.names, (int(x) for x in trx.lengths))))
    from nanosim_tpu_torch.ops import rng

    slots = torch.arange(64, dtype=torch.int64)
    base = rng.base_key(7, rng.STREAM_ALIGNED, device="cpu")
    mids = []
    for exact in (False, True):
        sim = TranscriptomeSimulator(trx, prof, expr, batch=64, exact_conditional=exact,
                                     device="cpu")
        out = sim.batch_fn(emit_reads=False)(base, slots)
        mids.append(out.m_ref_init.numpy())
    assert (mids[0] != mids[1]).sum() > 32
