"""Whole `simulate genome -hp -k 6` runs of the port against the JAX package,
byte for byte: reads, qualities, the error profile and the unaligned reads.

Linear DNA on the host-reconstruction route (FASTA and FASTQ), circular DNA,
linear DNA with NANOSIM_TPU_RECON=0 (against the JAX run with the same
variable, and against the port's own reconstruction route), a forced
overflow rescue (lean event budget), a forced run-table overflow (small
hp_r_max), a killed and resumed run, and the C++ `-hp` emitter against its
numpy spec.  The reference is written with hp_bias, so runs of length >= k
are common and the suppression and the resizing both fire.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

from nanosim_tpu.io.genome import PackedGenome as JGenome
from nanosim_tpu.profiles import fixtures as jfixtures
from nanosim_tpu.profiles import profile as jprofile
from nanosim_tpu.sim import genome_mode as jgm
from nanosim_tpu.sim import output as jout
from nanosim_tpu.sim import run as jrun
from nanosim_tpu_torch.io import native
from nanosim_tpu_torch.io.genome import PackedGenome as TGenome
from nanosim_tpu_torch.ops import rng as trng
from nanosim_tpu_torch.profiles import profile as tprofile
from nanosim_tpu_torch.sim import genome_mode as tgm
from nanosim_tpu_torch.sim import output as tout
from nanosim_tpu_torch.sim import reconstruct
from nanosim_tpu_torch.sim import run as trun

from test_torch_common import make_model

SEED = 3
BATCH = 64
N = 300
K = 6
FILES = ("_aligned_reads", "_aligned_error_profile", "_unaligned_reads")


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("hpruns"))
    prefix = make_model(d, mean_read_len=500, sd_read_len=150)
    lin, circ = os.path.join(d, "lin.fa"), os.path.join(d, "circ.fa")
    # hp_bias raises run density so suppression + resizing fire often
    jfixtures.make_reference_fasta(lin, [40000, 30000], seed=17, hp_bias=0.6)
    jfixtures.make_reference_fasta(circ, [20000], seed=18, hp_bias=0.6)
    return d, prefix, lin, circ


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
    """The JAX package's whole `-hp -k 6` runs, each made once per module."""
    d, prefix, lin, circ = model
    done = {}

    def get(tag, fastq, dna="linear", recon0=False):
        if tag not in done:
            out = os.path.join(d, "jax_" + tag)
            with pytest.MonkeyPatch.context() as mp:
                if recon0:
                    mp.setenv("NANOSIM_TPU_RECON", "0")
                jrun.simulate_genome(circ if dna == "circular" else lin, prefix, out, N,
                                     seed=SEED, batch=BATCH, fastq=fastq, dna_type=dna,
                                     kmer_bias=K, homopolymer=True)
            done[tag] = out
        return done[tag]

    return get


def _torch_run(model, tag, fastq, dna="linear", recon0=False):
    d, prefix, lin, circ = model
    out = os.path.join(d, "torch_" + tag)
    tout.RUN_STATS.reset()
    with pytest.MonkeyPatch.context() as mp:
        if recon0:
            mp.setenv("NANOSIM_TPU_RECON", "0")
        counts = trun.simulate_genome(circ if dna == "circular" else lin, prefix, out, N,
                                      seed=SEED, batch=BATCH, fastq=fastq, dna_type=dna,
                                      kmer_bias=K, device="cpu")
    assert counts["aligned"] > 0 and counts["unaligned"] > 0
    assert tout.RUN_STATS.checksum_fallback_lanes == 0
    return out


def _runs_and_zeroed(prefix_out, fastq):
    """(reads holding a run of length >= K, reads in all) of the aligned
    file."""
    run_re = re.compile(("A{%d,}|C{%d,}|G{%d,}|T{%d,}" % (K, K, K, K)).encode())
    lines = _read(prefix_out + "_aligned_reads" + (".fastq" if fastq else ".fasta")).split(b"\n")
    seqs = lines[1::4] if fastq else lines[1::2]
    return sum(1 for s in seqs if run_re.search(s)), len(seqs)


@pytest.mark.parametrize("fastq", [False, True])
def test_hp_linear_run_byte_identical(model, jax_runs, fastq):
    """Route A: the meta-only program on the device, emit_batch_recon_hp on
    the host."""
    tag = "lin_fq" if fastq else "lin_fa"
    b = _torch_run(model, tag, fastq)
    _assert_same_files(jax_runs(tag, fastq), b, fastq)
    with_runs, n = _runs_and_zeroed(b, fastq)
    assert n > 0 and with_runs >= 20  # not vacuous: runs of length >= k occur


def test_hp_circular_run_byte_identical(model, jax_runs):
    """Route B: the unfused read-emitting program, reads and pre-resize
    middles in the compact buffer, the log composed from them."""
    b = _torch_run(model, "circ_fq", True, dna="circular")
    _assert_same_files(jax_runs("circ_fq", True, dna="circular"), b, fastq=True)
    assert _runs_and_zeroed(b, True)[0] >= 20


@pytest.fixture(scope="module")
def torch_recon0(model):
    return _torch_run(model, "recon0_fq", True, recon0=True)


def test_hp_recon0_byte_identical(model, jax_runs, torch_recon0):
    _assert_same_files(jax_runs("recon0_fq", True, recon0=True), torch_recon0, fastq=True)


def test_hp_recon0_equals_the_reconstruction_route(model, torch_recon0):
    """Two routes, same bytes: the device-materialized -hp reads and log
    (RECON=0) and the host's -hp reconstruction of the meta-only program."""
    _assert_same_files(torch_recon0, _torch_run(model, "recon1_fq", True), fastq=True)


def _sims(model, dna="linear", fastq=False):
    d, prefix, lin, circ = model
    ref = circ if dna == "circular" else lin
    kw = dict(fastq=fastq, circular_dna=dna == "circular", batch=BATCH, kmer_bias=K)
    js = jgm.GenomeSimulator(
        JGenome.from_fasta(ref, dna_type=dna),
        jprofile.load_profile(prefix, mode="genome", fastq=fastq, homopolymer=True), **kw)
    ts = tgm.GenomeSimulator(
        TGenome.from_fasta(ref, dna_type=dna),
        tprofile.load_profile(prefix, mode="genome", fastq=fastq, homopolymer=True),
        device="cpu", **kw)
    return js, ts


def _run_aligned(sim, out_mod, path, n, **kw):
    fw = out_mod.FastxWriter(path + "_aligned_reads.fasta", False)
    el = out_mod.ErrorLogWriter(path + "_aligned_error_profile", header=True)
    got = sim.run(n, out_mod.GenomeBatchWriter(fw, el), seed=SEED, **kw)
    fw.close()
    el.close()
    return got


def _assert_rescued_alike(a, b):
    assert tout.RUN_STATS.overflow_rescue_lanes > 0
    assert tout.RUN_STATS.overflow_rescue_lanes == jout.RUN_STATS.overflow_rescue_lanes
    assert tout.RUN_STATS.checksum_fallback_lanes == 0
    for suf in ("_aligned_reads.fasta", "_aligned_error_profile"):
        assert _read(a + suf) == _read(b + suf), suf


def test_hp_overflow_rescue_byte_identical(model):
    """Route A with a lean event budget of 16: many lanes overflow and are
    re-run through the device-materialized -hp program at the full budget,
    spliced between host-reconstructed lanes."""
    d = model[0]
    js, ts = _sims(model)
    js.e_max = ts.e_max = 16
    a, b = os.path.join(d, "jax_rescue"), os.path.join(d, "torch_rescue")
    jout.RUN_STATS.reset()
    tout.RUN_STATS.reset()
    assert _run_aligned(js, jout, a, 150) == _run_aligned(ts, tout, b, 150) == 150
    _assert_rescued_alike(a, b)


def test_hp_run_table_overflow_byte_identical(model):
    """Circular DNA with a run table of 2 entries: every lane holding more
    runs of length >= k overflows it and is re-run through the rescue
    program, whose table (l_cap // k + 1) cannot overflow."""
    d = model[0]
    js, ts = _sims(model, dna="circular")
    ts.hp_r_max = 2
    jax_batch_fn = js.batch_fn
    js.batch_fn = lambda **kw: functools.partial(jax_batch_fn(**kw), hp_r_max=2)
    a, b = os.path.join(d, "jax_rmax"), os.path.join(d, "torch_rmax")
    jout.RUN_STATS.reset()
    tout.RUN_STATS.reset()
    assert _run_aligned(js, jout, a, 150) == _run_aligned(ts, tout, b, 150) == 150
    _assert_rescued_alike(a, b)
    # and the output does not depend on the table's size
    _, ts2 = _sims(model, dna="circular")
    c = os.path.join(d, "torch_rmax_default")
    assert _run_aligned(ts2, tout, c, 150) == 150
    for suf in ("_aligned_reads.fasta", "_aligned_error_profile"):
        assert _read(b + suf) == _read(c + suf), suf


def test_hp_kill_and_resume_byte_identical(model, jax_runs):
    """A `-hp` aligned pass stopped after two batches, then
    `simulate_genome(..., resume=True)`: the files equal one uninterrupted
    JAX run, unaligned pass included."""
    d, prefix, lin, _ = model
    a = jax_runs("lin_fa", False)
    b = os.path.join(d, "torch_resumed")
    _, ts = _sims(model)
    state = b + "_aligned.resume.json"  # simulate_genome's checkpoint path
    first = _run_aligned(ts, tout, b, N - 30, max_batches=2, resume_state=state)
    assert 0 < first < N - 30 and os.path.exists(state)
    trun.simulate_genome(lin, prefix, b, N, seed=SEED, batch=BATCH, resume=True, kmer_bias=K,
                         device="cpu")
    _assert_same_files(a, b, fastq=False)


def test_native_hp_emitter_matches_numpy_spec(model):
    """The C++ `-hp` reconstruction (emit_batch_recon_hp) equals
    sim/reconstruct.reconstruct_hp_batch on every accepted lane of a batch:
    reads, FASTQ qualities and the pre-resize ground-truth log."""
    _, ts = _sims(model, fastq=True)
    g = ts.genome_host
    qt = (ts.tables.qual.breaks.numpy(), ts.tables.qual.vals.numpy())
    hp_tab = (ts.tables.hp_breaks.numpy(), ts.tables.hp_vals.numpy())
    replayer = native.WalkReplayer(ts.profile, SEED, trng.STREAM_ALIGNED, trng.SITE_WALK, 4096)
    f = tout.CompactFetcher(BATCH, 64.0, replayer,
                            recon_info=(SEED, trng.STREAM_ALIGNED, ts.ht_cap))
    slots = np.arange(BATCH, 2 * BATCH, dtype=np.int64)
    h = f.dispatch(ts.batch_fn(emit_reads=False)(trng.base_key(SEED, device="cpu"),
                                                 torch.from_numpy(slots)))
    h.slots = slots
    cb = h.fetch()
    lanes = np.nonzero(cb.valid & ~cb.cap_over)[0]
    assert len(lanes) > 10
    names = [f"r{b}" for b in lanes]
    chrom = cb.chrom[lanes]
    emitter = native.NativeEmitter()
    got_fx, got_err = emitter.emit_recon_hp(
        cb, lanes, names, g_off=g.offsets[chrom], genome_flat=g.flat,
        fastq=True, write_errors=True, k=K, hp_tab=hp_tab,
        hp_mis_rate=ts.tables.hp_mis_rate, l_cap=ts.l_cap, qual_table=qt)
    got_fx, got_err = bytes(got_fx), bytes(got_err)
    spec = reconstruct.reconstruct_hp_batch(cb, lanes, g, SEED, trng.STREAM_ALIGNED, ts.ht_cap,
                                            K, hp_tab, ts.tables.hp_mis_rate, ts.l_cap,
                                            qual_table=qt)
    want_fx = b"".join(b"@%s\n%s\n+\n%s\n" % (n.encode(), r["read"].tobytes(),
                                              r["quals"].tobytes())
                       for n, r in zip(names, spec))
    assert got_fx == want_fx
    rows = []
    etype = ("mis", "ins", "del")
    for n, b, r in zip(names, lanes, spec):
        goff, spos, mid1 = int(g.offsets[cb.chrom[b]]), int(cb.pos[b]), r["mid1"]
        lane_rows = []
        for kk, t, ln, rp in zip(*r["log"]):
            seq = mid1[rp : rp + ln].tobytes().decode()
            if t == 1:
                ref, seq_b = "-" * ln, seq
            else:
                st = goff + spos + kk
                ref = g.flat[st : st + ln].tobytes().decode()
                seq_b = seq if t == 0 else "-" * ln
            lane_rows.append(f"{n}\t{kk}\t{etype[t]}\t{ln}\t{ref}\t{seq_b}\n")
        rows.extend(reversed(lane_rows))
    assert got_err == "".join(rows).encode()
    # not vacuous: a resize changed some read's length, and some event was
    # suppressed (logged events are fewer than the walk's)
    assert any(r["l_new2"] != len(r["mid1"]) for r in spec)
    assert sum(len(r["log"][0]) for r in spec) < int(cb.n_events[lanes].sum())
