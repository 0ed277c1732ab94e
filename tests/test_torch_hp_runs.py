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
from nanosim_tpu_torch.sim.compact import decode_prehp_ascii
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
    cb.finish()  # the walk replay, which a writer runs when it emits
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


def _spec_hp_log(cb, lanes, names, g):
    """The `-hp` log of a device-materialized batch as the Python spec
    composes it (event_read_positions, _prehp_log_rows): rows, and the lanes
    that wrote one."""
    rows, logged = [], 0
    for name, b in zip(names, lanes):
        ne = int(cb.n_events[b])
        if ne == 0:
            continue
        o = int(cb.ev_off[b])
        w = cb.ev_flat[o : o + ne]
        keys_v, rpos_v, lens_v = tout.event_read_positions(
            (w & np.uint32(0x1FFFF)).astype(np.int64),
            (w >> np.uint32(30)).astype(np.int64),
            ((w >> np.uint32(17)) & np.uint32(0x1FFF)).astype(np.int64),
        )
        mid = decode_prehp_ascii(cb, b).tobytes().decode()
        lane_rows = tout._prehp_log_rows(name, keys_v, w >> np.uint32(30), lens_v, rpos_v, mid,
                                         g, int(cb.chrom[b]), int(cb.pos[b]))
        rows.extend(reversed(lane_rows))
        logged += bool(lane_rows)
    return "".join(rows).encode(), logged


def _word(pos2x, length, etype):
    return pos2x | length << 17 | etype << 30


def _random_events(rng, m):
    """Ascending events over a middle of m reference bases: mismatches,
    insertions (some followed by an overwriting one at the same key),
    deletions, and suppressed (zero-length) ones."""
    words, p = [], 0
    while p < m:
        if rng.random() >= 0.2:
            p += 1
            continue
        t = int(rng.integers(0, 3))
        ln = 0 if rng.random() < 0.15 else int(rng.integers(1, 4))
        if t == 1:
            words.append(_word(2 * p + 1, ln, 1))
            if rng.random() < 0.3:
                words.append(_word(2 * p + 1, int(rng.integers(1, 4)), 1))
            p += 1
        else:
            ln = min(ln, m - p) if t == 2 else min(ln, 1)
            words.append(_word(2 * p, ln, t))
            p += max(ln, 1)
    return words


def _synthetic_hp_batch():
    """A compact `-hp` batch built by hand over a genome of a circular, a
    linear and a circular chromosome, with lanes that hit every rule of the
    log: an event across the circular origin, one past it, overwritten
    duplicate insertions, suppressed events, a lane with no events,
    reverse-strand lanes, events at the last base of a middle and past a
    middle cut short, a cut at the end of the genome, and an invalid lane
    left out of the emission order."""
    from nanosim_tpu_torch.sim.compact import CHUNK, CompactBatch

    rng = np.random.default_rng(1717)
    lens = [500, 800, 300]
    g = TGenome(flat=rng.choice(np.frombuffer(b"ACGT", np.uint8), sum(lens)),
                names=["c0", "c1", "c2"], lengths=np.array(lens, np.int64),
                offsets=np.concatenate([[0], np.cumsum(lens)]).astype(np.int64),
                circular=np.array([True, False, False]))
    # (chrom, pos, middle_ref, rev, events, pre_len less than the events give)
    lanes = [
        (0, 490, 30, False, [_word(16, 5, 2), _word(20, 1, 0)], 0),  # wraps; then past 0
        (1, 100, 40, False, [_word(5, 2, 1), _word(5, 3, 1), _word(5, 1, 1), _word(10, 0, 0),
                             _word(14, 0, 2), _word(20, 2, 2), _word(31, 2, 1), _word(31, 1, 1)],
         0),  # duplicate insertions, suppressed events
        (1, 200, 25, False, [], 0),  # no events
        (0, 10, 50, True, [_word(6, 1, 0), _word(13, 2, 1), _word(40, 3, 2)], 0),
        (1, 300, 20, True, [_word(38, 1, 0)], 0),  # the middle's last base
        (0, 400, 20, False, [_word(39, 3, 1)], 2),  # an insertion past a short middle
        (2, 295, 10, False, [_word(6, 4, 2), _word(16, 1, 0)], 0),  # the genome's end
    ]
    for _ in range(41):
        c = int(rng.integers(0, 3))
        m = int(rng.integers(0, 300))
        pos = int(rng.integers(max(lens[c] - m - 20, 0), lens[c]))
        lanes.append((c, pos, m, bool(rng.integers(0, 2)), _random_events(rng, m), 0))
    B = len(lanes)
    valid = np.ones(B, bool)
    valid[9] = False
    n_events = np.array([len(ln[4]) for ln in lanes], np.int64)
    ev_ch = (valid * 4 * n_events + CHUNK - 1) // CHUNK
    ev_off = (np.cumsum(ev_ch) - ev_ch) * (CHUNK // 4)
    ev_flat = np.zeros(int(ev_ch.sum()) * CHUNK // 4 + 1, np.uint32)
    pre_len = np.zeros(B, np.int64)
    for b, (_, _, m, _, words, short) in enumerate(lanes):
        if valid[b]:
            ev_flat[ev_off[b] : ev_off[b] + len(words)] = words
        w = np.array(words, np.uint32)
        _, _, eff = tout.event_read_positions((w & 0x1FFFF).astype(np.int64),
                                              (w >> 30).astype(np.int64),
                                              ((w >> 17) & 0x1FFF).astype(np.int64))
        t = w >> 30
        pre_len[b] = m - eff[t == 2].sum() + eff[t == 1].sum() - short
    pch = (valid * ((pre_len + 3) // 4) + CHUNK - 1) // CHUNK
    prehp_off = (np.cumsum(pch) - pch) * CHUNK
    prehp_flat = np.zeros(int(pch.sum()) * CHUNK, np.uint8)
    for b in np.nonzero(valid)[0]:
        codes = rng.integers(0, 4, int(pre_len[b]) + 3)
        packed = codes[0::4][: (pre_len[b] + 3) // 4]
        for j in (1, 2, 3):
            packed = packed | codes[j::4][: len(packed)] << (2 * j)
        prehp_flat[prehp_off[b] : prehp_off[b] + len(packed)] = packed
    cb = CompactBatch()
    cb.valid, cb.n_events, cb.ev_off, cb.ev_flat = valid, n_events, ev_off, ev_flat
    cb.chrom = np.array([ln[0] for ln in lanes], np.int64)
    cb.pos = np.array([ln[1] for ln in lanes], np.int64)
    cb.rev = np.array([ln[3] for ln in lanes], bool)
    cb.prehp_flat, cb.prehp_off, cb.prehp_len = prehp_flat, prehp_off, pre_len
    return cb, rng.permutation(np.nonzero(valid)[0]), g


def _device_hp_batch(model):
    """One batch of the circular `-hp` read-emitting program on the CPU, as
    the run fetches it."""
    _, ts = _sims(model, dna="circular", fastq=True)
    slots = np.arange(BATCH, 2 * BATCH, dtype=np.int64)
    cb = ts.dispatcher(SEED)(slots).fetch()
    return cb, np.nonzero(cb.valid & ~cb.cap_over)[0][::-1], ts.genome_host


@pytest.mark.parametrize("n_threads", [1, 4])
@pytest.mark.parametrize("batch", ["synthetic", "device"])
def test_native_hp_log_matches_python_spec(model, batch, n_threads, monkeypatch):
    """The C++ composer of a device-materialized batch's `-hp` log
    (NativeEmitter.prehp_log) writes the Python spec's bytes, and counts the
    lanes that wrote a row, whatever the thread count."""
    cb, lanes, g = _synthetic_hp_batch() if batch == "synthetic" else _device_hp_batch(model)
    names = [f"read{b}_{'R' if cb.rev[b] else 'F'}" for b in lanes]
    want, want_logged = _spec_hp_log(cb, lanes, names, g)
    emitter = native.NativeEmitter()
    emitter._err_buf = np.empty(16, np.uint8)  # the buffer grows to the rows' bound
    monkeypatch.setattr(native, "EMIT_THREADS", n_threads)
    got, logged = emitter.prehp_log(cb, lanes, names, g)
    assert bytes(got) == want
    assert logged == want_logged > 10
    # not vacuous: events were dropped from the log (suppressed or overwritten)
    assert want.count(b"\n") < int(cb.n_events[lanes].sum())
    if batch == "synthetic":
        rows = want.decode().splitlines()
        wrap = g.flat[[498, 499, 0, 1, 2]].tobytes().decode()
        assert rows.index(f"read0_F\t8\tdel\t5\t{wrap}\t-----") == rows.index(
            next(r for r in rows if r.startswith("read0_F\t10\tmis\t1\t" + chr(g.flat[0])))) + 1
        assert [r.split("\t")[3] for r in rows if r.startswith("read1_F\t3\tins")] == ["1"]
        assert not any(r.startswith("read2_") for r in rows)
