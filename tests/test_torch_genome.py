"""The port's `simulate genome` slice against the JAX package, byte for byte.

The meta-only batch program and its transfer buffer, then whole runs on the
CPU (aligned + unaligned passes): FASTA, FASTQ and the error profile must be
byte-identical to the JAX package's files for the same seed and batch size,
also when lanes overflow the lean event budget (rescue) and when a run is
interrupted and resumed.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nanosim_tpu.io.genome import PackedGenome as JGenome
from nanosim_tpu.profiles import fixtures as jfix
from nanosim_tpu.profiles import profile as jprofile
from nanosim_tpu.sim import compact as jcompact
from nanosim_tpu.sim import genome_mode as jgm
from nanosim_tpu.sim import output as jout
from nanosim_tpu.sim import run as jrun
from nanosim_tpu_torch.io.genome import PackedGenome as TGenome
from nanosim_tpu_torch.ops import rng as trng
from nanosim_tpu_torch.profiles import profile as tprofile
from nanosim_tpu_torch.sim import compact as tcompact
from nanosim_tpu_torch.sim import genome_mode as tgm
from nanosim_tpu_torch.sim import output as tout
from nanosim_tpu_torch.sim import run as trun

from test_torch_common import make_model

SEED = 3
BATCH = 64
FILES = ("_aligned_reads", "_aligned_error_profile", "_unaligned_reads")


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("genome"))
    prefix = make_model(d, mean_read_len=500, sd_read_len=150)
    ref = os.path.join(d, "ref.fa")
    jfix.make_reference_fasta(ref, [60000, 40000], seed=5)
    return d, prefix, ref


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _assert_same_files(a, b, fastq):
    ext = ".fastq" if fastq else ".fasta"
    for suf in FILES:
        path = suf if suf.endswith("profile") else suf + ext
        assert _read(a + path) == _read(b + path), path


def _sims(prefix, ref, fastq=False):
    jg, tg = JGenome.from_fasta(ref), TGenome.from_fasta(ref)
    js = jgm.GenomeSimulator(jg, jprofile.load_profile(prefix, mode="genome", fastq=fastq),
                             fastq=fastq, batch=BATCH)
    ts = tgm.GenomeSimulator(tg, tprofile.load_profile(prefix, mode="genome", fastq=fastq),
                             fastq=fastq, batch=BATCH, device="cpu")
    assert (js.l_cap, js.l_out, js.ht_cap, js.e_max) == (ts.l_cap, ts.l_out, ts.ht_cap, ts.e_max)
    return js, ts


FIELDS = ("valid", "total_len", "head", "tail", "middle_ref", "l_new", "chrom",
          "local_pos", "is_reversed", "n_events", "capacity_overflow", "m_ref_init")


def test_meta_batch_and_transfer_buffer(fixture):
    _, prefix, ref = fixture
    js, ts = _sims(prefix, ref)
    slots = np.arange(5 * BATCH, 6 * BATCH, dtype=np.int64)
    jo = js.batch_fn(emit_reads=False)(jgm.rng.base_key(SEED), jnp.asarray(slots))
    to = ts.batch_fn(emit_reads=False)(trng.base_key(SEED, device="cpu"),
                                       torch.from_numpy(slots))
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jo, f)).astype(np.int64),
                                      getattr(to, f).numpy().astype(np.int64), err_msg=f)
    n = to.n_events.numpy()
    valid = np.arange(to.ev_type.shape[1])[None, :] < n[:, None]
    for f in ("ev_pos2x", "ev_type", "ev_len"):
        np.testing.assert_array_equal(np.where(valid, np.asarray(getattr(jo, f)), 0),
                                      getattr(to, f).numpy(), err_msg=f)
    assert to.valid.any()
    for with_events in (False, True):
        jb = jcompact.compact_pack(
            jo.read, jo.quals, jo.valid, jo.total_len, jo.head, jo.tail, jo.middle_ref,
            jo.l_new, jo.chrom, jo.local_pos, jo.is_reversed, jo.n_events,
            jo.capacity_overflow, jo.ev_pos2x, jo.ev_type, jo.ev_len, jo.m_ref_init,
            nr_cap=1, ne_cap=256, nq_cap=1, fastq=False, with_events=with_events,
            with_checksum=not with_events, with_reads=False)
        tb = tcompact.compact_pack(
            to.valid, to.total_len, to.head, to.tail, to.middle_ref, to.l_new, to.chrom,
            to.local_pos, to.is_reversed, to.n_events, to.capacity_overflow, to.ev_pos2x,
            to.ev_type, to.ev_len, to.m_ref_init, ne_cap=256, with_events=with_events,
            with_checksum=not with_events)
        jb, tb = np.asarray(jb), tb.numpy()
        if not with_events:
            assert jb.tobytes() == tb.tobytes()
            continue
        # the event stream: equal per-lane prefixes (the bytes after a lane's
        # last event in its final chunk are unspecified)
        jc, ok1 = jcompact.decode_compact(jb, BATCH, 1, 256, 1, False, True, with_reads=False)
        tc, ok2 = tcompact.decode_compact(tb, BATCH, 1, 256, 1, False, True, with_reads=False)
        assert ok1 and ok2
        meta_n = (BATCH + 1) * jcompact.META_COLS * 8
        assert jb[:meta_n].tobytes() == tb[:meta_n].tobytes()
        for lane in np.nonzero(tc.valid)[0]:
            o, k = int(tc.ev_off[lane]), int(tc.n_events[lane])
            np.testing.assert_array_equal(jc.ev_flat[o:o + k], tc.ev_flat[o:o + k])


@pytest.mark.parametrize("fastq", [False, True])
def test_simulate_genome_byte_identical(fixture, fastq):
    d, prefix, ref = fixture
    tag = "fq" if fastq else "fa"
    a, b = os.path.join(d, "jax_" + tag), os.path.join(d, "torch_" + tag)
    jrun.simulate_genome(ref, prefix, a, 300, seed=SEED, batch=BATCH, fastq=fastq)
    counts = trun.simulate_genome(ref, prefix, b, 300, seed=SEED, batch=BATCH, fastq=fastq,
                                  device="cpu")
    assert counts["unaligned"] > 0
    _assert_same_files(a, b, fastq)


def _run_aligned(sim, out_mod, path, n, **kw):
    fw = out_mod.FastxWriter(path + "_aligned_reads.fasta", False,
                             append=kw.pop("append", False))
    el = out_mod.ErrorLogWriter(path + "_aligned_error_profile", header=True,
                                append=os.path.exists(path + "_aligned_error_profile"))
    w = out_mod.GenomeBatchWriter(fw, el)
    got = sim.run(n, w, seed=SEED, **kw)
    fw.close()
    el.close()
    return got


def test_overflow_rescue_byte_identical(fixture):
    """A lean event budget of 16 makes many lanes overflow; the JAX package
    re-runs them through its read-emitting program, the port through the
    meta-only program at the full budget — same bytes."""
    d, prefix, ref = fixture
    js, ts = _sims(prefix, ref)
    js.e_max = ts.e_max = 16
    a, b = os.path.join(d, "jax_rescue"), os.path.join(d, "torch_rescue")
    jout.RUN_STATS.reset()
    tout.RUN_STATS.reset()
    assert _run_aligned(js, jout, a, 150) == _run_aligned(ts, tout, b, 150) == 150
    assert tout.RUN_STATS.overflow_rescue_lanes > 0
    assert tout.RUN_STATS.overflow_rescue_lanes == jout.RUN_STATS.overflow_rescue_lanes
    assert tout.RUN_STATS.checksum_fallback_lanes == 0
    for suf in ("_aligned_reads.fasta", "_aligned_error_profile"):
        assert _read(a + suf) == _read(b + suf), suf


def test_kill_and_resume_byte_identical(fixture):
    """An aligned pass stopped after two batches, then `simulate_genome(...,
    resume=True)` (the CLI's --resume): the files equal one uninterrupted
    JAX run, unaligned pass included."""
    d, prefix, ref = fixture
    a, b = os.path.join(d, "jax_full"), os.path.join(d, "torch_resumed")
    jrun.simulate_genome(ref, prefix, a, 300, seed=SEED, batch=BATCH)
    _, ts = _sims(prefix, ref)
    state = b + "_aligned.resume.json"  # simulate_genome's checkpoint path
    first = _run_aligned(ts, tout, b, 270, max_batches=2, resume_state=state)
    assert 0 < first < 270 and os.path.exists(state)
    trun.simulate_genome(ref, prefix, b, 300, seed=SEED, batch=BATCH, resume=True,
                         device="cpu")
    _assert_same_files(a, b, fastq=False)


def test_cli_runs_on_the_card_only(fixture):
    """The CLI asks for the card; without one it raises, it does not fall
    back to the CPU."""
    d, prefix, ref = fixture
    from nanosim_tpu_torch import cli

    out = os.path.join(d, "cli_out")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["genome", "-rg", ref, "-c", prefix, "-o", out, "-n", "20", "--seed", "3"])



def test_native_emitter_matches_numpy_spec(fixture):
    """The C++ reconstruction equals sim/reconstruct.py (the numpy spec) on
    every accepted lane, reads and FASTQ qualities, aligned and unaligned."""
    from nanosim_tpu_torch.io import native
    from nanosim_tpu_torch.sim import reconstruct, unaligned_mode
    from nanosim_tpu_torch.sim.output import CompactFetcher

    d, prefix, ref = fixture
    _, ts = _sims(prefix, ref, fastq=True)
    g = ts.genome_host
    qt = (ts.tables.qual.breaks.numpy(), ts.tables.qual.vals.numpy())
    us = unaligned_mode.UnalignedSimulator(g, ts.profile, fastq=True, batch=BATCH,
                                           device="cpu")
    slots = np.arange(BATCH, 2 * BATCH, dtype=np.int64)
    emitter = native.NativeEmitter()
    for sim, stream, ht_cap, replayer in (
        (ts, trng.STREAM_ALIGNED, ts.ht_cap,
         native.WalkReplayer(ts.profile, SEED, trng.STREAM_ALIGNED, trng.SITE_WALK, 4096)),
        (us, trng.STREAM_UNALIGNED, 0,
         native.UnalignedWalkReplayer(ts.profile, SEED, trng.STREAM_UNALIGNED,
                                      trng.SITE_UNALIGNED_WALK, us.e_max)),
    ):
        f = CompactFetcher(BATCH, 64.0, replayer, recon_info=(SEED, stream, ht_cap))
        h = f.dispatch(sim.batch_fn(emit_reads=False)(trng.base_key(SEED, stream, device="cpu"),
                                                      torch.from_numpy(slots)))
        h.slots = slots
        cb = h.fetch()
        cb.finish()  # the walk replay, which a writer runs when it emits
        lanes = np.nonzero(cb.valid & ~cb.cap_over)[0]
        assert len(lanes) > 0
        names = [f"r{b}" for b in lanes]
        if stream == trng.STREAM_ALIGNED:
            chrom = cb.chrom[lanes]
            got, _ = emitter.emit_recon(
                cb, lanes, names, g_off=g.offsets[chrom], g_len=g.lengths[chrom],
                g_circ=np.zeros(len(lanes), np.uint8), genome_flat=g.flat, fastq=True,
                write_errors=False, qual_table=qt)
            spec = reconstruct.reconstruct_batch(cb, lanes, g, SEED, stream, ht_cap,
                                                 qual_table=qt)
        else:
            got = emitter.emit_recon_unaligned(
                cb, lanes, names, g_off=g.offsets[cb.chrom[lanes]], genome_flat=g.flat,
                fastq=True, qual_table=qt)
            spec = reconstruct.reconstruct_unaligned_batch(cb, lanes, g, SEED, stream,
                                                           qual_table=qt)
        want = b"".join(b"@%s\n%s\n+\n%s\n" % (n.encode(), r.tobytes(), q.tobytes())
                        for n, (r, q) in zip(names, spec))
        assert bytes(got) == want

