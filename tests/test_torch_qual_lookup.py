"""The port's emitters of Route A's reads (csrc/recon_emit.cpp) against the
shared writer's (native/fastwriter.cpp), byte for byte.

The two differ only in how a FASTQ base's quality is looked up: the port
counts `breaks[c] <= u` from an exact count per bucket of u and steps over
the breaks left in the bucket, the shared writer by a binary search of the
row.  Each emitter call of a linear FASTQ run (aligned and unaligned reads)
and of a linear chimeric run is made again, while its batch is live, by both
writers with the same arguments: with the run's quality tables, a table of
one break and a crowded table (hundreds of breaks in a few buckets, so that
the walk takes many steps), at 1 and 4 threads, and once as FASTA.  The
FASTQ (or FASTA) and error-log bytes must be equal.  The lookup itself is
checked at u = 0, at each break, just below each break and at the largest
f32 below 1.  Under a profiler each call counts `emit.qual.bases`, the
quality bytes it wrote, and `emit.qual.walk_steps`, which stays under 0.05
a base on the run's tables.
"""

import ctypes
import os

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from nanosim_tpu_torch import tracing
from nanosim_tpu_torch.io import native
from nanosim_tpu_torch.profiles import error_model, fixtures
from nanosim_tpu_torch.sim import run as trun

import test_torch_common  # noqa: F401  (one torch thread a worker)

SEED = 5
BATCH = 64
N = 200
KINDS = ("aligned", "unaligned", "chimeric")
# NativeEmitter method -> its kind
METHODS = {"emit_recon": "aligned", "emit_recon_unaligned": "unaligned",
           "emit_chimeric_recon": "chimeric"}
TABLES = ("run", "one_break", "crowded")
THREADS = (1, 4)


class SharedWriter:
    """The shared writer's emitters under the port's names: a port entry
    point takes the shared one's arguments, in order, then two counters."""

    NAMES = {"recon_emit_aligned": "emit_batch_recon",
             "recon_emit_unaligned": "emit_batch_recon_unaligned",
             "recon_emit_chimeric": "emit_chimeric_recon"}

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, self.NAMES[name])
        return lambda *args: fn(*args[:-2])


def one_break_table(run_table):
    """Every row the sentinel 0.0 alone: every base takes the row's value."""
    br = np.zeros((run_table[0].shape[0], 1), np.float32)
    vals = np.arange(10, 10 + br.shape[0], dtype=np.int32)[:, None]
    return br, vals


def crowded_table(run_table):
    """The run's breaks with 300 more in [0.5, 0.5 + 16/4096) in every row:
    about 19 breaks a bucket there, each to be walked."""
    br, _ = run_table
    extra = (0.5 + (np.arange(300) + 0.5) * (16 / 4096 / 300)).astype(np.float32)
    rows = [np.unique(np.concatenate([r[r < 1.5], extra])) for r in br]
    K = max(len(r) for r in rows)
    out = np.full((len(rows), K), 2.0, np.float32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    vals = np.random.default_rng(11).integers(1, 94, out.shape).astype(np.int32)
    return out, vals


def _quality_bytes(fastq: bytes) -> int:
    lines = fastq.split(b"\n")
    return sum(len(q) for q in lines[3::4])


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("qual_lookup"))
    prefix = os.path.join(d, "training")
    fixtures.make_model_dir(prefix, mean_read_len=500, sd_read_len=150, n_kde_points=200)
    error_model.write_chimeric_info(prefix + "_chimeric_info", 1.9, 0.2)
    ref = os.path.join(d, "lin.fa")
    fixtures.make_reference_fasta(ref, [30000, 15000], seed=6)
    return d, prefix, ref


@pytest.fixture(scope="module")
def replays(inputs):
    """Every emitter call of the two runs, made again by both writers.

    Returns (outputs, strands, counters, tables): outputs[(kind, table,
    fastq, threads)] a list of (port bytes, shared bytes), one a call;
    strands[kind] the strands of the reads emitted; counters[kind] the first
    call's (its quality bytes, `emit.qual.bases`, `emit.qual.walk_steps`) on
    the run's tables; tables the run's quality table."""
    d, prefix, ref = inputs
    outputs, strands, counters, tables = {}, {k: set() for k in KINDS}, {}, {}
    port = native.NativeEmitter()
    shared = native.NativeEmitter()
    shared.lib = SharedWriter(shared.lib)
    originals = {m: getattr(native.NativeEmitter, m) for m in METHODS}

    def replay(method, kind):
        inner = originals[method]

        def call(self, *args, **kw):
            got = inner(self, *args, **kw)
            run_table = kw["qual_table"]
            tables.setdefault("run", run_table)
            if kind == "chimeric":
                strands[kind].update(np.asarray(kw["rev"]).tolist())
            else:
                cb, lanes = args[0], args[1]
                strands[kind].update(np.asarray(cb.rev)[lanes].tolist())
            if kind not in counters:
                with profile(activities=[ProfilerActivity.CPU]):
                    out = inner(port, *args, **kw)
                fx = bytes(out if kind == "unaligned" else out[0])
                c = tracing.RECORDER.counts
                counters[kind] = (_quality_bytes(fx), c.get("emit.qual.bases"),
                                  c.get("emit.qual.walk_steps"))
            variants = [(t, True, n) for t in TABLES for n in THREADS]
            variants += [(None, False, n) for n in THREADS]
            for table, fastq, n in variants:
                qt = {"run": run_table, "one_break": one_break_table(run_table),
                      "crowded": crowded_table(run_table), None: None}[table]
                vkw = dict(kw, fastq=fastq, qual_table=qt)
                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(native, "EMIT_THREADS", n)
                    a = inner(port, *args, **vkw)
                    a = tuple(bytes(x) for x in a) if isinstance(a, tuple) else (bytes(a),)
                    b = inner(shared, *args, **vkw)
                    b = tuple(bytes(x) for x in b) if isinstance(b, tuple) else (bytes(b),)
                outputs.setdefault((kind, table, fastq, n), []).append((a, b))
            return got

        return call

    with pytest.MonkeyPatch.context() as mp:
        for m, kind in METHODS.items():
            mp.setattr(native.NativeEmitter, m, replay(m, kind))
        trun.simulate_genome(ref, prefix, os.path.join(d, "lin"), N, seed=SEED, batch=BATCH,
                             fastq=True, device="cpu")
        trun.simulate_genome(ref, prefix, os.path.join(d, "chi"), N, seed=SEED, batch=BATCH,
                             fastq=True, chimeric=True, device="cpu")
    return outputs, strands, counters, tables


CASES = [(k, t, True, n) for k in KINDS for t in TABLES for n in THREADS]
CASES += [(k, None, False, n) for k in KINDS for n in THREADS]


@pytest.mark.parametrize("kind,table,fastq,threads", CASES)
def test_port_emitter_writes_the_shared_writers_bytes(replays, kind, table, fastq, threads):
    outputs = replays[0]
    pairs = outputs[(kind, table, fastq, threads)]
    assert pairs
    for port, shared in pairs:
        assert len(port) == len(shared)
        for a, b in zip(port, shared):
            assert a == b
    # not vacuous: the calls wrote reads, and the chimeric and aligned logs rows
    assert sum(len(p[0]) for p, _ in pairs) > 0
    if kind != "unaligned":
        assert sum(len(p[1]) for p, _ in pairs) > 0


@pytest.mark.parametrize("kind", KINDS)
def test_batches_hold_both_strands(replays, kind):
    assert replays[1][kind] == {0, 1}


@pytest.mark.parametrize("kind", KINDS)
def test_counters_count_the_quality_bytes(replays, kind):
    """`emit.qual.bases` is the quality bytes the call wrote; on the run's
    tables the walk takes under 0.05 steps a base."""
    quality, bases, steps = replays[2][kind]
    assert quality > 0
    assert bases == quality
    assert steps is not None and steps / bases < 0.05


def _counts(breaks, cls, u):
    lib = native.get_lib()
    breaks = np.ascontiguousarray(breaks, np.float32)
    cls = np.ascontiguousarray(cls, np.int32)
    u = np.ascontiguousarray(u, np.float32)
    out = np.zeros(len(u), np.int64)
    lib.recon_emit_qual_counts(
        breaks.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_int64(breaks.shape[1]),
        ctypes.c_int64(breaks.shape[0]), cls.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_int64(len(u)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


@pytest.mark.parametrize("table", TABLES)
def test_lookup_counts_like_the_search(replays, table):
    """count(breaks[c] <= u) at u = 0, at each break of the row, at the f32
    just below each break, at the largest f32 below 1, and at random draws,
    against numpy's searchsorted (side right) of the row."""
    run_table = replays[3]["run"]
    breaks = {"run": run_table, "one_break": one_break_table(run_table),
              "crowded": crowded_table(run_table)}[table][0]
    below_one = np.nextafter(np.float32(1.0), np.float32(0.0))
    rs = np.random.default_rng(7)
    for c, row in enumerate(breaks):
        real = row[row < 1.5]
        u = np.concatenate([[np.float32(0.0), below_one], real,
                            np.nextafter(real, np.float32(-1.0)),
                            rs.random(2000, dtype=np.float32)]).astype(np.float32)
        u = u[(u >= 0) & (u < 1)]
        got = _counts(breaks, np.full(len(u), c, np.int32), u)
        want = np.searchsorted(row, u, side="right")
        np.testing.assert_array_equal(got, want, err_msg=f"row {c}")
