"""The port's own spans and counters (`nanosim_tpu_torch.tracing`).

Whole `simulate genome` runs on the CPU at the sizes of the port's run tests,
in the four traffics of the benchmark's cells: linear FASTQ (host
reconstruction), circular FASTQ (the read-emitting program), chimeric (linear,
host reconstruction) and `-hp -k 6` (circular).  Each runs once with no
profiler and once under `torch.profiler` (CPU activity):

* with no profiler the tracer reads no clock, enters no `record_function`
  and leaves no rows or counts;
* under the profiler every span of the path fires, each nested span lies
  inside its parent, one batch's dispatch, fetch and emit carry its first
  slot, `batches.fetched` counts the batches consumed, self times are not
  negative and every row lies inside the job, neither draw counter
  (`rng.draw_launches`, `rng.plain_hashes_on_card`) appears on the CPU, and
  the quality lookup's counters (`emit.qual.bases`, `emit.qual.walk_steps`)
  appear in the host-reconstruction runs alone;
* the files are the same bytes either way.

A multi-rank run (two gloo ranks, one process each, each under its own
profiler) records on every rank the exchange of the accept counts as spans
`exchange` inside the batch's `dispatch`, one `exchange.rounds` a batch
dispatched, and the rank's writes as `emit`.
"""

import json
import os
import socket
import subprocess
import sys
import time

import pytest
from torch.profiler import ProfilerActivity, profile

from nanosim_tpu_torch import tracing
from nanosim_tpu_torch.profiles import error_model, fixtures
from nanosim_tpu_torch.sim import run as trun

import test_torch_common  # noqa: F401  (one torch thread a worker)

SEED = 3
BATCH = 64
N = 300
FILES = ("_aligned_reads.fastq", "_aligned_error_profile", "_unaligned_reads.fastq")

COMMON = {"dispatch", "dispatch.program", "dispatch.compact", "fetch", "fetch.copy",
          "fetch.decode", "emit", "emit.names", "emit.format", "emit.write"}
# traffic -> (simulate_genome arguments, the spans its path runs)
TRAFFICS = {
    "linear": ({"dna": "linear"}, COMMON | {"emit.replay"}),
    "circular": ({"dna": "circular"}, COMMON | {"emit.replay"}),
    "chimeric": ({"dna": "linear", "chimeric": True}, COMMON | {"emit.replay"}),
    "hp_k6": ({"dna": "circular", "kmer_bias": 6}, COMMON | {"emit.hp_log"}),
}
# span -> the spans it may run directly inside: the batch program also runs
# in the overflow rescue (inside emit) and the packed-lane spill (inside
# fetch); the compaction also in a repack (fetch), the rescue and the replay
# fallback; the replay inside fetch where the fetcher replays eagerly
PARENT = {"dispatch": {None}, "emit": {None},
          "dispatch.program": {"dispatch", "emit", "fetch"},
          "dispatch.compact": {"dispatch", "emit", "fetch", "emit.replay"},
          "fetch": {"emit"}, "fetch.copy": {"fetch", "emit"}, "fetch.decode": {"fetch"},
          "emit.replay": {"emit", "fetch"}, "emit.names": {"emit"}, "emit.format": {"emit"},
          "emit.hp_log": {"emit"}, "emit.write": {"emit"}}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tracing"))
    prefix = os.path.join(d, "training")
    fixtures.make_model_dir(prefix, mean_read_len=500, sd_read_len=150, n_kde_points=200)
    error_model.write_chimeric_info(prefix + "_chimeric_info", 1.9, 0.2)
    refs = {"linear": os.path.join(d, "lin.fa"), "circular": os.path.join(d, "circ.fa")}
    fixtures.make_reference_fasta(refs["linear"], [30000, 15000], seed=6, hp_bias=0.5)
    fixtures.make_reference_fasta(refs["circular"], [20000], seed=7, hp_bias=0.5)
    return d, prefix, refs


def _simulate(inputs, tag, args):
    d, prefix, refs = inputs
    out = os.path.join(d, tag)
    trun.simulate_genome(refs[args["dna"]], prefix, out, N, seed=SEED, batch=BATCH, fastq=True,
                         dna_type=args["dna"], chimeric=args.get("chimeric", False),
                         kmer_bias=args.get("kmer_bias"), device="cpu")
    return out


def _raise(*args, **kwargs):
    raise AssertionError("the tracer ran with no profiler")


@pytest.fixture(scope="module")
def runs(inputs):
    """traffic -> (untraced output, traced output, rows, counts, self seconds,
    clock before and after the traced job), each run made once per module."""
    done = {}

    def get(traffic):
        if traffic not in done:
            args = TRAFFICS[traffic][0]
            tracing.RECORDER.reset()
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tracing, "_clock", _raise)
                mp.setattr(tracing._prof, "record_function", _raise)
                off = _simulate(inputs, traffic + "_off", args)
            assert tracing.RECORDER.rows == [] and tracing.RECORDER.counts == {}
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU]):
                on = _simulate(inputs, traffic + "_on", args)
            t1 = time.perf_counter()
            rec = tracing.RECORDER
            done[traffic] = (off, on, list(rec.rows), dict(rec.counts), rec.self_seconds(), t0, t1)
        return done[traffic]

    return get


def test_span_off_is_one_shared_null_context():
    assert not tracing.profiling()
    assert tracing.span("emit", 0) is tracing.span("fetch.copy")
    with tracing.span("emit", 0) as s:
        assert s is None


def test_recorder_starts_afresh_with_each_session():
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            with tracing.span("outer", 7):
                with tracing.span("inner"):
                    pass
            tracing.count("n", 2)
        tracing.span("after")  # no profiler: no row
        rec = tracing.RECORDER
        assert [r[0] for r in rec.rows] == ["inner", "outer"]
        assert [(r[3], r[4]) for r in rec.rows] == [(1, None), (0, 7)]
        assert rec.counts == {"n": 2}
        inner, outer = rec.rows
        own = rec.self_seconds()
        assert own["outer"] == pytest.approx((outer[2] - outer[1]) - (inner[2] - inner[1]))


@pytest.mark.parametrize("traffic", list(TRAFFICS))
def test_no_profiler_no_rows(runs, traffic):
    """The untraced run read no clock and entered no record_function (both
    patched to raise), and left nothing in the recorder (checked in the
    fixture); its files are the traced run's bytes."""
    off, on = runs(traffic)[:2]
    for suf in FILES:
        with open(off + suf, "rb") as a, open(on + suf, "rb") as b:
            assert a.read() == b.read(), suf


@pytest.mark.parametrize("traffic", list(TRAFFICS))
def test_every_span_of_the_path_fires(runs, traffic):
    rows, counts, own = runs(traffic)[2:5]
    assert {r[0] for r in rows} == TRAFFICS[traffic][1]
    assert set(own) == TRAFFICS[traffic][1]
    assert min(own.values()) >= 0.0
    assert counts["batches.dispatched"] >= counts["batches.fetched"] > 0


@pytest.mark.parametrize("traffic", list(TRAFFICS))
def test_hp_log_counts_the_lanes_it_logged(runs, traffic):
    """`emit.hp_log.lanes` counts the reads whose rows the `-hp` log's
    composer wrote: in the traced `-hp` run, every read named in the error
    profile; the other paths never reach the composer."""
    on, _, counts = runs(traffic)[1:4]
    if "kmer_bias" not in TRAFFICS[traffic][0]:
        assert "emit.hp_log.lanes" not in counts
        return
    with open(on + "_aligned_error_profile", "rb") as f:
        logged = {row.split(b"\t", 1)[0] for row in f.read().splitlines()[1:]}
    assert counts["emit.hp_log.lanes"] == len(logged) > 0


@pytest.mark.parametrize("traffic", list(TRAFFICS))
def test_quality_lookup_counts_route_a_fastq(runs, traffic):
    """`emit.qual.bases` counts the quality bytes that Route A's emitters
    (csrc/recon_emit.cpp) wrote through their lookup: in the linear and
    chimeric runs, every quality byte of the aligned and unaligned files;
    `emit.qual.walk_steps` appears beside it.  The circular runs take the
    read-emitting program in every pass and count neither."""
    on, _, counts = runs(traffic)[1:4]
    if TRAFFICS[traffic][0]["dna"] == "circular":
        assert "emit.qual.bases" not in counts and "emit.qual.walk_steps" not in counts
        return
    quality = 0
    for suf in ("_aligned_reads.fastq", "_unaligned_reads.fastq"):
        with open(on + suf, "rb") as f:
            quality += sum(len(q) for q in f.read().split(b"\n")[3::4])
    assert counts["emit.qual.bases"] == quality > 0
    assert 0 <= counts["emit.qual.walk_steps"] < counts["emit.qual.bases"]


@pytest.mark.parametrize("traffic", list(TRAFFICS))
def test_draws_count_nothing_on_the_cpu(runs, traffic):
    """On CPU tensors every draw is ops/rng.py's int64 version: neither
    draw counter appears, `rng.draw_launches` (launches of csrc/draw.cu) nor
    `rng.plain_hashes_on_card` (int64 hashes on CUDA tensors)."""
    counts = runs(traffic)[3]
    assert "rng.draw_launches" not in counts
    assert "rng.plain_hashes_on_card" not in counts


@pytest.mark.parametrize("traffic", list(TRAFFICS))
def test_children_lie_inside_their_parents(runs, traffic):
    rows = sorted(runs(traffic)[2], key=lambda r: (r[1], r[3]))
    stack = []
    for name, s, e, depth, _ in rows:
        while stack and stack[-1][2] <= s:
            stack.pop()
        assert depth == len(stack), name
        parent = stack[-1] if stack else (None, s, e)
        assert parent[0] in PARENT[name], (name, parent[0])
        assert parent[1] <= s <= e <= parent[2], name
        stack.append((name, s, e))


@pytest.mark.parametrize("traffic", list(TRAFFICS))
def test_batches_share_their_first_slot(runs, traffic):
    rows, counts = runs(traffic)[2:4]
    by = {n: [r[4] for r in rows if r[0] == n] for n in ("dispatch", "fetch", "emit")}
    # each batch consumed is one emit span, and fetched once
    assert counts["batches.fetched"] == len(by["emit"]) == len(by["fetch"])
    assert counts["batches.dispatched"] == len(by["dispatch"])
    assert all(b is not None and b % BATCH == 0 for b in by["emit"])
    assert sorted(by["emit"]) == sorted(by["fetch"])
    assert set(by["emit"]) <= set(by["dispatch"])


@pytest.mark.parametrize("traffic", list(TRAFFICS))
def test_rows_lie_inside_the_job(runs, traffic):
    rows, _, _, t0, t1 = runs(traffic)[2:7]
    assert rows and all(t0 <= s <= e <= t1 for _, s, e, _, _ in rows)


RANK_SCRIPT = """
import json, sys
import torch
torch.set_num_threads(1)
from torch.profiler import ProfilerActivity, profile
from nanosim_tpu_torch import tracing
from nanosim_tpu_torch.sim.run import simulate_genome
ref, prefix, out, host_id, coordinator = sys.argv[1:6]
with profile(activities=[ProfilerActivity.CPU]):
    simulate_genome(ref, prefix, out, 200, seed=3, batch=64, fastq=True, n_hosts=2,
                    host_id=int(host_id), coordinator=coordinator, device="cpu")
with open(out + f"_trace_h{host_id}.json", "w") as f:
    json.dump({"counts": tracing.RECORDER.counts,
               "rows": [r[:4] for r in tracing.RECORDER.rows]}, f)
"""


def test_multi_rank_run_records_the_exchange(inputs):
    d, prefix, refs = inputs
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{sock.getsockname()[1]}"
    out = os.path.join(d, "ranks")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, refs["linear"], prefix, out,
                               str(h), coordinator], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for h in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    for h in range(2):
        with open(out + f"_trace_h{h}.json") as f:
            got = json.load(f)
        counts, rows = got["counts"], got["rows"]
        assert counts["exchange.rounds"] == counts["batches.dispatched"] > 0
        exchanges = [r for r in rows if r[0] == "exchange"]
        dispatches = [r for r in rows if r[0] == "dispatch" and r[3] == 0]
        assert len(exchanges) == counts["exchange.rounds"] == len(dispatches)
        for (_, s, e, depth), (_, ds, de, _) in zip(exchanges, dispatches):
            assert ds <= s <= e <= de and depth == 1
        assert any(r[0] == "emit" and r[3] == 0 for r in rows)


# --- the metagenome's accept loop --------------------------------------------

META_SPECIES = ("Escherichia coli", "Bacillus subtilis", "Saccharomyces cerevisiae")
# the loop's spans, and those that its worker thread records in the replay and emit
META_LOOP = {"dispatch", "dispatch.program", "dispatch.compact", "species.lengths",
             "species.assign", "emit.queue_wait"}
META_WORKER = {"emit.replay", "emit.names", "emit.format", "emit.write"}


@pytest.fixture(scope="module")
def meta_runs(inputs):
    """A `simulate metagenome --chimeric --fastq` run with no profiler and
    one under it, on three species (a circular bacterium, a linear one, a
    yeast of three linear chromosomes): (untraced output, traced output,
    rows, counts, self seconds, the segment counts the packing was given)."""
    from nanosim_tpu_torch.sim import run_metagenome

    d, prefix, _ = inputs
    glist, dl, ab = (os.path.join(d, f) for f in ("meta_genomes.tsv", "meta_dna.tsv",
                                                  "meta_abun.tsv"))
    sizes = [[24000], [18000], [9000, 7000, 5000]]
    with open(glist, "w") as g, open(dl, "w") as t, open(ab, "w") as a:
        a.write(f"Species\t{N}\n")
        for i, (sp, sz) in enumerate(zip(META_SPECIES, sizes)):
            path = os.path.join(d, f"meta{i}.fa")
            fixtures.make_reference_fasta(path, sz, seed=20 + i, name_prefix=f"m{i}chr")
            g.write(f"{sp}\t{path}\n")
            for c in range(len(sz)):
                t.write(f"{sp}\tm{i}chr{c + 1}\t{'circular' if i == 0 else 'linear'}\n")
            a.write(f"{sp}\t{[50, 30, 20][i]}\n")

    def simulate(tag):
        out = os.path.join(d, tag)
        run_metagenome.simulate_metagenome(glist, ab, dl, prefix, out, chimeric=True,
                                           fastq=True, seed=SEED, batch=BATCH, device="cpu")
        return out

    tracing.RECORDER.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tracing, "_clock", _raise)
        mp.setattr(tracing._prof, "record_function", _raise)
        off = simulate("meta_off")
    assert tracing.RECORDER.rows == [] and tracing.RECORDER.counts == {}
    segments = []
    assign = run_metagenome.assign_species_batch

    def counting(m_ref, n_seg, *args):
        segments.append(int(n_seg.sum()))
        return assign(m_ref, n_seg, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(run_metagenome, "assign_species_batch", counting)
        with profile(activities=[ProfilerActivity.CPU]):
            on = simulate("meta_on")
    rec = tracing.RECORDER
    return off, on, list(rec.rows), dict(rec.counts), rec.self_seconds(), segments


def test_metagenome_no_profiler_no_rows(meta_runs):
    """No clock read and no record_function with no profiler (checked in the
    fixture); the traced run's files are the same bytes."""
    off, on = meta_runs[:2]
    for suf in FILES:
        suf = "_sample0" + suf
        with open(off + suf, "rb") as a, open(on + suf, "rb") as b:
            assert a.read() == b.read(), suf


def test_metagenome_loop_spans_and_counters(meta_runs):
    """The loop's spans and the worker's replay and emit spans record;
    `species.lengths`, `species.assign` and `dispatch.program` lie inside a
    batch's `dispatch`, one each a batch the loop dispatched, which
    `species.batches` counts (the unaligned pass counts only
    `batches.dispatched`); `species.segments` counts every
    segment the packing assigned, `species.kept_previous` the later segments
    that stayed in their read's species."""
    rows, counts, own, segments = meta_runs[2:6]
    names = {r[0] for r in rows}
    assert META_LOOP | META_WORKER <= names
    assert min(own.values()) >= 0.0
    n_batches = len(segments)
    for span in ("species.lengths", "species.assign"):
        inner = [r for r in rows if r[0] == span]
        assert len(inner) == n_batches and all(r[3] == 1 for r in inner)
    assert counts["species.batches"] == n_batches
    loop = sorted((r for r in rows if r[0] == "dispatch" and r[4] is not None
                   and any(s[0] == "species.assign" and r[1] <= s[1] <= s[2] <= r[2]
                           for s in rows)), key=lambda r: r[1])
    assert len(loop) == n_batches
    assert [r[4] for r in loop] == [b * BATCH for b in range(n_batches)]
    for r in loop:
        inner = [s for s in rows if s[0] == "dispatch.program" and r[1] <= s[1] <= s[2] <= r[2]]
        assert len(inner) == 1 and inner[0][3] == r[3] + 1
    assert counts["batches.dispatched"] >= n_batches
    assert counts["species.segments"] == sum(segments) > n_batches * BATCH
    assert 0 < counts["species.kept_previous"] < counts["species.segments"] - n_batches * BATCH
