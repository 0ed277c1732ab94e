"""The four-rank cell at a tiny size on the CPU: four gloo ranks, batch 64,
16 lanes a rank.  Its traced job reads the exchange on rank 0, and the run
fails, and fails fast, where a rank is at fault: rank 0's numbering shifted
by one is not correct, and a rank killed mid-job ends the run within the
stall limit with the rank's own last lines."""

import time

import pytest
from torch.profiler import ProfilerActivity, profile

from gpubench.harness import bench
from gpubench.modes import genome as genome_mode
from gpubench.modes import genome_ranks

from .conftest import tiny_sizes

CELL = "human_chr21_dna.fastq.ranks4"
SEED = 2**33 + 13


def _run(seed=SEED, traced=False):
    _, config, _ = bench.cell_parts(CELL)
    return bench.run(CELL, seed, 0.5, traced, device="cpu", sizes=tiny_sizes(config),
                     log=lambda m: None)


def _no_rank_left(ranks):
    import torch.distributed as dist

    assert all(r.proc.poll() is not None for r in ranks)
    assert not dist.is_initialized()


@pytest.fixture
def ranks(monkeypatch):
    """The rank processes rank 0 starts, as it starts them."""
    made = []
    init = genome_ranks._Rank.__init__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    monkeypatch.setattr(genome_ranks._Rank, "__init__", record)
    return made


def test_traced_job_reads_the_exchange_on_rank_0(monkeypatch, ranks):
    """Rank 0's traced job under a CPU-only profiler, as the card's run holds
    it under `trace.DeviceTrace`: the exchange metric reads a positive
    number, its span and counter come from the program's collectives, and
    the ranks are gone when the run is."""
    from nanosim_tpu_torch import tracing

    plain = genome_mode.GenomeMode.run_job
    jobs = []

    def run_job(self, *args, **kwargs):
        jobs.append(1)
        if len(jobs) == 1:  # the warm-up, untraced as on the card
            return plain(self, *args, **kwargs)
        with profile(activities=[ProfilerActivity.CPU]):
            return plain(self, *args, **kwargs)

    monkeypatch.setattr(genome_mode.GenomeMode, "run_job", run_job)
    result, record = _run(traced=True)
    assert result["correct"]
    counts = tracing.RECORDER.counts
    assert counts["exchange.rounds"] == counts["batches.dispatched"] > 0
    read = bench.metric_reader("exchange.wait_ms_per_batch").read(record)
    assert read is not None and read > 0
    assert result["metrics"]["exchange.wait_ms_per_batch"]["value"] == read
    assert len(ranks) == 3
    _no_rank_left(ranks)


def test_fault_rank0_numbering_shifted_is_caught(monkeypatch, ranks):
    """Rank 0 numbers its reads one later than its offset: the merged map of
    the four ranks is broken and rank 0's kept reads carry other names."""
    from nanosim_tpu_torch.parallel import multihost

    numbered = multihost.shard_sim_batch_numbered

    def shifted(*args, **kwargs):
        step = numbered(*args, **kwargs)

        def call(*a, **kw):
            out, offsets, *rest = step(*a, **kw)
            return (out, offsets + 1, *rest)

        return call

    monkeypatch.setattr(multihost, "shard_sim_batch_numbered", shifted)
    result, _ = _run()
    assert not result["correct"]
    assert result["checks"]["order_faults"]["value"] > 0
    assert result["checks"]["mismatched_reads"]["value"] > 0
    _no_rank_left(ranks)


def test_fault_rank_killed_mid_job_ends_the_run(monkeypatch, ranks):
    """Rank 2 killed before rank 0's eighth exchange (in the window's first
    job): the run raises within the stall limit, naming the rank, and
    leaves no rank and no process group behind."""
    from nanosim_tpu_torch.parallel import mesh

    gather = mesh.HostGroup.gather
    calls = []

    def killing(self, value):
        calls.append(1)
        if len(calls) == 8:
            ranks[1].proc.kill()
        return gather(self, value)

    monkeypatch.setattr(mesh.HostGroup, "gather", killing)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[2\] exited"):
        _run()
    assert time.monotonic() - t0 < genome_ranks.STALL_S
    assert len(calls) >= 8
    _no_rank_left(ranks)
