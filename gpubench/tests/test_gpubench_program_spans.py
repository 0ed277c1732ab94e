"""The per-layer metrics read from the program's own spans, at a tiny size on
the CPU: the traced job of each cell run under a CPU-only profiler, as the
card's run holds it under `trace.DeviceTrace`.  Each metric that lists the
cell reads a positive number there, and none reads anything from a program
without the tracer."""

import sys

import pytest
from torch.profiler import ProfilerActivity, profile

from gpubench.harness import bench, program_spans
from gpubench.modes import genome as genome_mode

from .conftest import tiny_sizes

CELLS = [w["name"] for w in bench.benchmark()["workloads"]]
SEED = 2**33 + 11


def _program_metrics():
    """{metric: entry} of the metrics that read the program's tracer."""
    out = {}
    for m in bench.benchmark()["per_layer"]:
        with open(f"{bench.HERE}/metrics/{m['name']}.py") as f:
            if "program_spans" in f.read():
                out[m["name"]] = m
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_each_listed_metric_reads_a_positive_number(cell, monkeypatch):
    plain = genome_mode.GenomeMode.run_job
    jobs = []

    def run_job(self, *args, **kwargs):
        jobs.append(1)
        if len(jobs) == 1:  # the warm-up, untraced as on the card
            return plain(self, *args, **kwargs)
        with profile(activities=[ProfilerActivity.CPU]):
            return plain(self, *args, **kwargs)

    monkeypatch.setattr(genome_mode.GenomeMode, "run_job", run_job)
    _, config, _ = bench.cell_parts(cell)
    result, record = bench.run(cell, SEED, 0.5, True, device="cpu", sizes=tiny_sizes(config),
                               log=lambda m: None)
    assert result["correct"]
    metrics = _program_metrics()
    assert len(metrics) == 9
    for name, m in metrics.items():
        read = bench.metric_reader(name).read(record)
        if cell in m["workloads"]:
            assert read is not None and read > 0, name
            assert result["metrics"][name]["value"] == read
        else:
            assert read is None, name


def test_a_program_without_the_tracer_gives_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "nanosim_tpu_torch.tracing", None)
    assert program_spans.ms_per_batch("emit.format", "batches.fetched") is None
    for name in _program_metrics():
        assert bench.metric_reader(name).read(None) is None
