"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell is made of is found by name: the cell in BENCHMARK.json,
its configuration in configs/<config>.json, its traffic mix in
traffic/<traffic>.json, the mode that drives it in modes/<mode>.py, each
metric's reader in metrics/<metric>.py, each kernel's roofline arithmetic
in rooflines/<kernel>.py.  A new cell, mix, configuration or metric is new
files and new entries, and no edit here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import tempfile
import time

import numpy as np

from . import judge, trace
from .sink import Capture
from .spans import Spans

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # gpubench/
ROOT = os.path.dirname(HERE)  # the checkout
BANNED = ("jax", "jaxlib", "flax", "nanosim_tpu")
KERNEL_METRIC_SUFFIX = "_roofline"
PROGRAM_BUILD_DIR = os.path.join(ROOT, "nanosim_tpu_torch", "_build")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell_parts(name: str, bench: dict = None):
    """(cell, config, traffic) of the cell `name`."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    return (cell, load_json(HERE, "configs", cell["config"] + ".json"),
            load_json(HERE, "traffic", cell["traffic"] + ".json"))


def _load_file(kind: str, name: str):
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"gpubench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    return _load_file("metrics", name)


def roofline(kernel: str):
    return importlib.import_module(f"gpubench.rooflines.{kernel}")


def banned_modules(modules) -> list:
    """Loaded modules whose top-level name is one the benchmark must not load."""
    return sorted({m for m in modules if m.split(".", 1)[0] in BANNED})


def derive_seed(seed: int, *parts) -> int:
    """A 63-bit seed of (seed, parts), for the inputs and the jobs."""
    hi, lo = np.random.SeedSequence([seed & (2**64 - 1), *parts]).generate_state(2, np.uint32)
    return (int(hi) << 31 | int(lo)) % 2**63


class RunRecord:
    """What the metric readers read."""

    def __init__(self):
        self.traced = False
        self.setup_s = 0.0
        self.setup_parts = {}
        self.built = []
        self.window_s = 0.0
        self.reads = 0
        self.self_s = {}
        self.batches_dispatched = 0
        self.batches_consumed = 0
        self.counters = {}
        self.trace = None
        self.launches = {}
        self.peak_bytes = 0
        self.jobs = []

    def roofline_percent(self, kernel: str):
        if self.trace is None or kernel not in self.launches:
            return None
        return trace.roofline_percent(roofline(kernel), self.launches[kernel],
                                      self.trace["kernels"])


def _stats():
    from nanosim_tpu_torch.sim.output import RUN_STATS

    return {"overflow_rescue_lanes": RUN_STATS.overflow_rescue_lanes,
            "checksum_fallback_lanes": RUN_STATS.checksum_fallback_lanes,
            "packed_spills": RUN_STATS.packed_spills}


def mode_module(traffic: dict):
    """The module of gpubench/modes/ that drives the traffic's mode: it makes
    the inputs (`make_inputs`), loads the program's libraries
    (`load_libraries`), builds the program (`Mode`) and the plain reference
    (`reference`)."""
    return importlib.import_module(f"gpubench.modes.{traffic['mode']}")


def _build_files() -> dict:
    """Files under the program's build directory, with their times: what a
    checkout's first run builds (kernel libraries, the native writer, the
    tables of a model the program has not seen)."""
    out = {}
    for d, _, files in os.walk(PROGRAM_BUILD_DIR):
        for f in files:
            path = os.path.join(d, f)
            out[os.path.relpath(path, PROGRAM_BUILD_DIR)] = os.path.getmtime(path)
    return out


class SetupClock:
    """Seconds of each part of set-up, the first counted from the process's start."""

    def __init__(self, t_start: float):
        self.last = t_start
        self.parts = {}

    def mark(self, name: str):
        now = time.perf_counter()
        self.parts[name] = now - self.last
        self.last = now


def run(cell_name: str, seed: int, seconds: float, traced: bool, *, device: str = "cuda",
        t_start: float = None, sizes: dict = None, log=print) -> dict:
    """One run of the cell.  `sizes` (tests only) shrinks the genome, the
    model's lengths, the jobs and the batch."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    clock = SetupClock(t_start)
    clock.mark("imports")
    sizes = sizes or {}
    bench = benchmark()
    cell, config, traffic = cell_parts(cell_name, bench)
    mode_mod = mode_module(traffic)
    on_card = device == "cuda"
    if on_card:
        torch.empty(1, device=device)
        torch.cuda.synchronize()
        clock.mark("cuda")
    record = RunRecord()
    record.traced = traced
    spans, capture = Spans(), Capture()
    with tempfile.TemporaryDirectory(prefix="gpubench-") as workdir:
        inputs = mode_mod.make_inputs(config, seed, workdir, sizes, clock=clock)
        built_before = _build_files()
        if on_card:
            mode_mod.load_libraries()
            clock.mark("libraries")
        job_reads = sizes.get("job_reads", traffic["job_reads"])
        batch = sizes.get("batch", traffic["batch"])
        mode = mode_mod.Mode(config, traffic, inputs, device=device, spans=spans,
                             capture=capture, job_reads=job_reads, batch=batch, clock=clock)
        # the warm-up job: one batch a pass at the cell's own shapes
        mode.run_job(derive_seed(seed, 3, 0),
                     quota={p: min(batch, q) for p, q in mode.quota.items()})
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        clock.mark("warmup")
        after = _build_files()
        record.built = sorted(f for f, t in after.items() if built_before.get(f) != t)
        spans.reset()
        capture.reset()
        stats0 = _stats()
        record.setup_s = time.perf_counter() - t_start
        record.setup_parts = clock.parts
        log(f"set-up {record.setup_s:.3f} s: " + ", ".join(
            f"{k} {v:.3f}" for k, v in clock.parts.items())
            + f"; built {len(record.built)} file(s) {record.built[:8]}")
        log(f"window of {seconds} s, jobs of {job_reads} reads")

        jobs = []
        kernels = [m["name"][:-len(KERNEL_METRIC_SUFFIX)] for m in bench["per_layer"]
                   if m["name"].endswith(KERNEL_METRIC_SUFFIX)]
        rooflines = {k: roofline(k) for k in kernels} if traced and on_card else {}
        t0 = time.perf_counter()
        while not jobs or (not traced and time.perf_counter() - t0 < seconds):
            j = len(jobs)
            job_seed = derive_seed(seed, 4, j)
            wanted = {p: judge.sample_indices(seed, j, p, q, traffic["check"][p])
                      for p, q in mode.quota.items()}
            capture.reset()
            if rooflines:
                with trace.Launches(rooflines) as launches, trace.DeviceTrace() as tr:
                    res = mode.run_job(job_seed, wanted)
                record.launches = launches.seen
            else:
                res = mode.run_job(job_seed, wanted)
            res.update(seed=job_seed, kept=dict(capture.kept))
            jobs.append(res)
        if on_card:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        record.window_s = t1 - t0
        record.reads = sum(sum(j["quota"].values()) for j in jobs)
        stats1 = _stats()
        record.counters = {k: stats1[k] - stats0[k] for k in stats0}
        record.self_s = spans.self_seconds()
        record.batches_dispatched = spans.counts.get("batches.dispatched", 0)
        record.batches_consumed = spans.counts.get("batches.consumed", 0)
        if on_card:
            record.peak_bytes = torch.cuda.max_memory_allocated()
        if rooflines:
            record.trace = tr.summary(spans)
            record.window_s = tr.window_s()
        log(f"window {record.window_s:.3f} s: {len(jobs)} jobs, {record.reads} reads, "
            f"{sum(j['bytes'] for j in jobs)} bytes to the sinks")

        # the check, on the CPU, once the program's state is freed
        del mode
        if on_card:
            torch.cuda.empty_cache()
        check = check_jobs(mode_mod.reference(config, traffic, inputs), jobs, record.counters,
                           log=log)
        record.jobs = jobs

    metric_names = [m["name"] for m in bench["per_layer" if traced else "end_to_end"]
                    if cell_name in m.get("workloads", [cell_name])]
    metrics, units = {}, {m["name"]: m["unit"] for m in bench["per_layer"] + bench["end_to_end"]}
    for name in metric_names:
        value = metric_reader(name).read(record)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    result = {
        "correct": check["correct"],
        "attempted": record.reads,
        "failed": check["failed"],
        "metrics": metrics,
        "device": {},
    }
    if record.trace is not None:
        result["breakdown"] = {"device_ops": record.trace["top_ops"],
                               "idle_gaps": record.trace["idle_gaps"]}
        result["device"].update(busy_s=record.trace["busy_s"],
                                window_s=record.trace["window_s"])
    result["setup"] = {"parts": record.setup_parts, "built": record.built}
    result["checks"] = check["checks"]
    return result, record


def check_jobs(lanes_of: dict, jobs, counters, log=print) -> dict:
    """Every job's passes against the reference (judge.py).  lanes_of: the
    mode's reference, a function (seed, slots) -> lanes for each pass."""
    t = time.perf_counter()
    mismatched = missed = order = checked = 0
    for job in jobs:
        for p, quota in job["quota"].items():
            kept = {i: v for (pp, i), v in job["kept"].items() if pp == p}
            r = judge.judge_pass(lanes_of[p], job["seed"], job["slots"][p],
                                 job["slots"][p + ".contiguous"], quota, kept)
            mismatched += r["mismatched"]
            missed += r["missed"]
            order += r["order_faults"]
            checked += r["checked"]
            if r["mismatched"] or r["missed"] or r["order_faults"]:
                log(f"check: job seed {job['seed']} {p}: {r}")
    fallback = counters.get("checksum_fallback_lanes", 0)
    checks = {
        "mismatched_reads": {"value": mismatched, "limit": 0},
        "missed_reads": {"value": missed, "limit": 0},
        "order_faults": {"value": order, "limit": 0},
        "fallback_lanes": {"value": fallback, "limit": 0},
    }
    correct = checked > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    log(f"check: {checked} reads against the reference in {time.perf_counter() - t:.1f} s")
    return {"correct": correct, "failed": mismatched + missed + fallback, "checks": checks,
            "checked": checked}
