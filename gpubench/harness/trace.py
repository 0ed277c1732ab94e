"""The device trace of a traced run, and what the per-layer metrics read
from it.

`torch.profiler` records the device's activity (kernels, copies, sets) over
the traced window.  The reduction keeps:

* busy seconds: the union of the device's activity intervals, so that
  overlapping records are counted once;
* device operations, and each kernel's device seconds and record count by
  name;
* the idle gaps of the device inside the window, each put down to the host
  span (of the benchmark's spans) that covers the gap's middle.

Host spans use `time.perf_counter_ns`, the trace its own clock: the two are
tied by one `cudaDeviceSynchronize`, whose runtime record starts when the
host clock was read.  The tracer drops device records that fall outside the
window as it reads it on the host, so the window is padded with idle time
at both ends; that padding is not part of the window's length.
"""

from __future__ import annotations

import importlib
import time

PAD_S = 0.02


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.sync_host_ns = None
        self.t0_ns = self.t1_ns = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        time.sleep(PAD_S)
        self.wall_offset_ns = time.time_ns() - time.perf_counter_ns()
        self.sync_host_ns = time.perf_counter_ns()
        torch.cuda.synchronize()
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.t1_ns = time.perf_counter_ns()
        time.sleep(PAD_S)
        self.prof.stop()
        return False

    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def summary(self, spans) -> dict:
        """busy_s, window_s, device_ops, kernels {name: [seconds, records]},
        top_ops [[name, seconds]], idle_gaps [[host span, seconds]]."""
        from torch.autograd import DeviceType

        events = self.prof.profiler.kineto_results.events()
        syncs, dev = [], []
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            elif e.name() == "cudaDeviceSynchronize":
                syncs.append(e.start_ns())
        # the window's first synchronisation is the benchmark's own; without
        # one, the tracer's clock is the wall clock
        offset = min(syncs) - self.sync_host_ns if syncs else self.wall_offset_ns
        w0, w1 = self.t0_ns + offset, self.t1_ns + offset
        dev = [d for d in dev if d[1] > w0 and d[0] < w1]
        kernels = {}
        for s, e, name in dev:
            k = kernels.setdefault(name, [0.0, 0])
            k[0] += (min(e, w1) - max(s, w0)) / 1e9
            k[1] += 1
        busy, gaps, cur_s, cur_e = 0, [], w0, w0
        for s, e, _ in sorted(dev):
            s, e = max(s, w0), min(e, w1)
            if s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s = s
            cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        if cur_e < w1:
            gaps.append((cur_e, w1))
        top = sorted(([n, v[0]] for n, v in kernels.items()), key=lambda r: -r[1])[:10]
        return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9, "device_ops": len(dev),
                "kernels": kernels, "top_ops": [[short_name(n), s] for n, s in top],
                "idle_gaps": _gaps_by_span(gaps, spans, offset)}


def short_name(name: str) -> str:
    """A device op's name without the namespaces and launch boilerplate that
    every elementwise kernel shares, cut to 120 characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "std::array<char*, "):
        name = name.replace(noise, "")
    return name[:120]


def _gaps_by_span(gaps, spans, offset_ns: int) -> list:
    """Idle seconds by the innermost host span covering each gap's middle."""
    rows = sorted(spans.rows, key=lambda r: r[1])
    starts = [r[1] for r in rows]
    import bisect

    by = {}
    for s, e in gaps:
        mid = ((s + e) / 2 - offset_ns) / 1e9
        name, depth = "no span (harness, job set-up, passes' ends)", -1
        i = bisect.bisect_right(starts, mid)
        # spans are short next to a run: look back over the latest few
        for r in rows[max(0, i - 64):i]:
            if r[1] <= mid < r[2] and r[3] > depth:
                name, depth = r[0], r[3]
        by[name] = by.get(name, 0.0) + (e - s) / 1e9
    return sorted(([n, v] for n, v in by.items()), key=lambda r: -r[1])[:10]


class Launches:
    """During the traced window, the launches of each kernel that has a
    roofline file, recorded by wrapping the program module's launcher
    (`MODULE.FUNCTION` of rooflines/<kernel>.py) and put back after."""

    def __init__(self, rooflines: dict):
        self.rooflines = rooflines  # kernel -> roofline module
        self.seen = {k: [] for k in rooflines}
        self._undo = []

    def __enter__(self):
        for kernel, rl in self.rooflines.items():
            mod = importlib.import_module(rl.MODULE)
            plain = getattr(mod, rl.FUNCTION)
            seen = self.seen[kernel]

            def wrapped(*args, _plain=plain, _rl=rl, _seen=seen, **kwargs):
                out = _plain(*args, **kwargs)
                _seen.append(_rl.describe(args, out))
                return out

            # the launcher counts its launches on the module's attribute of
            # its own name, which is now the wrapper: the counts move over
            # and back
            for attr in ("launches", "launches_by_shape", "launches_by_width"):
                if hasattr(plain, attr):
                    setattr(wrapped, attr, getattr(plain, attr))
            setattr(mod, rl.FUNCTION, wrapped)
            self._undo.append((mod, rl.FUNCTION, plain, wrapped))
        return self

    def __exit__(self, *exc):
        for mod, name, plain, wrapped in reversed(self._undo):
            for attr in ("launches", "launches_by_shape", "launches_by_width"):
                if hasattr(wrapped, attr):
                    setattr(plain, attr, getattr(wrapped, attr))
            setattr(mod, name, plain)
        self._undo = []
        return False


def roofline_percent(rl, launches: list, kernels: dict):
    """100 x (mean bound of the launches) / (mean device time of the
    kernel's records in the trace), or None when either is missing.  Means,
    not sums: the tracer can drop a few records of a long window."""
    recs = [v for n, v in kernels.items()
            if rl.TRACE_NAME in n and (rl.TRACE_NOT is None or rl.TRACE_NOT not in n)]
    n_rec = sum(v[1] for v in recs)
    dev_s = sum(v[0] for v in recs)
    if not launches or not n_rec or dev_s <= 0:
        return None
    mean_bound = sum(rl.bound_of(x) for x in launches) / len(launches)
    return 100.0 * mean_bound / (dev_s / n_rec)
