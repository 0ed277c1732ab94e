"""The program's own spans and counters (`nanosim_tpu_torch.tracing`), as
the per-layer metrics read them after a traced run.

The program records only while a torch profiler session runs; in a run of
the benchmark that is the traced job alone (`trace.DeviceTrace`), so its
recorder then holds that job.  A program without the tracer gives nothing.
"""

from __future__ import annotations


def ms_per_batch(span: str, per: str):
    """1e3 x the span's self seconds over the counter `per`, or None where
    the program has no tracer, the span did not run or nothing was counted."""
    try:
        from nanosim_tpu_torch.tracing import RECORDER
    except ImportError:
        return None
    n = RECORDER.counts.get(per, 0)
    s = RECORDER.self_seconds().get(span)
    if not n or s is None:
        return None
    return 1e3 * s / n
