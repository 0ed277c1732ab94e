"""Host milliseconds in the program's span `emit.write` (handing the formatted bytes to the
writers' file objects, which in the benchmark are its sinks), self time, per batch fetched
(`batches.fetched`)."""

from gpubench.harness.program_spans import ms_per_batch


def read(run):
    return ms_per_batch("emit.write", "batches.fetched")
