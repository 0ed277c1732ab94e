"""Host milliseconds in the program's span `emit.names` (the read names, built in Python), self
time, per batch fetched (`batches.fetched`)."""

from gpubench.harness.program_spans import ms_per_batch


def read(run):
    return ms_per_batch("emit.names", "batches.fetched")
