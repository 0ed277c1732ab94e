"""Host milliseconds rank 0 waits in the program's span `exchange` (the gloo collectives of the
accept counts, where the rank waits for the slowest one), self time, per batch dispatched by its
accept loop (`batches.dispatched`)."""

from gpubench.harness.program_spans import ms_per_batch


def read(run):
    return ms_per_batch("exchange", "batches.dispatched")
