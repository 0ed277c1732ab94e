"""Host milliseconds in the program's span `dispatch.program` (queuing a batch's program: the
batch functions' Python and launches, the overflow rescue's too), self time, per batch
dispatched by the accept loop (`batches.dispatched`)."""

from gpubench.harness.program_spans import ms_per_batch


def read(run):
    return ms_per_batch("dispatch.program", "batches.dispatched")
