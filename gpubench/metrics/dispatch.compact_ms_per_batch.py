"""Host milliseconds in the program's span `dispatch.compact` (queuing the compaction program:
`CompactFetcher._dispatch`, `pack_chimeric_meta`, repacks and the replay fallback's too), self
time, per batch dispatched by the accept loop (`batches.dispatched`)."""

from gpubench.harness.program_spans import ms_per_batch


def read(run):
    return ms_per_batch("dispatch.compact", "batches.dispatched")
