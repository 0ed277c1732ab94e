"""Host milliseconds in the program's span `fetch.copy` (every device-to-host copy on the fetch
and emit path, so the wait for the stream's queued work: the compact buffer, the chimeric
metadata, the quality and -hp tables), self time, per batch fetched (`batches.fetched`,
rescue batches included)."""

from gpubench.harness.program_spans import ms_per_batch


def read(run):
    return ms_per_batch("fetch.copy", "batches.fetched")
