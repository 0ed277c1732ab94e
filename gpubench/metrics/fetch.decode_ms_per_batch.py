"""Host milliseconds in the program's span `fetch.decode` (`decode_compact`,
`decode_chimeric_meta`), self time, per batch fetched (`batches.fetched`)."""

from gpubench.harness.program_spans import ms_per_batch


def read(run):
    return ms_per_batch("fetch.decode", "batches.fetched")
