"""Host milliseconds in the program's span `emit.format` (inside the C++ formatter's
`NativeEmitter.emit_*`: reconstruction or decoding, records and error-log rows), self time,
per batch fetched (`batches.fetched`)."""

from gpubench.harness.program_spans import ms_per_batch


def read(run):
    return ms_per_batch("emit.format", "batches.fetched")
