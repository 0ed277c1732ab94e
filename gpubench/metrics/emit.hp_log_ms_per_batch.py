"""Host milliseconds in the program's span `emit.hp_log` (the -hp ground-truth log built in
Python, `_hp_log_bytes`), self time, per batch fetched (`batches.fetched`)."""

from gpubench.harness.program_spans import ms_per_batch


def read(run):
    return ms_per_batch("emit.hp_log", "batches.fetched")
