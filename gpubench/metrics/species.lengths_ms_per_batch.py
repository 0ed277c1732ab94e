"""Host milliseconds in the program's span `species.lengths` (the metagenome loop waiting for
phase A's segment counts and lengths from the card before it can pack the batch's species),
self time, per batch of the accept loop (`species.batches`: the unaligned pass dispatches
batches too, and counts none)."""

from gpubench.harness.program_spans import ms_per_batch


def read(run):
    return ms_per_batch("species.lengths", "species.batches")
