"""Host milliseconds in the program's span `species.assign` (the metagenome's greedy base-quota
species packing of a batch's segments, a Python loop), self time, per batch of the accept loop
(`species.batches`: the unaligned pass dispatches batches too, and counts none)."""

from gpubench.harness.program_spans import ms_per_batch


def read(run):
    return ms_per_batch("species.assign", "species.batches")
