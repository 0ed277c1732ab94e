"""Host milliseconds in the program's span `emit.queue_wait` (the metagenome loop blocked
handing a batch's replay and emit to the emit worker, whose queue is full), self time, per
batch of the accept loop (`species.batches`: the unaligned pass dispatches batches too, and
counts none)."""

from gpubench.harness.program_spans import ms_per_batch


def read(run):
    return ms_per_batch("emit.queue_wait", "species.batches")
