"""Host milliseconds in the program's span `emit.replay` (the host's C++ walk replays:
`CompactFetcher._replay_events`, the chimeric segment and gap replays), self time, per batch
fetched (`batches.fetched`)."""

from gpubench.harness.program_spans import ms_per_batch


def read(run):
    return ms_per_batch("emit.replay", "batches.fetched")
