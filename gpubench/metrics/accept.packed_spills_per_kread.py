"""Chimeric batches re-run unpacked because their active segments overflowed
the packed walk lanes (`RUN_STATS.packed_spills`), per thousand reads."""


def read(run):
    if not run.reads:
        return None
    return 1000.0 * run.counters["packed_spills"] / run.reads
