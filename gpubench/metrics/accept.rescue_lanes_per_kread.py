"""Lanes re-run through the overflow rescue (`RUN_STATS.overflow_rescue_lanes`)
per thousand reads written in the traced window."""


def read(run):
    if not run.reads:
        return None
    return 1000.0 * run.counters["overflow_rescue_lanes"] / run.reads
