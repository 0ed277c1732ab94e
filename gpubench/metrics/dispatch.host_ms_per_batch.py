"""Host milliseconds in the passes' dispatch closures (queuing a batch's
program on the card) per batch dispatched."""


def read(run):
    n = run.batches_dispatched
    return 1e3 * run.self_s.get("dispatch", 0.0) / n if n else None
