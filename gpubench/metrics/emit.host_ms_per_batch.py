"""Host milliseconds in the writers' batch calls, less the fetch inside them
(walk replay, read reconstruction, formatting, the Python -hp log, the
writes to the sink), per batch consumed."""


def read(run):
    n = run.batches_consumed
    return 1e3 * run.self_s.get("emit", 0.0) / n if n else None
