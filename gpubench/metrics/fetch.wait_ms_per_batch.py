"""Host milliseconds in the batch handles' fetch (waiting for the device and
reading the batch back) per batch consumed."""


def read(run):
    n = run.batches_consumed
    return 1e3 * run.self_s.get("fetch", 0.0) / n if n else None
