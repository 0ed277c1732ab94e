"""Device operations (kernels, copies, sets) in the trace per batch
dispatched in the traced window."""


def read(run):
    if run.trace is None or not run.batches_dispatched:
        return None
    return run.trace["device_ops"] / run.batches_dispatched
