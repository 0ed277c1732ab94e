"""1 - (union of the device's activity) / (the traced window)."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 1.0 - run.trace["busy_s"] / run.trace["window_s"]
