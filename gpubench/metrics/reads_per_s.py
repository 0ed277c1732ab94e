"""Reads of every job begun in the window, over the time from the first
job's start to the last job's end (the host's clock)."""


def read(run):
    if run.traced or run.window_s <= 0:
        return None
    return run.reads / run.window_s
