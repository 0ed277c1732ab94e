"""K1's share of its roofline: the operations bound of the steps its
launches walked (rooflines/k1.py) over its device time in the trace."""


def read(run):
    return run.roofline_percent("k1")
