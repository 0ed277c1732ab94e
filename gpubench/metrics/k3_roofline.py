"""K3's share of its roofline: the bytes bound of its launches
(rooflines/k3.py) over its device time in the trace."""


def read(run):
    return run.roofline_percent("k3")
