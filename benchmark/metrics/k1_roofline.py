"""Kernel K1's share of its roofline, %: the least time of one launch at
the cell's shapes (``roofline/k1.py``) over K1's mean device time a
launch in the profiled slice.  Nothing when K1 did not run there."""

from benchmark import harness


def read(trace):
    return harness.roofline_share(trace, "k1")
