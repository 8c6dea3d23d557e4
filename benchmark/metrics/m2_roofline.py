"""Kernel M2's share of its roofline, %: the least time of one launch at
the cell's shapes (``roofline/m2.py``) over M2's mean device time a
launch in the profiled slice.  Nothing when M2 did not run there."""

from benchmark import harness


def read(trace):
    return harness.roofline_share(trace, "m2")
