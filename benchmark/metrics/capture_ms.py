"""Time a scan spends warming up and capturing the step's graphs, ms,
from the program's own spans: the window's ``step.warm_up`` (the eager
first step at a key) and ``step.capture_a`` and ``step.capture_b`` (the
graphs' captures) summed and divided by the window's scans."""

from benchmark import program_spans

NAMES = ("step.warm_up", "step.capture_a", "step.capture_b")


def read(trace):
    w = program_spans.window(trace)
    if w is None:
        return None
    recs, scans = w
    return 1e3 * program_spans.seconds(recs, NAMES) / scans
