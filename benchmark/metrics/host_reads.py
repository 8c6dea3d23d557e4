"""Host reads a measurement step (a robot's step in the fleet), from the
program's own spans: the window's ``read.fits`` (the grouping's flags)
and ``read.box`` (the box path's flags) spans over its ``step`` spans.
Each read waits for the device to finish what was launched before it."""

from benchmark import program_spans


def read(trace):
    w = program_spans.window(trace)
    if w is None:
        return None
    outer, inside = program_spans.steps(w[0])
    if not outer:
        return None
    reads = sum(1 for r in inside if r.name in program_spans.READS)
    return reads / len(outer)
