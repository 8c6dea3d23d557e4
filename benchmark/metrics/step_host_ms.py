"""Host time of a measurement step, ms, from the program's own spans:
the window's ``step`` spans (in the fleet, each robot's) less the host
reads (``read.fits``, ``read.box``), the first step at a key
(``step.warm_up``) and the captures (``step.capture_a``,
``step.capture_b``) inside them, the mean a step.  What is left is the
host's work of launching the step: draws, the copy into the graphs'
buffers, the replays, the eager remainder and the copy out."""

from benchmark import program_spans


def read(trace):
    w = program_spans.window(trace)
    if w is None:
        return None
    host_s, n = program_spans.step_host_seconds(w[0])
    return 1e3 * host_s / n if n else None
