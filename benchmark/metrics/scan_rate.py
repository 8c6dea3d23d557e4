"""Updates a second over a traced run's window: the updates completed
over the window's whole time, as the end-to-end rate counts them, but
with the spans' device waits inside the window (so below an untraced
run's rate).  Read per layer where the rate spreads too widely from run
to run to be held to a bound, as in a cell whose captures give back and
take again gigabytes of the allocator's cache."""


def read(trace):
    if not trace.get("window_s") or not trace.get("updates"):
        return None
    return trace["updates"] / trace["window_s"]
