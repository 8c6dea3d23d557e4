"""Share of the profiled slice in which no operation ran on the device,
%: one less the union of the device's operation intervals over the
slice's length, from ``torch.profiler``."""


def read(trace):
    prof = trace["prof"]
    if prof is None or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
