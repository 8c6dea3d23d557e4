"""Share of the window's measurement steps whose likelihood and beam
models both ran at tier 0 (the grouped kernels), %: the tiers each
step's ``aux`` reports."""


def read(trace):
    if not trace["steps"]:
        return None
    return 100.0 * trace["steps_00"] / trace["steps"]
