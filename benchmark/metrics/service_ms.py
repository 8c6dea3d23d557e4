"""Host time of a global-localization call, ms, from the program's own
spans: the mean of the window's ``global_localization`` requests (the
service's root span, from the call to its return: the standable-cell
search on the host, the capacity's growth and the seeding).  Nothing
where the program does not trace the service as a request."""

from benchmark import program_spans


def read(trace):
    w = program_spans.window(trace)
    if w is None:
        return None
    calls = [r.end - r.start for r in w[0] if r.parent == 0
             and r.value is None and r.name == "global_localization"]
    return 1e-6 * sum(calls) / len(calls) if calls else None
