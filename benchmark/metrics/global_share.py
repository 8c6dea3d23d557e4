"""Share of the window's measurement steps that ran in global mode, %:
the window's ``step`` spans that hold the program's ``global.slots``
counter (a global-mode step's slot bucket) over all of them.  Nothing
where the program does not trace the global-localization service as a
request (it then records no such counter either)."""

from benchmark import program_spans


def read(trace):
    w = program_spans.window(trace)
    if w is None:
        return None
    recs = w[0]
    if not any(r.parent == 0 and r.name == "global_localization"
               for r in recs):
        return None
    outer, _ = program_spans.steps(recs)
    if not outer:
        return None
    ids = {r.id for r in outer}
    marked = {r.parent for r in recs
              if r.name == "global.slots" and r.value is not None
              and r.parent in ids}
    return 100.0 * len(marked) / len(outer)
