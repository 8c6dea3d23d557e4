"""Host time of the engine's shell a scan, ms, from the program's own
spans: ``scan.accumulate``, ``scan.transform``, ``scan.prepare`` and
``scan.publish`` summed over the window's requests
(``program_spans.window``) and divided by its scans.  A sum of the
shell's pieces, not ``push_cloud`` less ``step``: the host's wait for
the step's outputs (``read.aux``) is not the shell's."""

from benchmark import program_spans

SHELL = ("scan.accumulate", "scan.transform", "scan.prepare",
         "scan.publish")


def read(trace):
    w = program_spans.window(trace)
    if w is None:
        return None
    recs, scans = w
    return 1e3 * program_spans.seconds(recs, SHELL) / scans
