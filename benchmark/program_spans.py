"""The program's own spans and counters (``mcl_3dl_tpu_torch.profiling.
spans``, its tracer), cut to a traced run's window, for the per-layer
metrics that read them.

The window's requests (a request is one top-level call into the
program, and every span of it carries the request's id):

* one robot (``cells.single``): from the request after the warm-up's
  last ``push_cloud`` through the window's last ``push_cloud``.  The
  window's ``push_cloud`` requests are the last ``scans + profiled`` of
  them less the last ``profiled``: the profiled slice pushes the
  configuration's ``profile.scans`` clouds after the window (none where
  no slice ran);
* the fleet (``cells.fleet``): the last ``scans + 1`` ``fleet_step``
  requests less the last, the profiled part of the fleet (none less
  where no slice ran).

Every reader returns ``None`` where the program keeps no records (a
program without the tracer, or run with ``MCL3DL_TRACE=0``), so a metric
of them is left out of the result line there.
"""

from __future__ import annotations

from benchmark import harness

READS = ("read.fits", "read.box")
# a step's spans that are not its host work: host reads (the host waits
# for the device there), the first step at a key and the captures
NOT_HOST = READS + ("step.warm_up", "step.capture_a", "step.capture_b")


def records():
    """The program tracer's records, oldest first, or ``None``."""
    try:
        from mcl_3dl_tpu_torch import profiling
    except ImportError:
        return None
    tracer = getattr(profiling, "spans", None)
    if tracer is None or not hasattr(tracer, "records"):
        return None
    return tracer.records() or None


def _roots(recs, name):
    return sorted({r.request for r in recs
                   if r.parent == 0 and r.name == name and r.request})


def single_window(recs, scans: int, profiled: int):
    """``(records of the window's requests, its push_cloud count)`` of a
    one-robot run, or ``None``."""
    pushes = _roots(recs, "push_cloud")
    k = len(pushes) - profiled
    if scans <= 0 or k - scans < 0:
        return None
    lo = pushes[k - scans - 1] if k - scans >= 1 else 0
    hi = pushes[k - 1]
    return [r for r in recs if lo < r.request <= hi], scans


def fleet_window(recs, scans: int, profiled: bool):
    """``(records of the window's fleet steps, their count)``, or
    ``None``."""
    steps = _roots(recs, "fleet_step")
    k = len(steps) - int(profiled)
    if scans <= 0 or k - scans < 0:
        return None
    keep = set(steps[k - scans:k])
    return [r for r in recs if r.request in keep], scans


def window(trace):
    """The window of a traced run's ``trace`` (``run.py``): ``(records,
    scans or fleet steps)``, or ``None``."""
    recs = records()
    if recs is None:
        return None
    bench = harness.load_benchmark(harness.HERE.parent)
    cfg = harness.config(harness.workload(bench, trace["cell"])["config"])
    ran = trace["prof"] is not None
    if "scans" in cfg["profile"]:
        return single_window(recs, trace["scans"],
                             cfg["profile"]["scans"] if ran else 0)
    return fleet_window(recs, trace["scans"], ran)


def seconds(recs, names) -> float:
    """Summed duration of the spans named ``names``."""
    return sum(r.end - r.start for r in recs
               if r.value is None and r.name in names) * 1e-9


def _within_step(r, by_id):
    """The names of the spans between ``r`` and the step enclosing it,
    or ``None`` where no step encloses it."""
    names = []
    p = by_id.get(r.parent)
    while p is not None:
        if p.name == "step":
            return names
        names.append(p.name)
        p = by_id.get(p.parent)
    return None


def steps(recs):
    """``(step spans, the records nested in one)``: the measurement steps
    (in the fleet, each robot's) and what ran inside them."""
    by_id = {r.id: r for r in recs}
    outer = [r for r in recs if r.name == "step" and r.value is None]
    inside = [r for r in recs if _within_step(r, by_id) is not None]
    return outer, inside


def step_host_seconds(recs):
    """``(host seconds, steps)``: the steps' time less the outermost of
    their ``NOT_HOST`` spans (a read inside a warm-up is cut once)."""
    by_id = {r.id: r for r in recs}
    outer = [r for r in recs if r.name == "step" and r.value is None]
    cut = 0
    for r in recs:
        if r.value is None and r.name in NOT_HOST:
            up = _within_step(r, by_id)
            if up is not None and not set(up) & set(NOT_HOST):
                cut += r.end - r.start
    return (sum(r.end - r.start for r in outer) - cut) * 1e-9, len(outer)
