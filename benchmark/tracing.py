"""Spans the benchmark opens around its calls into the program, and the
reduction of a ``torch.profiler`` slice to the device's busy time, its
kernels and its idle gaps.

Spans are kept in memory: a list of durations a name.  The profiled
slice runs last in a traced run (after a profiler session the host path
of later launches reads slower), its host ranges named as the spans are,
and nothing of it is written to disk.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

HOST_RANGES = ("push_cloud", "_step", "odometry", "imu", "initial_pose",
               "global_localization", "fleet_step")


class Spans:
    """Durations (s) by name; ``sync`` ends a span after the device has
    finished the work enqueued inside it."""

    def __init__(self, sync=None):
        self.durations = defaultdict(list)
        self.sync = sync
        self.ranges = False     # also open a profiler range of the name

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        with contextlib.ExitStack() as stack:
            if self.ranges:
                from torch.profiler import record_function
                stack.enter_context(record_function(name))
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if sync and self.sync is not None:
                    self.sync()
                self.durations[name].append(time.perf_counter() - t0)


def wrap(obj, attr: str, spans: Spans, name: str, sync: bool = True):
    """Replace ``obj.attr`` on the instance by a spanned call."""
    inner = getattr(obj, attr)

    def spanned(*a, **k):
        with spans.span(name, sync=sync):
            return inner(*a, **k)

    setattr(obj, attr, spanned)


def profile(fn, device_sync):
    """Run ``fn`` under ``torch.profiler`` (host and CUDA): ``(device
    intervals [(name, start_us, end_us)], host ranges [(name, start_us,
    end_us)], (slice_start_us, slice_end_us))``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function("bench.slice"):
            fn()
            device_sync()
    dev, host, window = [], [], None
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            # the host ranges come back on the device's timeline too, as
            # annotations: they are not device work
            if e.name not in HOST_RANGES and e.name != "bench.slice":
                dev.append((e.name, tr.start, tr.end))
        elif e.name == "bench.slice":
            window = (tr.start, tr.end)
        elif e.name in HOST_RANGES:
            host.append((e.name, tr.start, tr.end))
    return dev, host, window


def reduce(dev, host, window, top=10):
    """``busy_s``, ``window_s``, device time a kernel name, and the
    breakdown: the device operations that took most time and the longest
    idle gaps, each labelled by the innermost host range around it."""
    lo, hi = window
    ivs = sorted((max(s, lo), min(e, hi)) for _, s, e in dev
                 if e > lo and s < hi)
    merged = []
    for s, e in ivs:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_us = sum(e - s for s, e in merged)
    by_name = defaultdict(list)
    for name, s, e in dev:
        by_name[name].append((e - s) * 1e-6)
    gaps, last = [], lo
    for s, e in merged:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if hi > last:
        gaps.append((last, hi))

    def label(t):
        inner = [(e - s, n) for n, s, e in host if s <= t <= e]
        return min(inner)[1] if inner else "harness"

    idle = sorted(((label((s + e) / 2), (e - s) * 1e-6) for s, e in gaps),
                  key=lambda g: -g[1])[:top]
    ops = sorted(((n[:120], sum(v)) for n, v in by_name.items()),
                 key=lambda o: -o[1])[:top]
    return dict(busy_s=busy_us * 1e-6, window_s=(hi - lo) * 1e-6,
                kernels=dict(by_name),
                breakdown={"device_ops": [list(o) for o in ops],
                           "idle_gaps": [list(g) for g in idle]})
