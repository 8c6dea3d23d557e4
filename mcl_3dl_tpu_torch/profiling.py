"""Lightweight tracing and profiling.

The reference logs wall-clock spans around the measurement and the map
updates ("MCL (%0.3f sec.)", src/mcl_3dl.cpp:361, 827-829, 1374-1376).
``Spans`` is a span registry with the same role; ``trace_to`` runs a
callable under ``torch.profiler`` and writes a Chrome trace.

After a ``torch.profiler`` session the host path of every later CUDA
launch in the same process reads slower, so profile last, or in a
process of its own, and never time other work after it.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List


class Spans:
    """Named wall-clock span accumulator."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.last: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.last[name] = dt

    def summary(self) -> List[str]:
        out = []
        for name in sorted(self.totals):
            n = self.counts[name]
            out.append(
                f"{name}: total {self.totals[name]:.3f}s over {n} "
                f"({self.totals[name] / n * 1e3:.2f} ms avg, "
                f"last {self.last[name] * 1e3:.2f} ms)"
            )
        return out


def trace_to(logdir: str, fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under ``torch.profiler`` (the CPU, and
    CUDA where there is a device) and write the Chrome trace to
    ``logdir/trace.json``; returns ``fn``'s result."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        out = fn(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    return out
