"""The program's tracer: spans and counters at the port's layer
boundaries, and the operator's Chrome-trace exporter.

The reference logs wall-clock spans around the measurement and the map
updates ("MCL (%0.3f sec.)", src/mcl_3dl.cpp:361, 827-829, 1374-1376).
``Spans`` keeps the same role: ``spans.summary()`` prints one line a span
name (total, count, mean and last duration) in the JAX package's format,
then one line a counter.

``spans`` is the program's one instance.  Every span is also a record in
a bounded ring (``RING`` records, the oldest overwritten): its name,
start and end (``time.perf_counter_ns``), its id, the id of the span it
opened inside (0 at the top), the request it belongs to and the fleet
robot it ran for (``None`` outside the fleet).  A request is one
top-level public call, opened by ``spans.request``: ``push_cloud``,
``odometry``, ``imu``, ``initial_pose``, ``global_localization`` or one
fleet step; a public call made inside another one (the fake IMU inside
``odometry``) is a span of the outer request.  Counters
(``spans.count``) are records of a value at the same boundaries.
``spans.records()`` returns the ring, oldest first; nothing writes it
out.

Where the spans are (the names ``PERF.md`` uses):

* ``engine.py``: roots ``push_cloud``, ``odometry``, ``imu``,
  ``initial_pose``, ``global_localization`` (the service:
  ``global.standable``, the standable-cell search on the host, and
  ``global.seed``, capacity growth and the seeding, with counter
  ``global.seeds``, the seed count); counter ``global.slots`` (a
  global-mode step's likelihood slot bucket, once a step, inside
  ``step``); ``capacity.shrink`` (the particle tensors cut back to the
  decayed count's bucket); ``scan.accumulate``, ``scan.transform`` (the
  clouds' concatenation and rotation into the base frame), ``scan``
  (one measurement; ``MeasureResult.elapsed`` is read inside it on the
  same clock, ``now``), ``scan.prepare`` (downsample, padding and the
  step's host inputs),
  ``read.aux`` (the host waiting for the step's outputs), ``scan.publish``
  (the epilogue); ``odometry.predict``, ``imu.weigh``.
* ``predict_graph.py``: in each ``odometry.predict`` and ``imu.weigh``,
  the call's route counter ``predict.graph``, ``predict.warm_up`` or
  ``predict.eager``; ``odometry.capture`` and ``imu.capture`` (with
  ``graph.alloc_retries`` and ``graph.reserved_bytes``).
* ``step_graph.py``: ``step`` (every route), ``step.draws``,
  ``step.load``, ``step.replay_a``, ``step.replay_b``, ``step.remainder``,
  ``step.copy_out``, ``step.warm_up``, ``step.eager``, ``step.capture_a``
  and ``step.capture_b`` (each with counters ``graph.alloc_retries`` and
  ``graph.reserved_bytes``, the caching allocator's retries and reserved
  bytes added across the capture), counter ``graph.drops``;
  ``read.fits`` (the host read of the grouping's flags, ``engine.py``).
* ``models/likelihood.py``: ``read.box``, each host read of the box
  path's flags.
* ``parallel/sharding.py``: root ``fleet_step``, ``fleet.draws`` (a
  robot), ``fleet.stack``.

No span synchronizes the device, records a CUDA event or allocates a
tensor.  ``MCL3DL_TRACE=0`` in the environment turns the program's
tracer off (read when this module is imported; ``spans.enabled`` at run
time): a span then costs one flag check and records nothing, and the
likelihood path no longer counts K1's live tables
(``ops.grouped.count_live_tables``, a counter on the device).

With ``spans.ranges`` on, every span also opens a ``torch.profiler``
range named ``mcl.<span>``; ``trace_to`` turns it on for its run, so
the program's ranges sit on the device's clock in the written trace,
around the kernels they launched and the device's idle gaps.

Once ``torch.profiler`` has run, the host path of every later CUDA
launch in the same process reads slower, so profile last, or in a
process of its own, and never time other work after it.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

RING = 1 << 18
RANGE_PREFIX = "mcl."

now = time.perf_counter_ns   # the tracer's clock, ns


class Record(NamedTuple):
    """One span (``value`` None) or counter (``start == end``)."""

    id: int
    name: str
    start: int          # ns, time.perf_counter_ns
    end: int
    parent: int         # the enclosing span's id; 0 at the top
    request: int        # 0 outside any request
    robot: Optional[int]
    value: Optional[float] = None


class _Off:
    """The span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("tracer", "name", "root", "id", "parent", "t0", "range",
                 "opened")

    def __init__(self, tracer, name, root):
        self.tracer, self.name, self.root = tracer, name, root

    def __enter__(self):
        t = self.tracer
        t._last_id += 1
        self.id = t._last_id
        self.parent = t._open[-1] if t._open else 0
        self.opened = self.root and not t.open_request
        if self.opened:
            t._requests += 1
            t.open_request = t._requests
        t._open.append(self.id)
        self.range = None
        if t.ranges:
            from torch.profiler import record_function
            self.range = record_function(RANGE_PREFIX + self.name)
            self.range.__enter__()
        self.t0 = now()
        return self

    def __exit__(self, *exc):
        t1 = now()
        t = self.tracer
        if self.range is not None:
            self.range.__exit__(*exc)
        t._open.pop()
        t._write((self.id, self.name, self.t0, t1, self.parent,
                  t.open_request, t.robot, None))
        dt = (t1 - self.t0) * 1e-9
        t.totals[self.name] += dt
        t.counts[self.name] += 1
        t.last[self.name] = dt
        if self.opened:
            t.open_request = 0
        return False


class Spans:
    """Named wall-clock spans and counters: totals for ``summary`` and
    records in a ring of ``capacity`` (module docstring).  ``enabled``
    defaults to the environment's ``MCL3DL_TRACE`` (off only at ``0``)."""

    def __init__(self, capacity: int = RING, enabled: Optional[bool] = None):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.last: Dict[str, float] = {}
        self.counters: Dict[str, float] = defaultdict(float)
        self.enabled = (os.environ.get("MCL3DL_TRACE", "1") != "0"
                        if enabled is None else enabled)
        self.ranges = False
        self.open_request = 0     # the open request's id, 0 for none
        self.robot: Optional[int] = None
        self.capacity = capacity
        self._ring: list = [None] * capacity
        self._n = 0               # records ever written
        self._open: list = []
        self._last_id = 0
        self._requests = 0

    def span(self, name: str):
        """A context manager timing ``name``."""
        if not self.enabled:
            return _OFF
        return _Span(self, name, False)

    def request(self, name: str):
        """The root span of a top-level public call: a new request unless
        one is open (then a plain span of it)."""
        if not self.enabled:
            return _OFF
        return _Span(self, name, True)

    def count(self, name: str, value: float = 1) -> None:
        """Record ``value`` under ``name`` at this point of the open
        request."""
        if not self.enabled:
            return
        self.counters[name] += value
        self._last_id += 1
        t = now()
        self._write((self._last_id, name, t, t,
                     self._open[-1] if self._open else 0, self.open_request,
                     self.robot, value))

    def _write(self, rec: tuple) -> None:
        self._ring[self._n % self.capacity] = rec
        self._n += 1

    def records(self) -> List[Record]:
        """The ring's records, oldest first (a span is written when it
        ends, so a span follows the spans it encloses)."""
        n, cap = self._n, self.capacity
        if n <= cap:
            raw = self._ring[:n]
        else:
            i = n % cap
            raw = self._ring[i:] + self._ring[:i]
        return [Record(*r) for r in raw]

    def clear(self) -> None:
        """Forget the totals, counters and records."""
        self.totals.clear()
        self.counts.clear()
        self.last.clear()
        self.counters.clear()
        self._ring = [None] * self.capacity
        self._n = 0

    def summary(self) -> List[str]:
        out = []
        for name in sorted(self.totals):
            n = self.counts[name]
            out.append(
                f"{name}: total {self.totals[name]:.3f}s over {n} "
                f"({self.totals[name] / n * 1e3:.2f} ms avg, "
                f"last {self.last[name] * 1e3:.2f} ms)"
            )
        for name in sorted(self.counters):
            out.append(f"{name}: count {self.counters[name]:g}")
        return out


spans = Spans()


def trace_to(logdir: str, fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under ``torch.profiler`` (the CPU, and
    CUDA where there is a device) with the program's ``mcl.`` ranges on,
    and write the Chrome trace to ``logdir/trace.json``; returns ``fn``'s
    result."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    ranges, spans.ranges = spans.ranges, True
    try:
        with profile(activities=activities) as prof:
            out = fn(*args, **kwargs)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        spans.ranges = ranges
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    return out
