"""The port's lookup microbenchmarks: the counterparts of the JAX
package's gather experiments in ``tools/``, under the same file names.

    python -m mcl_3dl_tpu_torch.tools.exp_gather [--risky]
    python -m mcl_3dl_tpu_torch.tools.exp_gather2
    python -m mcl_3dl_tpu_torch.tools.exp_rowsel_shape

Each module builds its inputs from ``numpy.random.default_rng(0)`` at the
JAX script's shapes (``lookups(device, ...)``) and ``main`` times each
experiment, one line each: milliseconds, G lookups/s, the byte bound,
the split of a call into device and host time, and the card's
``nvidia-smi`` name and power limit; it returns the experiments with
their times in ``ms`` and ``library_ms`` and the split in ``device_ms``,
``host_ms``, ``library_device_ms`` and ``library_host_ms``.  They run on
the CUDA device unless called with ``device="cpu"``, which times the
plain versions on the host (not a device number; the split stays None).

``time_ms`` and ``bound`` are also the timer and the roofline of
``chip_smoke.py``.  ``time_ms`` records its start event on an idle card
and then calls the wrapper, so its time holds the whole host path of one
call as well as the kernel: ``device_ms`` and ``host_ms`` say how much
of each.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from mcl_3dl_tpu_torch.engine import resolve_device

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores


@dataclass
class Lookup:
    """One experiment: a kernel and its plain version, or a library row
    (``wrapper`` None: ``run`` is the library call, a yardstick)."""

    tag: str                    # G1..G10, or A/B for the XLA baselines
    name: str
    replaces: str               # file:line of the TPU kernel or baseline
    run: Callable
    plain: Optional[Callable]
    wrapper: Optional[Callable]
    lookups: int
    nbytes: int                 # table, indices and output, once each
    flops: int = 0              # f32 arithmetic besides the index math
    library: Optional[Callable] = None
    library_label: str = ""
    # the least time of the kernel's shared-memory lookups, where they
    # bound it more than its bytes do (G10; ``exp_rowsel_shape.lookup_bound``)
    lookup_bound_ms: Optional[float] = None
    note: str = ""
    ms: Optional[float] = None          # set by ``run``
    library_ms: Optional[float] = None  # set by ``run`` where ``library`` is
    # the split of a call, set by ``run`` on the card (``split``)
    device_ms: Optional[float] = None
    host_ms: Optional[float] = None
    library_device_ms: Optional[float] = None
    library_host_ms: Optional[float] = None
    # the wrapper's arguments, for ``run_in`` (set by ``kernel_lookup``)
    args: tuple = ()
    kw: dict = field(default_factory=dict)

    def run_in(self, module):
        """The experiment through ``module``'s wrapper of the same name
        (another build's ``ops/gather_bench.py``)."""
        return getattr(module, self.name)(*self.args, **self.kw)

    @property
    def bound_ms(self) -> float:
        return bound(self.nbytes, self.flops)[0]

    @property
    def bound_by(self) -> str:
        return bound(self.nbytes, self.flops)[1]

    @property
    def bound_text(self) -> str:
        """The bound as the tools print it, the lookup rate's beside it."""
        text = f"bound {self.bound_ms:.4f} ms by {self.bound_by}"
        if self.lookup_bound_ms is not None:
            text += (f", {self.lookup_bound_ms:.4f} ms by the shared-memory"
                     " lookup rate")
        return text


def bound(nbytes, flops=0):
    """The least time of the work on the card, ``(ms, "bytes" or
    "operations")``: the larger of its bytes over the memory rate and its
    f32 operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_lookup(tag, replaces, wrapper, args, kw=None, **fields) -> Lookup:
    """A ``Lookup`` of ``wrapper(*args, **kw)``; its plain version gets
    ``args`` only."""
    kw = kw or {}
    return Lookup(tag, wrapper.__name__, replaces, lambda: wrapper(*args, **kw),
                  lambda: wrapper.plain(*args), wrapper, args=tuple(args),
                  kw=kw, **fields)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def to_device(device):
    return lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)


def card(device) -> str:
    """``nvidia-smi`` name and power limit, or a note that no card ran."""
    if device.type != "cuda":
        return "no card: plain versions on the host"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def sm_rate():
    """``(SMs, Hz)``: the card's streaming multiprocessors and the maximum
    of its SM clock as ``nvidia-smi`` reads it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count, mhz * 1e6


def time_ms(fn, iters, device="cuda") -> float:
    """Median milliseconds of ``fn`` over ``iters`` calls after one
    warm-up: CUDA events on the card, the host clock on the CPU."""
    device = torch.device(device)
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, iters=25) -> float:
    """Device time per call of ``fn`` on the card: ``iters`` calls captured
    in one CUDA graph after a warm-up, one replay timed with CUDA events,
    divided by ``iters``.  It holds the kernels and the device's gaps
    between them, no host time.  (``torch.profiler`` is not used: after
    its sessions the host path of later launches read slower.)"""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def host_ms(fn, calls=1000, batch=50) -> float:
    """Host time per call of ``fn`` on the card: ``time.perf_counter`` over
    ``calls`` back-to-back calls with no sync, divided by ``calls``.  The
    card is synchronised (outside the clock) after every ``batch`` calls,
    so the launch queue never fills and the clock never waits on the
    device."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls // batch):
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / (calls // batch * batch) * 1e3


def split(fn, iters=25):
    """``(device_ms, host_ms)`` of one call of ``fn`` on the card."""
    host = host_ms(fn)
    return device_ms(fn, iters), host


def _split_text(d, h):
    return "" if d is None else f" (device {d:.4f} + host {h:.4f} ms a call)"


def run(lookups, device, iters=25):
    """Time each experiment into its ``ms`` (and ``library_ms``), on the
    card also its device/host split, and print its line; returns
    ``lookups``."""
    where = card(device)
    on_card = device.type == "cuda"
    for e in lookups:
        e.ms = ms = time_ms(e.run, iters, device)
        if on_card:
            e.device_ms, e.host_ms = split(e.run, iters)
        kind = ("library call" if e.wrapper is None else
                "kernel" if on_card else "plain version")
        lib = ""
        if e.library is not None:
            e.library_ms = time_ms(e.library, iters, device)
            if on_card:
                e.library_device_ms, e.library_host_ms = split(e.library, iters)
            lib = (f", {e.library_label} {e.library_ms:.4f} ms"
                   + _split_text(e.library_device_ms, e.library_host_ms))
        note = f" ({e.note})" if e.note else ""
        print(f"{e.tag} {e.name} [{kind}, {e.replaces}]: {ms:.4f} ms on "
              f"{device.type}{_split_text(e.device_ms, e.host_ms)}, "
              f"{e.lookups / ms / 1e6:.3f} G lookups/s, {e.bound_text} "
              f"({e.nbytes} B at 3.35 TB/s){lib}{note} [{where}]", flush=True)
    return lookups


def entry(lookups_fn, device=None, iters=25, **sizes):
    """``main`` of a tool: the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    return run(lookups_fn(device, **sizes), device, iters)
