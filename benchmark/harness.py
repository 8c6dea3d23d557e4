"""What the runner finds by name: the cells, configurations, traffic mixes,
per-layer metric readers, roofline counts and limits, each in a file of
its own, and the result line.

* ``BENCHMARK.json`` (the repository root, or ``root``): the cells and
  metrics.
* ``configs/<config>.json``: a deployment's sizes, the parameters the
  program is built with and the values the reference reads.
* ``traffic/<traffic>.json``: a mix's parameters, read by the generator
  its ``drive`` names.
* ``drives/<drive>.py``: ``LOOP`` (the loop of ``cells.py`` that runs
  it), ``make(mix, config, seed)`` -> the messages.
* ``metrics/<metric>.py``: ``read(trace) -> float or None``; a metric
  split by cells (``<metric>.<cells>``) is read by ``<metric>``'s file
  unless it has one of its own.  End-to-end metrics split so measure
  the quantity before the first dot (``updates_per_s.fleet``: updates a
  second).
* ``roofline/<kernel>.py``: ``KERNEL`` (a substring of the device
  kernel's name), ``launch(shapes) -> (bytes, flops)``.
* ``limits/<workload>.json``: each compared number's limit.

A later change adds a cell, a mix, a metric or a count as new files and
new ``BENCHMARK.json`` entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = ("jax", "jaxlib", "flax", "mcl_3dl_tpu")
PEAKS = json.loads((HERE / "peaks.json").read_text())


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str, base: Path = HERE) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return json.loads((base / kind / f"{name}.json").read_text())


def config(name: str, base: Path = HERE) -> dict:
    return _json("configs", name, base)


def traffic(name: str, base: Path = HERE) -> dict:
    return _json("traffic", name, base)


def limits(name: str, base: Path = HERE) -> dict:
    return _json("limits", name, base)


def _module(kind: str, name: str, base: Path = HERE):
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = base / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, base: Path = HERE):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``,
    or, for a metric split by the cells it is read in (``graph_share.
    fleet``), the reader of the name before its last dot."""
    while "." in name and not (base / "metrics" / f"{name}.py").is_file():
        name = name.rsplit(".", 1)[0]
    return _module("metrics", name, base).read


def drive(name: str, base: Path = HERE):
    return _module("drives", name, base)


def roofline(name: str, base: Path = HERE):
    return _module("roofline", name, base)


def bound_s(nbytes: float, flops: float) -> float:
    """The least time of a launch on the card: bytes over the memory rate
    or f32 operations over the peak rate, whichever is longer."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               flops / PEAKS["f32_flops_per_s"])


def per_layer_for(bench: dict, cell: str):
    """The per-layer metrics a cell reports."""
    return [m for m in bench["per_layer"]
            if "workloads" not in m or cell in m["workloads"]]


def end_to_end_for(bench: dict, cell: str):
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules():
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def result_line(correct, attempted, failed, metrics, device, checks,
                breakdown=None) -> str:
    """The run's last stdout line; ``checks`` (each compared number with
    its limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed),
           "metrics": {k: {"value": v[0], "unit": v[1]}
                       for k, v in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v[0], "limit": v[1]}
                     for k, v in checks.items()}
    return json.dumps(out, allow_nan=False)


def roofline_share(trace: dict, kernel: str):
    """A kernel's roofline share, %, in a traced run: the least time of a
    launch at the cell's shapes over its mean device time a launch, or
    ``None`` where it did not run in the profiled slice."""
    prof = trace["prof"]
    if prof is None:
        return None
    count = roofline(kernel)
    times = [t for name, ts in prof["kernels"].items()
             if count.KERNEL in name for t in ts]
    if not times:
        return None
    least = bound_s(*count.launch(trace["shapes"]))
    return 100.0 * least / (sum(times) / len(times))
