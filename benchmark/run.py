"""Run one cell of the port's benchmark once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository root.  The cell (``BENCHMARK.json``) names a
configuration (``configs/``) and a traffic mix (``traffic/``); the run
builds the program from them, warms up on the mix, measures for
``--seconds`` (``--trace 0``: the cell's end-to-end metrics), or traces
the window and then profiles a short slice last (``--trace 1``: its
per-layer metrics, from ``metrics/``), compares a sample of the window's
answers with the plain reference (``check.py``) and prints one JSON line
last on stdout, each compared number beside its limit on stderr before
it.  A run is correct when every scan it pushed came back with a finite
pose (``failed`` 0) and every compared number keeps to its limit.
Without a CUDA device, or with fewer than the cell asks for, it prints
no result and exits 1; it also exits 1 if JAX or the JAX package was
loaded.  ``--control`` also computes the bfloat16 control's readings
(stderr) and whether they would pass as correct, which the benchmark's
own runs never do.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path[:1]:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton"}


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def shapes(cfg, map_points) -> dict:
    """The launch shapes the roofline counts read, from the configuration
    and the map alone."""
    from benchmark import check
    m = cfg["model"]
    bins = 1
    for b in cfg["pose_bins"]:
        bins *= b
    return dict(particles=m["num_particles"],
                like_points=m["likelihood"]["num_points"],
                beam_points=m["beam"]["num_points"], bins=bins + 1,
                field_cells=check.field_cells(map_points, m))


def p95(values):
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def run_cell(name, seed, seconds, trace, *, device="cuda", root=ROOT,
             overrides=None, mix_overrides=None, limits=None, control=False,
             t_start=None, log=_log):
    """One run of cell ``name``: ``(result line as a dict, checks,
    control readings or None)``.  ``overrides`` and ``mix_overrides``
    replace entries of the configuration and the mix (the tests' small
    sizes on the host), ``limits`` the limits file's."""
    import torch

    from benchmark import cells, check, traffic

    t_start = T0 if t_start is None else t_start
    bench = harness.load_benchmark(root)
    w = harness.workload(bench, name)
    cfg = merge(harness.config(w["config"]), overrides or {})
    mix = merge(harness.traffic(w["traffic"]), mix_overrides or {})
    drive = harness.drive(mix["drive"])
    loop = getattr(cells, drive.LOOP)
    r = loop(cfg, mix, drive.make(mix, cfg, seed), seed, seconds,
             bool(trace), device, t_start)
    world = traffic.world_map()
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                     else "cpu"),
            "count": 1, "memory_peak_bytes": int(r.memory_peak_bytes)}
    metrics, breakdown = {}, None
    if not trace:
        units = {m["name"]: m["unit"] for m in
                 harness.end_to_end_for(bench, name)}
        values = {"updates_per_s": r.updates / r.window_s,
                  "update_p95_ms": p95(r.latencies) * 1e3
                  if len(r.latencies) > 1 else None,
                  "setup_s": r.setup_s}
        metrics = {k: (values[k.split(".")[0]], u) for k, u in units.items()
                   if values.get(k.split(".")[0]) is not None}
    else:
        if r.prof is not None:
            info.update(busy_s=r.prof["busy_s"], window_s=r.prof["window_s"])
            breakdown = r.prof["breakdown"]
        tr_in = dict(spans=r.spans, routes=r.routes, steps=r.steps,
                     steps_00=r.steps_00, scans=r.scans, prof=r.prof,
                     shapes=shapes(cfg, world), cell=name)
        for m in harness.per_layer_for(bench, name):
            v = harness.metric_reader(m["name"])(tr_in)
            if v is not None:
                metrics[m["name"]] = (v, m["unit"])
    lat = sorted(r.latencies)
    log(f"run: {name} seed {seed}: {r.attempted} attempted, {r.failed} "
        f"failed, {r.updates} updates in {r.window_s:.3f} s, setup "
        f"{r.setup_s:.3f} s, routes {r.routes}, tiers 0/0 "
        f"{r.steps_00}/{r.steps}, {len(r.records)} compared, peak "
        f"{r.memory_peak_bytes} B on {info['kind']}; latency ms median "
        f"{statistics.median(lat) * 1e3:.3f} max {lat[-1] * 1e3:.3f}")
    records, attempted, failed = r.records, r.attempted, r.failed
    del r
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, ctl = check.compare(records, cfg["model"], world, dev,
                                 control=control)
    log(f"run: reference over {len(records)} updates in "
        f"{time.perf_counter() - t_check:.3f} s")
    if limits is None:
        try:
            limits = harness.limits(name)
        except FileNotFoundError:
            limits = {}
    limits = {k: float(limits.get(k, 0.0)) for k in check.NUMBERS}
    checks = {k: (numbers.get(k), limits[k]) for k in check.NUMBERS}
    correct = bool(records) and check.verdict(attempted, failed, numbers,
                                              limits)
    if ctl is not None:
        ctl = dict(ctl, correct=check.within(ctl, limits))
    return (dict(correct=correct, attempted=attempted, failed=failed,
                 metrics=metrics, device=info, breakdown=breakdown),
            checks, ctl)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="also read the bfloat16 control (stderr)")
    a = ap.parse_args(argv)
    bench = harness.load_benchmark(ROOT)
    w = harness.workload(bench, a.workload)
    cfg = harness.config(w["config"])
    os.environ.update(cfg["env"])
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        _log(f"run: the cell needs {w['chips']} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    out, checks, ctl = run_cell(a.workload, a.seed, a.seconds, a.trace,
                                control=a.control)
    found = harness.forbidden_modules()
    if found:
        _log(f"run: JAX or the JAX package was loaded: {found}")
        return 1
    if ctl is not None:
        _log("control " + json.dumps(ctl))
    for k, (v, lim) in checks.items():
        _log(f"check {k} {v!r} limit {lim!r}")
    print(harness.result_line(out["correct"], out["attempted"],
                              out["failed"], out["metrics"], out["device"],
                              checks, out["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
