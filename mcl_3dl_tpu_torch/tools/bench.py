"""The port's bench: particle-point evaluations per second of the whole
fused measurement step on the card (the counterpart of the repository
root's ``bench.py``).

    python -m mcl_3dl_tpu_torch.tools.bench [--quick] [--processes 3]

The engine is the flagship one, built through the normal constructor at
the shipped defaults (``build``: ``MCL3DL(Params(num_particles=N,
use_beam_model=True))`` on the flagship room world, ``initial_pose`` at
the tracking spread, one 4,096-point analytic scan, the step's arguments
as ``tools.sharded.step_args`` builds them), at 1,048,576 particles
(``--quick``: 16,384).  Its rows, as ``bench.py`` has them:

* steady: the first step, 6 warm-up steps, then 20 timed steps
  (``--quick``: 2 and 3), the state chained from step to step;
* push_cloud: 20 scans through ``push_cloud`` on the same engine from the
  steady state (one more first, not counted): the latency users see;
* fallback: ``initial_pose`` spread wide (1 m, 0.1 rad roll/pitch, 1 rad
  yaw), the step on that state 5 times (re-pinned every step);
* trilinear: ``interp="trilinear"``, 6 warm-ups and 10 timed steps;
* global mode: 16,384 particles with ``global_localization_grid_lin`` =
  ``_ang`` = 0.1, seeded by ``global_localization()``, the global-mode
  step on the seeded state 5 times (re-pinned to the seeded count).

Each step draws from the engine's generator inside the timed window and
is timed on the host clock between two ``torch.cuda.synchronize()``
calls; a row's time is the median of its steps.  Each row records the
tiers its steps ran and the launches of kernels K1-K3 over its timed
steps.  ``BENCH_NO_BEAM``, ``BENCH_LIKE_POINTS`` and
``BENCH_HEADLINE_ONLY`` keep ``bench.py``'s meaning (the last two rows and
the fallback row are then skipped; ``--quick`` skips them too).

The rows run in ``--processes`` child processes, one after the other,
each printing one JSON line; the headline step is the median of the
children's steady medians, and ``extra`` holds each child's medians with
their min and max, every steady step of every child, and the pooled
steps' min, quartiles and max.  The steady timed steps must all run at tiers 0/0 (the
grouped kernels), else the tool fails.  The last stdout line has
``bench.py``'s keys: ``{"metric": "particle_likelihood_evals_per_sec_chip",
"value", "unit": "evals/s", "vs_baseline", "extra"}``, the value
``N * (96 + 3) / step`` and the baseline the reference node's 64
particles x 99 points x 10 Hz = 63,360; everything else goes to stderr.
Without a card the tool exits 1 before any row; a CPU rehearsal calls the
row functions with ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mcl_3dl_tpu_torch import MCL3DL, Params, worlds
from mcl_3dl_tpu_torch.config import LikelihoodParams
from mcl_3dl_tpu_torch.engine import global_slots, resolve_device
from mcl_3dl_tpu_torch.ops import grouped as og
from mcl_3dl_tpu_torch.ops import local_gather as olg
from mcl_3dl_tpu_torch.tools import card
from mcl_3dl_tpu_torch.tools.sharded import step_args

METRIC = "particle_likelihood_evals_per_sec_chip"
NUM_PARTICLES = 1 << 20
QUICK_PARTICLES = 1 << 14
CLOUD_POINTS = 4096
GLOBAL_PARTICLES = 1 << 14
GLOBAL_GRID = 0.1
PUSH_SCANS = 20
WIDE_COV = np.diag([1.0, 1.0, 1.0, 0.1, 0.1, 1.0])
IDENT = np.array([0.0, 0.0, 0.0, 1.0])
ORIGIN = np.array([0.0, 0.0, worlds.SENSOR_Z])
KERNELS = {"like": og.grouped_like_score, "beam": og.grouped_beam_pen,
           "local": olg.local_score}
ROOT = Path(__file__).resolve().parents[2]


def build(num_particles, device=None, cloud_points=CLOUD_POINTS, seed=0,
          interp=None, like_points=None, use_beam_model=True, **params):
    """The port's copy of ``__graft_entry__._build_engine_and_inputs``:
    ``(engine, scan, args)``, the engine on the flagship room world at the
    tracking spread about the origin, ``scan`` [P, 3] the analytic scan
    from ``numpy.random.default_rng(seed)``, and ``args`` the step's
    arguments after the state (``tools.sharded.step_args``).  ``params``
    go to ``Params``."""
    rng = np.random.default_rng(seed)
    lp = {}
    if interp is not None:
        lp["interp"] = interp
    if like_points is not None:
        lp["num_points"] = like_points
    eng = MCL3DL(Params(num_particles=num_particles,
                        use_beam_model=use_beam_model,
                        likelihood=LikelihoodParams(**lp), **params),
                 device=resolve_device(device))
    eng.load_map(worlds.world_map())
    eng.initial_pose(np.zeros(3), IDENT, worlds.TRACKING_COV)
    scan = worlds.scan(rng, cloud_points)
    return eng, scan, step_args(eng, scan)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _zero_launches():
    for fn in KERNELS.values():
        fn.launches = 0


def _launches():
    return {k: fn.launches for k, fn in KERNELS.items()}


def steps(eng, state, args, n, chain=True, **kw):
    """``n`` measurement steps from ``state`` (each on the last one's
    output state with ``chain``, else each on ``state``), each timed on
    the host clock between two synchronisations: ``(last output, ms a
    step, sorted tiers, K1-K3 launches over the steps, their counts set
    to 0 just before)``."""
    dev = eng.device
    times, tiers, out = [], set(), None
    _zero_launches()
    for _ in range(n):
        sync(dev)
        t0 = time.perf_counter()
        out = eng._measurement_step(state, *args, **kw)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        tiers.add((out[5]["tier_like"], out[5]["tier_beam"]))
        if chain:
            state = out[0]
    launches = _launches()
    return out, times, sorted(tiers), launches


def _row(times, tiers, launches, **fields):
    return dict(step_ms=statistics.median(times), step_ms_all=times,
                tiers=tiers, launches=launches, **fields)


def _first(eng, state, args, **kw):
    """The first step on ``state``, outside any row: ``(output,
    seconds)``."""
    out, times, _, _ = steps(eng, state, args, 1, **kw)
    return out, times[0] / 1e3


def steady_row(eng, args, warmup=6, iters=20):
    """The headline row: the first step, ``warmup`` chained steps, then
    ``iters`` timed chained steps.  ``(last output, row)``."""
    out, first_s = _first(eng, eng.pstate, args)
    out = steps(eng, out[0], args, warmup)[0]
    out, times, tiers, launches = steps(eng, out[0], args, iters)
    return out, _row(times, tiers, launches, first_step_s=first_s)


def push_cloud_row(eng, out, scans=PUSH_SCANS, seed=1):
    """``push_cloud`` of ``scans`` fresh scans (from
    ``default_rng(seed)``, the robot standing at the origin) on the engine
    put at the step output ``out``; one more scan first, not counted (the
    engine accumulates it and measures it with the next one, as every
    later scan measures the one before)."""
    (eng.pstate, eng.f_pos, eng.f_ang, eng.state_prev_pos,
     eng.state_prev_rot) = out[:5]
    dev = eng.device
    rng = np.random.default_rng(seed)
    times, tiers, t = [], set(), 0.0
    _zero_launches()
    for _ in range(scans + 1):
        eng.odometry(np.zeros(3), IDENT, t)
        cloud = worlds.scan(rng, CLOUD_POINTS)
        sync(dev)
        t0 = time.perf_counter()
        res = eng.push_cloud("lidar", cloud, ORIGIN, t)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        if res is not None:
            tiers.add((eng.last_aux["tier_like"], eng.last_aux["tier_beam"]))
        t += 0.1
    launches = _launches()
    return _row(times[1:], sorted(tiers), launches)


def fallback_row(eng, args, iters=5):
    """The unconverged step: the wide ``initial_pose``, one first step,
    then ``iters`` timed steps each on that same state."""
    eng.initial_pose(np.zeros(3), IDENT, WIDE_COV)
    wide = eng.pstate
    _first(eng, wide, args)
    _, times, tiers, launches = steps(eng, wide, args, iters, chain=False)
    return _row(times, tiers, launches)


def trilinear_row(num_particles, device=None, warmup=6, iters=10):
    """The steady step with ``interp="trilinear"`` on an engine of its
    own."""
    eng, _, args = build(num_particles, device, interp="trilinear")
    return steady_row(eng, args, warmup, iters)[1]


def global_row(device=None, num_particles=GLOBAL_PARTICLES, grid=GLOBAL_GRID,
               iters=5):
    """The global-mode step: ``global_localization()`` seeds the engine at
    ``grid`` (m and rad), then the step the engine picks above
    ``num_particles`` (its likelihood slots on the reference's point
    ramp, the beam dropped at its global budget) runs ``iters`` times on
    the seeded state."""
    eng, _, args = build(num_particles, device,
                         global_localization_grid_lin=grid,
                         global_localization_grid_ang=grid)
    seeded = eng.global_localization()
    state = eng.pstate
    kw = dict(global_mode=True,
              global_slots=global_slots(eng.params, seeded))
    _first(eng, state, args, **kw)
    _, times, tiers, launches = steps(eng, state, args, iters, chain=False,
                                      **kw)
    return _row(times, tiers, launches, particles=seeded,
                capacity=state.capacity, like_slots=kw["global_slots"])


def _log(name, row, where):
    extra = "".join(f", {k} {row[k]}" for k in ("particles", "capacity",
                                                   "like_slots") if k in row)
    ms = row["step_ms_all"]
    print(f"bench {name}: median {row['step_ms']:.4f} ms over {len(ms)} "
          f"steps (min {min(ms):.4f}, max {max(ms):.4f}), tiers {row['tiers']}, "
          f"launches {row['launches']}{extra} [{where}]",
          file=sys.stderr, flush=True)


def child(quick=False, device=None):
    """One process's rows; returns (and the CLI prints) them as a dict."""
    dev = resolve_device(device)
    where = card(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    n = QUICK_PARTICLES if quick else NUM_PARTICLES
    env = os.environ
    like_points = (int(env["BENCH_LIKE_POINTS"])
                   if env.get("BENCH_LIKE_POINTS") else None)
    eng, _, args = build(n, dev, like_points=like_points,
                         use_beam_model=not env.get("BENCH_NO_BEAM"))
    p = eng.params
    res = dict(num_particles=n, use_beam=p.use_beam_model,
               points_per_particle=p.likelihood.num_points + (
                   p.beam.num_points if p.use_beam_model else 0),
               device=where, kind=(torch.cuda.get_device_name(0)
                                   if dev.type == "cuda" else "cpu"))
    out, res["steady"] = steady_row(eng, args, *((2, 3) if quick else (6, 20)))
    _log("steady", res["steady"], where)
    res["push_cloud"] = push_cloud_row(eng, out)
    _log("push_cloud", res["push_cloud"], where)
    if not quick and not env.get("BENCH_HEADLINE_ONLY"):
        res["fallback"] = fallback_row(eng, args)
        _log("fallback", res["fallback"], where)
        del eng, out, args
        res["trilinear"] = trilinear_row(n, dev)
        _log("trilinear", res["trilinear"], where)
        res["global"] = global_row(dev)
        _log("global", res["global"], where)
    res["max_memory_allocated"] = (torch.cuda.max_memory_allocated()
                                   if dev.type == "cuda" else None)
    return res


def run_child(quick):
    """One child process; returns its JSON line.  Its stderr passes
    through; a child that fails raises."""
    cmd = [sys.executable, "-m", "mcl_3dl_tpu_torch.tools.bench", "--child"]
    out = subprocess.run(cmd + (["--quick"] if quick else []), cwd=ROOT,
                         stdout=subprocess.PIPE, text=True)
    if out.returncode:
        raise RuntimeError(f"bench child exited {out.returncode}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def summarize(results, where):
    """The metric line's dict from the children's results."""
    med = statistics.median
    first = results[0]
    n, pts = first["num_particles"], first["points_per_particle"]
    per = [r["steady"]["step_ms"] for r in results]
    step_ms = med(per)
    pooled = np.percentile([t for r in results
                            for t in r["steady"]["step_ms_all"]],
                           [0, 25, 50, 75, 100]).tolist()
    tiers = sorted({tuple(t) for r in results for t in r["steady"]["tiers"]})
    evals = n * pts / (step_ms / 1e3)
    baseline = 64 * pts * 10.0
    extra = dict(
        filter_updates_per_sec=1e3 / step_ms, num_particles=n,
        points_per_particle=pts, step_ms=step_ms,
        baseline_evals_per_sec=baseline,
        tier_like=max(t[0] for t in tiers), tier_beam=max(t[1] for t in tiers),
        steady_tiers=tiers, processes=len(results),
        step_ms_processes=per, step_ms_min=min(per), step_ms_max=max(per),
        step_ms_spread=(max(per) - min(per)) / step_ms,
        step_ms_steps=[r["steady"]["step_ms_all"] for r in results],
        step_ms_pooled_quantiles=pooled,
        first_step_s_processes=[r["steady"]["first_step_s"] for r in results],
        launches_steady=[r["steady"]["launches"] for r in results])
    # bench.py's names for the other rows, each with its processes' medians
    for key, name, label in (
            ("push_cloud", "push_cloud_ms", "push_cloud"),
            ("fallback", "fallback_step_ms", "fallback"),
            ("trilinear", "trilinear_step_ms", "trilinear"),
            ("global", "global_mode_step_ms", "global_mode")):
        if key not in first:
            continue
        ms = [r[key]["step_ms"] for r in results]
        row_tiers = sorted({tuple(t) for r in results
                            for t in r[key]["tiers"]})
        extra.update({
            name: med(ms), f"{name}_processes": ms,
            f"{label}_tiers": row_tiers,
            f"{label}_tier_like": max(t[0] for t in row_tiers),
            f"{label}_tier_beam": max(t[1] for t in row_tiers),
            f"{label}_launches": [r[key]["launches"] for r in results]})
    if "global" in first:
        extra.update(global_mode_particles=first["global"]["particles"],
                     global_mode_capacity=first["global"]["capacity"],
                     global_mode_like_slots=first["global"]["like_slots"])
    peaks = [r["max_memory_allocated"] for r in results]
    extra.update(max_memory_allocated=max(peaks),
                 max_memory_allocated_gib=max(peaks) / 2 ** 30,
                 device=first["kind"], card=where,
                 timing="host clock between torch.cuda.synchronize() a step;"
                        " a process's median, the median over processes")
    return {"metric": METRIC, "value": evals, "unit": "evals/s",
            "vs_baseline": evals / baseline, "extra": extra}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="16,384 particles, the steady and push_cloud rows")
    ap.add_argument("--processes", type=int, default=3,
                    help="child processes, each running every row")
    ap.add_argument("--child", action="store_true",
                    help="(internal) run the rows in this process")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 1
    if a.child:
        print(json.dumps(child(a.quick)), flush=True)
        return 0
    where = card(torch.device("cuda"))
    results = [run_child(a.quick) for _ in range(a.processes)]
    line = summarize(results, where)
    ex = line["extra"]
    want = [(0, 0 if results[0]["use_beam"] else -1)]
    if ex["steady_tiers"] != want:
        print(f"bench: the steady steps ran at tiers {ex['steady_tiers']}, "
              f"not {want}", file=sys.stderr)
        return 1
    print(f"bench: step {ex['step_ms']:.4f} ms (process medians "
          + " ".join(f"{m:.4f}" for m in ex["step_ms_processes"])
          + f"), {1e3 / ex['step_ms']:.2f} filter updates/s at "
          f"{ex['num_particles']} particles, {line['value']:.4e} "
          f"point-evals/s, steady tiers {ex['steady_tiers']}, peak "
          f"{ex['max_memory_allocated_gib']:.2f} GiB [{where}]",
          file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
