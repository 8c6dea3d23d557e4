"""The fleet on one device: both fleet paths at ``R x 10,240`` particles on
the flagship room world (the port's ``tools/exp_fleet_chip.py``).

    python -m mcl_3dl_tpu_torch.tools.fleet [--robots 16,64,128,1024]
        [--paths grouped,batched] [--steps 3] [--cpu]

Each robot runs ``Params(num_particles=10240, use_beam_model=True)`` (96
likelihood points, 3 beams) at the exact capacity, from the
converged-tracking spread, on one 1024-point scan of the flagship room
world shared by every robot (each robot draws its own samples and noise
from its own generator).  The map is built once and shared.

* ``grouped``: ``parallel.fleet_filter_step_grouped``, each robot in turn
  through the single-robot step with kernels K1/K2;
* ``batched``: ``parallel.fleet_filter_step``, ``torch.func.vmap`` of the
  ``spmd_safe`` step (tiers 2/2) over the whole fleet at once.

One line per path and robot count: the median fleet-step time over
``--steps`` steps after one warm-up step, robot-updates/s, the particle
state's MB, the peak device memory, and the fraction of robots at tier 0
for each model; an out-of-memory step prints its row as OOM and the tool
goes on.  Every line carries the card's ``nvidia-smi`` name and power
limit.  The pose grid is the ``MCL_G_YAW``/``MCL_G_PITCH``/``MCL_G_ROLL``
environment's (a fleet runs 6x1x1; set before the package is imported).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from mcl_3dl_tpu_torch import MCL3DL, Params, worlds
from mcl_3dl_tpu_torch.config import BeamParams, LikelihoodParams
from mcl_3dl_tpu_torch.engine import resolve_device
from mcl_3dl_tpu_torch.math import filters as mf
from mcl_3dl_tpu_torch.ops import grouped as og
from mcl_3dl_tpu_torch.parallel import (fleet_filter_step,
                                        fleet_filter_step_grouped)
from mcl_3dl_tpu_torch.state import ParticleState
from mcl_3dl_tpu_torch.tools import card

NUM_PARTICLES = 10240
CLOUD_POINTS = 1024
# converged tracking: the per-robot grouped envelopes fit from the first step
CONVERGED_COV = np.diag([0.02 ** 2] * 3 + [0.01 ** 2, 0.01 ** 2, 0.02 ** 2])
ORIGIN = np.array([[0.0, 0.0, worlds.SENSOR_Z]], np.float32)


def engine(num_particles=NUM_PARTICLES, device="cuda", like_points=None,
           beam_clip_far=None, beam_clip_z=None, cov=CONVERGED_COV):
    """One robot's engine at the exact capacity on the flagship room
    world, seeded with ``cov`` about the origin."""
    lp = {} if like_points is None else dict(num_points=like_points)
    bp = {} if beam_clip_far is None else dict(clip_far=beam_clip_far)
    if beam_clip_z is not None:
        bp.update(clip_z_min=-beam_clip_z, clip_z_max=beam_clip_z)
    eng = MCL3DL(Params(num_particles=num_particles, use_beam_model=True,
                        likelihood=LikelihoodParams(**lp),
                        beam=BeamParams(**bp)),
                 capacity=num_particles, device=device)
    eng.load_map(worlds.world_map())
    eng.initial_pose(np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]), cov)
    return eng


def tile(x, robots: int):
    """``x`` (a tensor, or a tuple of them) repeated on a new leading axis."""
    if isinstance(x, tuple):
        return type(x)(*(tile(v, robots) for v in x))
    return x.unsqueeze(0).expand((robots,) + tuple(x.shape)).contiguous()


def inputs(eng, robots: int, scan):
    """The fleet step's arguments for ``robots`` robots at the engine's
    state: every robot at the engine's particles and filters, one shared
    ``scan`` (raw points, as the JAX tool passes them), odometry at the
    identity."""
    dev = eng.device
    f = dict(dtype=torch.float32, device=dev)
    p = scan.shape[0]
    one = (torch.as_tensor(np.asarray(scan, np.float32), device=dev),
           torch.zeros((p,), dtype=torch.int64, device=dev),
           torch.ones((p,), dtype=torch.bool, device=dev),
           torch.as_tensor(ORIGIN, device=dev),
           torch.zeros(3, **f), torch.tensor([0.0, 0.0, 0.0, 1.0], **f),
           eng.state_prev_pos, eng.state_prev_rot)
    return (tile(eng.pstate, robots), eng.map.df, eng.map.df_beam,
            *(tile(x, robots) for x in one), tile(eng.f_pos, robots),
            tile(eng.f_ang, robots),
            torch.zeros((robots,), dtype=torch.bool, device=dev))


def apart(args, metres: float):
    """Fleet arguments ``args`` (``inputs``) with robot ``i``'s odometry
    moved by ``i * metres`` in x, so that the robots publish distinct
    poses."""
    args = list(args)
    odom = args[7]
    step = torch.zeros_like(odom[0])
    step[0] = metres
    args[7] = odom + torch.arange(odom.shape[0], device=odom.device,
                                  dtype=odom.dtype)[:, None] * step
    return tuple(args)


def min_gap(pub_pos) -> float:
    """The least distance between the published positions [R, 3] of
    robots next to each other in the fleet."""
    return float(torch.linalg.vector_norm(pub_pos[1:] - pub_pos[:-1],
                                          dim=-1).min())


def given_draws(eng, args, seed=1000):
    """Draws for the robots of fleet arguments ``args`` (``inputs``),
    robot ``i``'s from a generator on the engine's device seeded with
    ``seed + i``, stacked on a leading axis."""
    cap = args[0].pos.shape[1]
    out = []
    for i in range(args[0].pos.shape[0]):
        gen = torch.Generator(device=eng.device)
        gen.manual_seed(seed + i)
        out.append(eng.draw_step(*eng.keeps(args[3][i], args[5][i]),
                                 gen=gen, capacity=cap))
    return type(out[0])(*(None if out[0][k] is None
                          else torch.stack([d[k] for d in out])
                          for k in range(len(out[0]))))


def advance(args, out):
    """The next step's arguments: the outputs' state, filters and
    previous pose in place of the inputs'."""
    state, f_pos, f_ang, prev_pos, prev_rot, _ = out
    return (state, *args[1:9], prev_pos, prev_rot, f_pos, f_ang, args[13])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run(path: str, robots: int, steps: int = 3, device="cuda", eng=None,
        scan=None, log=print):
    """Warm-up step, then ``steps`` timed fleet steps of ``path``: the
    row, or an OOM row."""
    dev = resolve_device(device)
    eng = eng or engine(device=dev)
    scan = worlds.scan(np.random.default_rng(0), CLOUD_POINTS) \
        if scan is None else scan
    make = fleet_filter_step_grouped if path == "grouped" else \
        fleet_filter_step
    step = make(eng)
    npart = eng.pstate.capacity
    row = dict(path=path, robots=robots, particles_per_robot=npart,
               total_particles=robots * npart,
               grid=f"{og.G_YAW}x{og.G_PITCH}x{og.G_ROLL}")
    args = out = None
    try:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        args = inputs(eng, robots, scan)
        out = step(*args)
        times = []
        for _ in range(steps):
            args = advance(args, out)
            _sync(dev)
            t0 = time.perf_counter()
            out = step(*args)
            _sync(dev)
            times.append(time.perf_counter() - t0)
    except torch.cuda.OutOfMemoryError as exc:
        args = out = None
        row["oom"] = str(exc).splitlines()[0]
        log(f"fleet {path} {robots}x{npart}: OOM: {row['oom']} [{card(dev)}]")
        return row
    aux = out[5]
    e_pos = aux["e_pos"].cpu().numpy()
    pub = aux["pub_pos"].cpu().numpy()
    ms = statistics.median(times) * 1e3
    row.update(
        step_ms=ms, step_ms_all=[t * 1e3 for t in times],
        robot_updates_per_s=robots / (ms / 1e3),
        state_mb=sum(t.numel() * t.element_size()
                     for t in out[0][:-1]) / 1e6,
        peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                  if dev.type == "cuda" else None),
        tier0_like=float((aux["tier_like"] == 0).float().mean()),
        tier0_beam=float((aux["tier_beam"] == 0).float().mean()),
        finite=bool(np.isfinite(e_pos).all() and np.isfinite(pub).all()),
        max_pub_err_m=float(np.linalg.norm(pub, axis=-1).max()))
    row["out"] = out
    peak = "not measured" if row["peak_gib"] is None else \
        f"{row['peak_gib']:.2f} GiB"
    log(f"fleet {path} {robots}x{npart} (grid {row['grid']}): step "
        f"{ms:.1f} ms (median of {steps}), {row['robot_updates_per_s']:.2f} "
        f"robot-updates/s, state {row['state_mb']:.1f} MB, peak {peak}, "
        f"tier 0 like {row['tier0_like']:.3f} beam {row['tier0_beam']:.3f}, "
        f"max |pub_pos| {row['max_pub_err_m']:.4f} m [{card(dev)}]")
    return row


def robot_state(state_b: ParticleState, i: int) -> ParticleState:
    return ParticleState(*(x[i] for x in state_b))


def robot_filter(f_b: mf.FilterState, i: int) -> mf.FilterState:
    return mf.FilterState(*(x[i] for x in f_b))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--robots", default="16,64,128,1024",
                    help="comma-separated robot counts")
    ap.add_argument("--paths", default="grouped,batched")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--particles", type=int, default=NUM_PARTICLES)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the host")
    a = ap.parse_args(argv)
    dev = resolve_device("cpu" if a.cpu else None)
    eng = engine(a.particles, dev)
    scan = worlds.scan(np.random.default_rng(0), CLOUD_POINTS)
    rows = []
    for path in a.paths.split(","):
        for robots in (int(r) for r in a.robots.split(",")):
            row = run(path, robots, a.steps, dev, eng, scan)
            row.pop("out", None)
            rows.append(row)
    print(json.dumps({"device": card(dev), "rows": rows}))
    return rows


if __name__ == "__main__":
    main()
