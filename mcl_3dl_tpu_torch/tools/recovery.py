"""Global recovery on the flagship room world: the seed-and-decay global
localization and the particle-count services, as a user drives them.

    python -m mcl_3dl_tpu_torch.tools.recovery [--cpu]

``MCL3DL(Params(num_particles=64))`` (the reference's default count) on
the flagship room world, the robot standing at the origin, three
episodes (``EPISODES``), each measured until the count has decayed back
to ``num_particles``: 0.75x a step in global mode (likelihood slots on
the reference's point ramp, the beam model dropped):

1. ``global``: ``global_localization()`` seeds one particle per standable
   surface point and yaw bin (a 0.1 m grid and 24 yaw bins give 122,328
   seeds).  The particles spread over the whole map, so neither the
   pose-grouped tier (kernel K1) nor the per-point box tier (K3) fits:
   the plain gather scores every step;
2. ``resize``: ``initial_pose`` at the truth with the tracking spread (an
   operator confirming the pose), then ``resize_particles(131072)``.  The
   particles stay clustered, and K1 scores the steps at capacities that
   are multiples of 1024, at 8 and 16 likelihood slots;
3. ``resize-coarse``: ``initial_pose`` wide in x/y and tight in attitude
   (the main path's coarse pose), then ``resize_particles(500)``: K3
   scores the first step, at capacity 512 and 16 slots, before the
   resampling jitter widens the attitude past its box.

Every step must follow ``max(floor(0.75 n), num_particles)`` and the
capacity must end at the base bucket.  Prints one line a step (count,
capacity, slot bucket, tiers, ``push_cloud`` milliseconds) and the final
pose's distance from the truth, with the card's ``nvidia-smi`` name and
power limit.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from mcl_3dl_tpu_torch import MCL3DL, Params, worlds
from mcl_3dl_tpu_torch.tools import card
from mcl_3dl_tpu_torch.tools.grouped_pairs import COARSE_COV

NUM_PARTICLES = 64
SEED_GRID_LIN = 0.1
SEED_YAW_BINS = 24
# (name, initial-pose covariance or None, resize_particles count or None)
EPISODES = (("global", None, None),
            ("resize", worlds.TRACKING_COV, 131072),
            ("resize-coarse", COARSE_COV, 500))
CLOUD_POINTS = 4096
ORIGIN = np.array([0.0, 0.0, worlds.SENSOR_Z])
IDENT = np.array([0.0, 0.0, 0.0, 1.0])


def engine(device="cuda", grid_lin=SEED_GRID_LIN, yaw_bins=SEED_YAW_BINS):
    """``MCL3DL`` at the reference's default count with the beam model, a
    seed grid of ``grid_lin`` metres and ``yaw_bins`` yaw bins, on the
    flagship room world's map."""
    eng = MCL3DL(Params(num_particles=NUM_PARTICLES, use_beam_model=True,
                        global_localization_grid_lin=grid_lin,
                        global_localization_grid_ang=2.0 * np.pi / yaw_bins),
                 device=device)
    eng.load_map(worlds.world_map())
    return eng


def _sync(eng):
    if eng.device.type == "cuda":
        torch.cuda.synchronize()


def decay(eng, rng, t, cloud_points=CLOUD_POINTS, before_step=None):
    """Measure scans until the count is back at ``num_particles``; returns
    ``(t, rows)`` with one row a measurement: ``dict(n, capacity, slots,
    tier_like, tier_beam, ms, res, before)`` (``n`` after the step,
    ``capacity`` and ``slots`` those the step ran at, ``before`` what
    ``before_step(eng)`` returned before the scan was pushed).  Raises
    unless every step follows ``max(floor(0.75 n), num_particles)``."""
    p = eng.params
    n = eng._n_active_host
    rows = []
    while True:
        eng.odometry(np.zeros(3), IDENT, t)
        scan = worlds.scan(rng, cloud_points)
        cap = eng.pstate.capacity
        before = before_step(eng) if before_step is not None else None
        _sync(eng)
        t0 = time.perf_counter()
        res = eng.push_cloud("lidar", scan, ORIGIN, t)
        _sync(eng)
        ms = (time.perf_counter() - t0) * 1e3
        t += 0.1
        if res is None:       # a round's first cloud only accumulates
            continue
        a = eng.last_aux
        want = (max(int(np.float32(n) * np.float32(0.75)), p.num_particles)
                if n > p.num_particles else n)
        if res.particle_size != want:
            raise AssertionError(f"count {n} -> {res.particle_size}, want "
                                 f"{want}")
        rows.append(dict(n=res.particle_size, capacity=cap,
                         slots=a["like_slots"], tier_like=a["tier_like"],
                         tier_beam=a["tier_beam"], ms=ms, res=res,
                         before=before))
        n = res.particle_size
        if n == p.num_particles:
            return t, rows


def run(eng, rng, before_step=None, episodes=None, log=print):
    """The episodes (default ``EPISODES``); returns ``{name: {"seeds": count, "rows": rows}}``
    (rows: see ``decay``).  Raises unless the capacity ends at the base
    bucket each time."""
    out = {}
    t = 0.0
    for name, cov, resize_to in episodes or EPISODES:
        if resize_to is None:
            n0 = eng.global_localization()
        else:
            eng.initial_pose(np.zeros(3), IDENT, cov)
            eng.resize_particles(resize_to)
            n0 = resize_to
        log(f"{name}: {n0} particles at capacity {eng.pstate.capacity}")
        t, rows = decay(eng, rng, t, before_step=before_step)
        for r in rows:
            log(f"{name} step: n_active {r['n']} capacity {r['capacity']} "
                f"slots {r['slots']} tier_like {r['tier_like']} tier_beam "
                f"{r['tier_beam']} {r['ms']:.2f} ms")
        if eng.pstate.capacity != eng._base_capacity:
            raise AssertionError(f"capacity {eng.pstate.capacity} after the "
                                 f"decay, base {eng._base_capacity}")
        last = rows[-1]["res"]
        log(f"{name}: {len(rows)} measurements to {rows[-1]['n']} particles,"
            f" raw pose {np.linalg.norm(last.raw_pos):.4f} m and published "
            f"pose {np.linalg.norm(last.pos):.4f} m from the truth")
        out[name] = {"seeds": n0, "rows": rows}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    a = ap.parse_args(argv)
    dev = torch.device("cpu" if a.cpu else "cuda")
    where = card(dev)
    eng = engine(dev)
    run(eng, np.random.default_rng(0), log=lambda s: print(f"{s} [{where}]",
                                                           flush=True))


if __name__ == "__main__":
    main()
