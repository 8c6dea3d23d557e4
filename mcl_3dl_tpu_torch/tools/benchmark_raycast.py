"""Raycast microbenchmark on the card (the port's
``tools/benchmark_raycast.py``, after the reference's
test/src/performance_raycast.cpp).

    python -m mcl_3dl_tpu_torch.tools.benchmark_raycast

The walls world (``make_world``: 40 vertical walls, 2,000,000 points from
``numpy.random.default_rng(0)``) and 7,600 rays of 4 m at 1 m height
(``make_rays``, ``default_rng(1)``), as the JAX tool builds them.  For
each distance-field cell (0.2, 0.4 m; truncation 0.6 m) and each
occupancy-grid cell (0.2, 0.5 m): the build's seconds on the host through
the port's native map compiler (the array placed on the card included),
then the batch of casts, ``models.beam.raycast_df(df, b, e, cell, cell,
0.3, 32)`` or ``raycast_occ(occ, b, e, 0.3, 0xFFFFFFFF, 48)``, after one
warm-up call: the mean of ``REPS`` calls between two
``torch.cuda.synchronize()`` calls, and the rays a second.  Each march
checks on the host, every probe, whether every ray has finished (its
early exit); the same casts with ``early_exit=False`` (every probe, no
host read) are timed beside it, so the line shows what the check costs or
saves.  One line per row, named with the card's ``nvidia-smi`` name and
power limit; ``run`` returns the rows.  Without a card the tool exits
with an error (``run(device="cpu", ...)`` is the CPU rehearsal).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from mcl_3dl_tpu_torch.engine import resolve_device
from mcl_3dl_tpu_torch.map.distance_field import build_distance_field
from mcl_3dl_tpu_torch.map.occupancy import build_occupancy_grid
from mcl_3dl_tpu_torch.models.beam import raycast_df, raycast_occ
from mcl_3dl_tpu_torch.tools import card
from mcl_3dl_tpu_torch.tools.bench import sync

WORLD_POINTS = 2_000_000
N_WALLS = 40
N_RAYS = 7600
DF_CELLS = (0.2, 0.4)
TRUNC = 0.6
OCC_CELLS = (0.2, 0.5)
HIT_TOLERANCE = 0.3
DF_STEPS = 32
OCC_STEPS = 48
REPS = 10


def make_world(n_target=WORLD_POINTS):
    """Walls world [M, 3]: dense vertical planes every 2 m in x
    (performance_raycast.cpp:52-84)."""
    rng = np.random.default_rng(0)
    per_wall = n_target // N_WALLS
    pts = []
    for i in range(N_WALLS):
        y = rng.uniform(-50, 50, per_wall)
        z = rng.uniform(0, 3, per_wall)
        pts.append(np.stack([np.full(per_wall, -40.0 + 2.0 * i), y, z],
                            axis=1))
    return np.concatenate(pts, axis=0)


def make_rays(n=N_RAYS):
    """``(begins, ends)`` [n, 3] f32: 4 m horizontal rays at 1 m height
    from random points of the world's interior."""
    rng = np.random.default_rng(1)
    begins = np.stack([rng.uniform(-35, 35, n), rng.uniform(-45, 45, n),
                       np.full(n, 1.0)], axis=1).astype(np.float32)
    az = rng.uniform(-np.pi, np.pi, n)
    ends = begins + np.stack([4.0 * np.cos(az), 4.0 * np.sin(az),
                              np.zeros(n)], axis=1).astype(np.float32)
    return begins, ends


def cast_ms(fn, dev, reps=REPS):
    """Mean milliseconds of ``fn`` over ``reps`` calls after one warm-up,
    between two synchronisations."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def _built(fn, dev):
    """``(fn(), seconds)`` between two synchronisations."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def run(device=None, n_points=WORLD_POINTS, n_rays=N_RAYS, reps=REPS,
        log=print):
    """Every row as the module docstring says; returns them as dicts."""
    dev = resolve_device(device)
    where = card(dev)
    world = make_world(n_points)
    begins, ends = make_rays(n_rays)
    b, e = torch.as_tensor(begins).to(dev), torch.as_tensor(ends).to(dev)
    log(f"world: {len(world)} points, {n_rays} rays [{where}]")
    rows = []

    def row(name, grid, build_s, cast):
        ms = cast_ms(lambda: cast(True), dev, reps)
        fixed_ms = cast_ms(lambda: cast(False), dev, reps)
        hits = float(cast(True)[0].float().mean())
        rows.append(dict(name=name, build_s=build_s, cast_ms=ms,
                         rays_per_s=n_rays / ms * 1e3,
                         cast_ms_no_early_exit=fixed_ms, hit_share=hits,
                         shape=list(grid.shape), device=where))
        log(f"{name}: build {build_s:.4f} s, {n_rays} casts {ms:.4f} ms "
            f"({n_rays / ms * 1e3:,.0f} rays/s); every probe without the "
            f"host's early-exit check {fixed_ms:.4f} ms; hits {hits:.4f}; "
            f"shape {grid.shape} [{where}]")

    for cell in DF_CELLS:
        df, build_s = _built(
            lambda: build_distance_field(world, cell, TRUNC, device=dev), dev)
        row(f"DF cell={cell:.1f}", df, build_s, lambda early: raycast_df(
            df, b, e, cell, cell, HIT_TOLERANCE, DF_STEPS, early_exit=early))
    for cell in OCC_CELLS:
        occ, build_s = _built(
            lambda: build_occupancy_grid(world, cell, device=dev), dev)
        row(f"DDA grid={cell:.1f}", occ, build_s, lambda early: raycast_occ(
            occ, b, e, HIT_TOLERANCE, 0xFFFFFFFF, OCC_STEPS,
            early_exit=early))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    return run()


if __name__ == "__main__":
    main()
