"""Every option of the single-robot engine at once, on the flagship room
world: the drive of ``chip_smoke.py``'s phase 9.

    python -m mcl_3dl_tpu_torch.tools.all_options [--cpu]
        [--particles N] [--cloud-points P]

``MCL3DL`` with trilinear sampling, the DDA raycast, the normal-weighted
sampler, ``output_pcd`` and an ``on_match_clouds`` callback
(``params``), the robot standing at the origin (``run``):

1. ``initial_pose`` with the tracking spread, then ``CHECKPOINT_AT``
   measurements through ``odometry`` + ``push_cloud``;
2. ``checkpoint.save_checkpoint``; a fresh engine loads it (and the scan
   the running engine holds in its accumulation buffer), and both measure
   the same ``N_SCANS - CHECKPOINT_AT`` scans, their particles, weights
   and published poses compared bit for bit after each;
3. ``landmark`` at the true pose, ``update_map`` with a small wall
   outside the room (the map's grid grows, every index is rebuilt), then
   ``N_AFTER`` more measurements;
4. the outputs: ``save_accumulated_pcd`` read back by ``read_pcd``,
   ``get_particles``, ``diagnostics`` and ``debug_beam_status``.

Each measurement's ``push_cloud`` time is synchronised and handed to
``on_step``.  The engine runs on the CUDA device unless ``--cpu`` is
given; the default size is the smoke's (1,048,576 particles, 4096-point
scans).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from mcl_3dl_tpu_torch import MCL3DL, checkpoint, worlds
from mcl_3dl_tpu_torch.config import BeamParams, LikelihoodParams, Params
from mcl_3dl_tpu_torch.engine import resolve_device
from mcl_3dl_tpu_torch.io.pcd import read_pcd

NUM_PARTICLES = 1 << 20
CLOUD_POINTS = 4096
N_SCANS = 10            # measurements before the landmark
CHECKPOINT_AT = 5       # measurements before the checkpoint
N_AFTER = 5             # measurements after the map update
ORIGIN = np.array([0.0, 0.0, worlds.SENSOR_Z])
IDENT = np.array([0.0, 0.0, 0.0, 1.0])
# a fiducial-marker pose: 1 cm, 0.01 rad
LANDMARK_COV = np.diag([0.01 ** 2] * 6)


def params(num_particles=NUM_PARTICLES) -> Params:
    """The shipped defaults with every option of the step turned on."""
    return Params(num_particles=num_particles, use_beam_model=True,
                  likelihood=LikelihoodParams(interp="trilinear"),
                  beam=BeamParams(use_raycast_using_dda=True),
                  use_random_sampler_with_normal=True, output_pcd=True)


def engine(device="cuda", num_particles=NUM_PARTICLES) -> MCL3DL:
    """An all-options engine on the flagship room world's map."""
    eng = MCL3DL(params(num_particles), device=device)
    eng.load_map(worlds.world_map())
    return eng


def added_wall() -> np.ndarray:
    """A 1 x 1 m wall at 0.1 m spacing, 0.6 m outside the room's y = 4
    wall: the rays never reach it, and the map's grid grows."""
    xs, zs = np.meshgrid(np.arange(-0.5, 0.5, 0.1), np.arange(0.0, 1.0, 0.1),
                         indexing="ij")
    return np.stack([xs.ravel(), np.full(xs.size, worlds.ROOM + 0.6),
                     zs.ravel()], axis=1)


def pose_error(res, raw=False):
    """``(metres, radians)`` of a published pose (or with ``raw`` the
    unsmoothed mean) from the truth: the origin, identity rotation."""
    pos, rot = (res.raw_pos, res.raw_rot) if raw else (res.pos, res.rot)
    w = abs(float(rot[3])) / float(np.linalg.norm(rot))
    return float(np.linalg.norm(pos)), 2.0 * float(np.arccos(min(w, 1.0)))


def z_bias_bound(p: Params) -> float:
    """How far above the floor the DDA beam can lift the estimate: rays
    passing within ``sqrt(min_dist_thr_sq)`` of a map point are blocked
    (raycast_using_dda.h:237-258), so the floor rays of a pose raised by
    less than that still end SHORT before their endpoint and favour the
    raised pose (the JAX engine's model does the same,
    ``tests/test_torch_dda.py``)."""
    return float(np.sqrt(p.min_dist_thr_sq))


class Scans:
    """The drive's clock and scans: ``push(eng)`` feeds odometry and the
    next scan at the next stamp and returns ``(result, seconds)``;
    ``again(eng)`` feeds the last scan at its stamp (no odometry)."""

    def __init__(self, rng, cloud_points):
        self.rng, self.cloud_points = rng, cloud_points
        self.t, self.cloud = 0.0, None

    def _timed(self, eng, cloud, t):
        sync = eng.device.type == "cuda"
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.push_cloud("lidar", cloud, ORIGIN, t)
        if sync:
            torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def next(self):
        self.t += 0.1
        self.cloud = worlds.scan(self.rng, self.cloud_points)

    def push(self, eng):
        eng.odometry(np.zeros(3), IDENT, self.t)
        return self._timed(eng, self.cloud, self.t)

    def again(self, eng):
        return self._timed(eng, self.cloud, self.t)


def measure(eng, scans, n, on_step=None, twin=None):
    """``n`` measurements; with ``twin``, the same scans into it too, its
    particles, weights and published pose equal to ``eng``'s after each
    (raises otherwise).  Returns the last result."""
    done, res = 0, None
    while done < n:
        scans.next()
        res, dt = scans.push(eng)
        if twin is not None:
            res2, _ = scans.push(twin)
            assert (res is None) == (res2 is None)
            if res is not None:
                a, b = eng.pstate, twin.pstate
                for name in ("pos", "rot", "prob", "n_active"):
                    assert torch.equal(getattr(a, name), getattr(b, name)), (
                        f"checkpointed engine differs in {name}")
                for k in ("pos", "rot"):
                    assert np.array_equal(getattr(res, k), getattr(res2, k)), k
        if res is not None:
            done += 1
            if on_step is not None:
                on_step(dt, res)
    return res


def run(eng, make_engine, rng, cloud_points=CLOUD_POINTS, on_step=None,
        log=print, out_dir=None) -> dict:
    """The all-options drive of the module docstring on ``eng``;
    ``make_engine()`` gives the fresh engine the checkpoint loads into.
    Returns the last result, the tiers seen, the match-cloud calls, the
    PCD's point counts, the inspection outputs and the errors of the
    published pose at the end (whole, horizontal, z) and of the raw pose
    in the first measurement after the landmark."""
    matches = []
    eng.on_match_clouds = lambda t, m, u: matches.append((t, len(m), len(u)))
    tiers = []

    def step(dt, res):
        tiers.append((eng.last_aux["tier_like"], eng.last_aux["tier_beam"]))
        if on_step is not None:
            on_step(dt, res)

    eng.initial_pose(np.zeros(3), IDENT, worlds.TRACKING_COV)
    scans = Scans(rng, cloud_points)
    measure(eng, scans, CHECKPOINT_AT, step)

    out_dir = out_dir or tempfile.mkdtemp()
    ckpt = os.path.join(out_dir, "all_options_checkpoint.npz")
    checkpoint.save_checkpoint(eng, ckpt)
    twin = make_engine()
    checkpoint.load_checkpoint(twin, ckpt)
    assert scans.again(twin)[0] is None      # refills its accumulation buffer
    measure(eng, scans, N_SCANS - CHECKPOINT_AT, step, twin=twin)
    log(f"checkpoint after measurement {CHECKPOINT_AT}: the loaded engine "
        f"equal bit for bit over {N_SCANS - CHECKPOINT_AT} measurements")
    del twin

    eng.landmark(np.zeros(3), IDENT, LANDMARK_COV)
    shape_before = eng.map.df.shape
    eng.update_map(added_wall())
    log(f"landmark at the truth; update_map: grid {shape_before} -> "
        f"{eng.map.df.shape}, occupancy {eng.map.occ.shape}")
    after_landmark = measure(eng, scans, 1, step)
    last = measure(eng, scans, N_AFTER - 1, step)

    pcd = os.path.join(out_dir, "all_options_accumulated.pcd")
    written = eng.save_accumulated_pcd(pcd)
    read_back = len(read_pcd(pcd)[0])
    pos, rot, prob = eng.get_particles()
    scan = worlds.scan(rng, 64)
    status = eng.debug_beam_status(np.zeros(3), IDENT, scan,
                                   np.zeros(len(scan), np.int64),
                                   ORIGIN[None])
    diag = eng.diagnostics()
    return dict(last=last, tiers=tiers, matches=matches, pcd_points=written,
                pcd_read=read_back,
                particles=((pos.shape, pos.dtype), (rot.shape, rot.dtype),
                           (prob.shape, prob.dtype)),
                beam_status=(status.shape, status.dtype,
                             np.bincount(status, minlength=4).tolist()),
                diagnostics=diag,
                pose_err=pose_error(last),
                xy_err=float(np.linalg.norm(last.pos[:2])),
                z=float(last.pos[2]), raw_z=float(last.raw_pos[2]),
                raw_err_after_landmark=pose_error(after_landmark, raw=True))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--particles", type=int, default=NUM_PARTICLES)
    ap.add_argument("--cloud-points", type=int, default=CLOUD_POINTS)
    a = ap.parse_args(argv)
    device = resolve_device("cpu" if a.cpu else None)
    eng = engine(device, a.particles)
    def on_step(dt, res):
        err, ang = pose_error(res)
        print(f"push_cloud {dt * 1e3:.2f} ms, published pose {res.pos} "
              f"({err:.4f} m / {ang:.4f} rad from the truth), raw z "
              f"{float(res.raw_pos[2]):.4f} m", flush=True)

    out = run(eng, lambda: engine(device, a.particles),
              np.random.default_rng(0), a.cloud_points, on_step=on_step)
    print({k: v for k, v in out.items() if k != "last"})
    return out


if __name__ == "__main__":
    main()
