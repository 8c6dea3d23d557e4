"""Test worlds.

* The flagship room world: an 8 x 8 m room with floor, walls and three
  pillars at non-symmetric positions (so no rotation or reflection of the
  square aliases the pose), and an analytic LIDAR scan of it from the
  origin with the sensor at z = 0.5 m.  Restated from the repository's
  driver entry (``__graft_entry__.py``) so the port does not import it.
* ``make_room`` and ``simulate_scan``: the grid-sampled room and the
  nearest-point LIDAR simulation of the JAX package's test helpers
  (``tests/worlds.py``, after the reference's integration tests,
  test/src/test_global_localization.cpp:50-127), with the float32
  rotations in torch.
"""

from __future__ import annotations

import numpy as np
import torch

from mcl_3dl_tpu_torch.math import quat as mq

PILLARS = ((2.0, 1.0, 0.35), (-1.6, 2.4, 0.45), (0.6, -2.3, 0.25))
ROOM = 4.0          # half-extent of the square room
SENSOR_Z = 0.5      # sensor height above base
# initial-pose covariance of converged tracking: 0.1 m, 0.05 rad roll and
# pitch, 0.1 rad yaw
TRACKING_COV = np.diag([0.1 ** 2, 0.1 ** 2, 0.1 ** 2, 0.05 ** 2, 0.05 ** 2,
                        0.1 ** 2])


def world_map() -> np.ndarray:
    """Map point cloud [M, 3]: room walls + floor + pillar shells."""
    xs = np.arange(-ROOM, ROOM, 0.1)
    zs = np.arange(0.0, 2.0, 0.1)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    pts = []
    for y in (-ROOM, ROOM):
        pts.append(np.stack([gx.ravel(), np.full(gx.size, y), gz.ravel()], 1))
    gy, gz2 = np.meshgrid(xs, zs, indexing="ij")
    for x in (-ROOM, ROOM):
        pts.append(np.stack([np.full(gy.size, x), gy.ravel(), gz2.ravel()], 1))
    gx2, gy2 = np.meshgrid(xs, xs, indexing="ij")
    pts.append(np.stack([gx2.ravel(), gy2.ravel(), np.zeros(gx2.size)], 1))
    for cx, cy, r in PILLARS:
        ang = np.arange(0.0, 2 * np.pi, 0.1 / max(r, 0.1))
        pa, pz = np.meshgrid(ang, zs, indexing="ij")
        pts.append(np.stack(
            [cx + r * np.cos(pa.ravel()), cy + r * np.sin(pa.ravel()),
             pz.ravel()], 1))
    return np.concatenate(pts, axis=0)


def scan(rng: np.random.Generator, cloud_points: int) -> np.ndarray:
    """Analytic scan [P, 3] from the true pose (base at the origin): wall
    and pillar returns with 2-D cylinder occlusion, plus slanted floor
    returns inside the pillar-free disk, with 1 cm noise."""
    p = cloud_points
    n_wall = p - p // 4
    az = rng.uniform(-np.pi, np.pi, n_wall)
    ca, sa = np.cos(az), np.sin(az)
    t = np.minimum(ROOM / np.maximum(np.abs(ca), 1e-9),
                   ROOM / np.maximum(np.abs(sa), 1e-9))
    for cx, cy, r in PILLARS:
        b = ca * cx + sa * cy
        disc = b * b - (cx * cx + cy * cy - r * r)
        hit = (disc > 0) & (b > 0)
        t_p = b - np.sqrt(np.maximum(disc, 0.0))
        t = np.where(hit & (t_p > 0) & (t_p < t), t_p, t)
    wall = np.stack([t * ca, t * sa, rng.uniform(0.1, 1.5, n_wall)], axis=1)
    n_floor = p - n_wall
    azf = rng.uniform(-np.pi, np.pi, n_floor)
    rf = rng.uniform(1.0, 2.0, n_floor)
    floor = np.stack([rf * np.cos(azf), rf * np.sin(azf), np.zeros(n_floor)],
                     axis=1)
    cloud = np.concatenate([wall, floor], axis=0).astype(np.float32)
    cloud += rng.normal(0.0, 0.01, cloud.shape).astype(np.float32)
    return cloud


def make_room(x0=-5.0, x1=5.0, y0=-5.0, y1=5.0, z0=0.0, z1=2.0, grid=0.1,
              with_ceiling=False) -> np.ndarray:
    """Floor and four walls (optionally a ceiling) sampled on a grid."""
    pts = []
    xs = np.arange(x0, x1 + grid / 2, grid)
    ys = np.arange(y0, y1 + grid / 2, grid)
    zs = np.arange(z0, z1 + grid / 2, grid)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pts.append(np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, z0)], axis=1))
    if with_ceiling:
        pts.append(np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, z1)],
                            axis=1))
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    for y in (y0, y1):
        pts.append(np.stack([gx.ravel(), np.full(gx.size, y), gz.ravel()], axis=1))
    gy, gz = np.meshgrid(ys, zs, indexing="ij")
    for x in (x0, x1):
        pts.append(np.stack([np.full(gy.size, x), gy.ravel(), gz.ravel()], axis=1))
    return np.concatenate(pts, axis=0)


def simulate_scan(map_points: np.ndarray, pos: np.ndarray, rot: np.ndarray,
                  n_rays: int = 256, max_range: float = 10.0,
                  fov_elev=(-0.3, 0.3), noise: float = 0.0,
                  seed: int = 0) -> np.ndarray:
    """A LIDAR scan from the sensor pose: for each of ``n_rays`` random
    rays, the nearest map point within ~2.5 degrees of it, in the sensor
    (base) frame."""
    rng = np.random.default_rng(seed)
    az = rng.uniform(-np.pi, np.pi, n_rays)
    el = rng.uniform(fov_elev[0], fov_elev[1], n_rays)
    dirs = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                     np.sin(el)], axis=1)
    q = torch.as_tensor(np.asarray(rot, np.float32))
    dirs_w = mq.rotate(q, torch.as_tensor(dirs.astype(np.float32))).numpy()
    rel = map_points - np.asarray(pos)[None, :]
    dist = np.linalg.norm(rel, axis=1)
    ok = dist < max_range
    rel, dist_ok = rel[ok], dist[ok]
    unit = rel / dist_ok[:, None]
    hits = []
    for d in dirs_w:
        cand = unit @ d > 0.999
        if not cand.any():
            continue
        hits.append(rel[np.argmin(np.where(cand, dist_ok, np.inf))])
    if not hits:
        return np.zeros((0, 3), np.float32)
    hits = np.asarray(hits)
    if noise > 0:
        hits = hits + rng.normal(0, noise, hits.shape)
    return mq.rotate(mq.inv(q), torch.as_tensor(hits.astype(np.float32))).numpy()
