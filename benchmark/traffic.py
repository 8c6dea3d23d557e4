"""What every traffic mix is made of: the world, the scan caster, and the
messages a drive hands to the loops in ``cells.py``.  A mix's file under
``traffic/`` names its ``drive``, a generator of its own under
``drives/<drive>.py`` (``harness.drive``), which reads the mix's
parameters and the configuration's sizes, and ``--seed`` alone.

The world is the flagship room (an 8 x 8 m room with floor, walls and
three pillars; the map's points are made here, and the program and the
reference are handed the same array).  Scans come from an analytic
caster: from a pose anywhere in the room, wall and pillar returns with
2-D occlusion at heights between 0.1 and 1.5 m, a quarter of the points
as floor returns nearer than the first obstacle, and 1 cm noise.

A drive returns a ``Lap`` (one robot's messages, looped by
``cells.single``) or a ``Fleet`` (robots' poses and scan banks, stepped
by ``cells.fleet``); its module's ``LOOP`` names the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

PILLARS = ((2.0, 1.0, 0.35), (-1.6, 2.4, 0.45), (0.6, -2.3, 0.25))
ROOM = 4.0
SENSOR_Z = 0.5
GRAVITY = 9.80665


def world_map() -> np.ndarray:
    """The room's map points [M, 3]: walls, floor and pillar shells on a
    0.1 m grid up to 2 m."""
    xs = np.arange(-ROOM, ROOM, 0.1)
    zs = np.arange(0.0, 2.0, 0.1)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    pts = [np.stack([gx.ravel(), np.full(gx.size, y), gz.ravel()], 1)
           for y in (-ROOM, ROOM)]
    pts += [np.stack([np.full(gx.size, x), gx.ravel(), gz.ravel()], 1)
            for x in (-ROOM, ROOM)]
    fx, fy = np.meshgrid(xs, xs, indexing="ij")
    pts.append(np.stack([fx.ravel(), fy.ravel(), np.zeros(fx.size)], 1))
    for cx, cy, r in PILLARS:
        ang = np.arange(0.0, 2 * np.pi, 0.1 / max(r, 0.1))
        pa, pz = np.meshgrid(ang, zs, indexing="ij")
        pts.append(np.stack([cx + r * np.cos(pa.ravel()),
                             cy + r * np.sin(pa.ravel()), pz.ravel()], 1))
    return np.concatenate(pts, axis=0)


def first_obstacle(x, y, ca, sa):
    """Range along unit directions ``(ca, sa)`` from ``(x, y)`` (arrays of
    one shape) to the first wall or pillar."""
    t = np.minimum((ROOM - np.sign(ca) * x) / np.maximum(np.abs(ca), 1e-9),
                   (ROOM - np.sign(sa) * y) / np.maximum(np.abs(sa), 1e-9))
    for cx, cy, r in PILLARS:
        dx, dy = cx - x, cy - y
        b = ca * dx + sa * dy
        disc = b * b - (dx * dx + dy * dy - r * r)
        t_p = b - np.sqrt(np.maximum(disc, 0.0))
        t = np.where((disc > 0) & (b > 0) & (t_p > 0) & (t_p < t), t_p, t)
    return t


def cast(rng, x, y, yaw, points: int, noise: float) -> np.ndarray:
    """Scans [..., P, 3] f32 in the base frame from poses ``x``, ``y``,
    ``yaw`` (arrays of one shape ``...``)."""
    x, y, yaw = (np.asarray(v, np.float64)[..., None] for v in (x, y, yaw))
    shape = np.broadcast_shapes(x.shape[:-1], y.shape[:-1], yaw.shape[:-1])
    n_wall = points - points // 4
    az = rng.uniform(-np.pi, np.pi, shape + (n_wall,))
    t = first_obstacle(x, y, np.cos(yaw + az), np.sin(yaw + az))
    wall = np.stack([t * np.cos(az), t * np.sin(az),
                     rng.uniform(0.1, 1.5, az.shape)], -1)
    n_floor = points - n_wall
    azf = rng.uniform(-np.pi, np.pi, shape + (n_floor,))
    tf = first_obstacle(x, y, np.cos(yaw + azf), np.sin(yaw + azf))
    rf = np.minimum(rng.uniform(1.0, 2.0, azf.shape), 0.9 * tf)
    floor = np.stack([rf * np.cos(azf), rf * np.sin(azf),
                      np.zeros(azf.shape)], -1)
    cloud = np.concatenate([wall, floor], axis=-2)
    cloud += rng.normal(0.0, noise, cloud.shape)
    return cloud.astype(np.float32)


def yaw_quat(yaw) -> np.ndarray:
    yaw = np.asarray(yaw, np.float64)
    z = np.zeros_like(yaw)
    return np.stack([z, z, np.sin(yaw / 2), np.cos(yaw / 2)], -1)


def bridged_walk(rng, n, sigma, rate, dims):
    """A random walk of ``n`` steps of ``sigma`` noise plus ``rate`` a step
    out and back (a triangle), closed: it starts and ends at zero."""
    steps = rng.normal(0.0, sigma, (n, dims))
    walk = np.cumsum(steps, axis=0)
    walk -= np.linspace(0.0, 1.0, n)[:, None] * walk[-1]
    tri = rate * np.minimum(np.arange(n), n - np.arange(n))
    return walk + tri[:, None] * np.ones(dims)


class Message(NamedTuple):
    kind: str              # "odom", "imu", "cloud" or "reseed"
    t: float               # drive time of the lap, s
    a: np.ndarray          # odom/reseed position, imu acceleration, cloud points
    b: np.ndarray          # odom/imu/reseed orientation, cloud sensor origin


class Lap(NamedTuple):
    messages: list         # one lap, in time order
    duration: float        # s
    truth: np.ndarray          # [S, 3] x, y, yaw of each scan's true pose


class Fleet(NamedTuple):
    poses: np.ndarray      # [R, 3] x, y, yaw
    bank: np.ndarray       # [scan_bank, R, P, 3] base-frame scans
