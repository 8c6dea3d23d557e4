"""numpy mirror of the quaternion kernels for host-side glue.

Same formulas as :mod:`mcl_3dl_tpu_torch.math.quat` (and quat.h); used in
engine host paths (frame transforms at scan intake, odometry
bookkeeping) where dispatching tiny ops to the accelerator would
dominate latency.
"""

from __future__ import annotations

import numpy as np


def identity():
    return np.array([0.0, 0.0, 0.0, 1.0], np.float32)


def mul(q1, q2):
    q1, q2 = np.asarray(q1), np.asarray(q2)
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return np.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        axis=-1,
    )


def conj(q):
    return np.asarray(q) * np.array([-1.0, -1.0, -1.0, 1.0])


def inv(q):
    q = np.asarray(q)
    return conj(q) / np.sum(q * q, axis=-1, keepdims=True)


def rotate(q, v):
    q, v = np.asarray(q), np.asarray(v)
    u = q[..., :3]
    w = q[..., 3:4]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def from_rpy(rpy):
    rpy = np.asarray(rpy)
    t2, t3 = np.cos(rpy[..., 0] / 2), np.sin(rpy[..., 0] / 2)
    t4, t5 = np.cos(rpy[..., 1] / 2), np.sin(rpy[..., 1] / 2)
    t0, t1 = np.cos(rpy[..., 2] / 2), np.sin(rpy[..., 2] / 2)
    return np.stack(
        [
            t0 * t3 * t4 - t1 * t2 * t5,
            t0 * t2 * t5 + t1 * t3 * t4,
            t1 * t2 * t4 - t0 * t3 * t5,
            t0 * t2 * t4 + t1 * t3 * t5,
        ],
        axis=-1,
    )


def to_rpy(q):
    q = np.asarray(q)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ysq = y * y
    t0 = -2.0 * (ysq + z * z) + 1.0
    t1 = 2.0 * (x * y + w * z)
    t2 = np.clip(-2.0 * (x * z - w * y), -1.0, 1.0)
    t3 = 2.0 * (y * z + w * x)
    t4 = -2.0 * (x * x + ysq) + 1.0
    return np.stack(
        [np.arctan2(t3, t4), np.arcsin(t2), np.arctan2(t1, t0)], axis=-1
    )
