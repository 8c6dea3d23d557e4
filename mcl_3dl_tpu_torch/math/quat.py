"""Batched quaternion functions on torch tensors.

Quaternions have trailing dimension 4 in ``(x, y, z, w)`` order, vectors
trailing dimension 3; every function broadcasts over leading batch
dimensions.  Formulas and operation order follow the JAX package's
``math/quat.py`` (and the reference's ``include/mcl_3dl/quat.h``) so the
pose track is comparable.
"""

from __future__ import annotations

import math

import torch

_AXIS_EPS = 1e-6


def identity(shape=(), device=None, dtype=torch.float32):
    """Identity quaternion (0, 0, 0, 1) broadcast to ``shape + (4,)``."""
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 3] = 1.0
    return q


def mul(q1, q2):
    """Hamilton product ``q1 * q2`` (quat.h:131-138)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def conj(q):
    """Conjugate (-x, -y, -z, w) (quat.h:183-186)."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def inv(q):
    """Inverse: conj / |q|^2 (quat.h:187-190)."""
    return conj(q) / torch.sum(q * q, dim=-1, keepdim=True)


def norm(q):
    """Quaternion norm ``|q|``."""
    return torch.sqrt(torch.sum(q * q, dim=-1))


def normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def rotate(q, v):
    """Rotate vector(s) ``v`` by quaternion(s) ``q``: q v q* (quat.h:139-143),
    in the cross-product form ``v + 2 w (u x v) + 2 u x (u x v)``."""
    u = q[..., :3]
    w = q[..., 3:4]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def rotation_matrix(q):
    """Rotation matrix ``[..., 3, 3]`` with ``R @ v == rotate(q, v)``."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def from_rpy(rpy):
    """Quaternion from roll/pitch/yaw (quat.h:202-215)."""
    t2 = torch.cos(rpy[..., 0] / 2)
    t3 = torch.sin(rpy[..., 0] / 2)
    t4 = torch.cos(rpy[..., 1] / 2)
    t5 = torch.sin(rpy[..., 1] / 2)
    t0 = torch.cos(rpy[..., 2] / 2)
    t1 = torch.sin(rpy[..., 2] / 2)
    return torch.stack(
        [
            t0 * t3 * t4 - t1 * t2 * t5,
            t0 * t2 * t5 + t1 * t3 * t4,
            t1 * t2 * t4 - t0 * t3 * t5,
            t0 * t2 * t4 + t1 * t3 * t5,
        ],
        dim=-1,
    )


def to_rpy(q):
    """Roll/pitch/yaw from quaternion (quat.h:191-201)."""
    x, y, z, w = q.unbind(-1)
    ysq = y * y
    t0 = -2.0 * (ysq + z * z) + 1.0
    t1 = 2.0 * (x * y + w * z)
    t2 = torch.clamp(-2.0 * (x * z - w * y), -1.0, 1.0)
    t3 = 2.0 * (y * z + w * x)
    t4 = -2.0 * (x * x + ysq) + 1.0
    return torch.stack(
        [torch.atan2(t3, t4), torch.asin(t2), torch.atan2(t1, t0)], dim=-1)


def from_axis_angle(axis, ang):
    """Quaternion from (axis, angle); the axis is normalized (quat.h:216-225)."""
    a = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    s = torch.sin(ang / 2)[..., None]
    q = torch.cat([a * s, torch.cos(ang / 2)[..., None]], dim=-1)
    return normalize(q)


def _angle_of(w):
    near_identity = torch.abs(w) >= 1.0 - _AXIS_EPS
    ang = torch.acos(torch.clamp(w, -1.0, 1.0)) * 2.0
    ang = torch.where(ang > math.pi, ang - 2.0 * math.pi, ang)
    return torch.where(near_identity, torch.zeros_like(ang), ang), near_identity


def to_axis_angle(q):
    """(axis, angle) from quaternion (quat.h:226-239): |w| >= 1 - 1e-6 is
    treated as no rotation about (0, 0, 1); the angle is wrapped into
    (-pi, pi]."""
    w = q[..., 3]
    ang, near_identity = _angle_of(w)
    wsq = torch.clamp(1.0 - w * w, min=_AXIS_EPS * _AXIS_EPS)
    axis = q[..., :3] / torch.sqrt(wsq)[..., None]
    default_axis = torch.zeros_like(axis)
    default_axis[..., 2] = 1.0
    axis = torch.where(near_identity[..., None], default_axis, axis)
    return axis, ang


def angle(q):
    """Rotation angle only."""
    return _angle_of(q[..., 3])[0]


def weighted(q, s):
    """Scale the rotation angle by ``s`` (quat.h:168-174)."""
    axis, ang = to_axis_angle(q)
    return from_axis_angle(axis, ang * s)


def rotate_axis(q, r):
    """Rotate the rotation axis of ``q`` by quaternion ``r``
    (quat.h:240-246)."""
    axis, ang = to_axis_angle(q)
    return from_axis_angle(rotate(r, axis), ang)


def from_frame(forward, up):
    """Quaternion from a (forward, up) frame (quat.h:59-75): the kernel of
    the quaternion-safe weighted particle mean."""
    xv = forward / torch.linalg.vector_norm(forward, dim=-1, keepdim=True)
    yv = torch.linalg.cross(up, xv, dim=-1)
    yv = yv / torch.linalg.vector_norm(yv, dim=-1, keepdim=True)
    zv = torch.linalg.cross(xv, yv, dim=-1)
    zv = zv / torch.linalg.vector_norm(zv, dim=-1, keepdim=True)

    xx, yy, zz = xv[..., 0], yv[..., 1], zv[..., 2]
    w = torch.sqrt(torch.clamp(1.0 + xx + yy + zz, min=0.0)) / 2.0
    x = torch.sqrt(torch.clamp(1.0 + xx - yy - zz, min=0.0)) / 2.0
    y = torch.sqrt(torch.clamp(1.0 - xx + yy - zz, min=0.0)) / 2.0
    z = torch.sqrt(torch.clamp(1.0 - xx - yy + zz, min=0.0)) / 2.0
    x = torch.where(zv[..., 1] - yv[..., 2] > 0, -x, x)
    y = torch.where(xv[..., 2] - zv[..., 0] > 0, -y, y)
    z = torch.where(yv[..., 0] - xv[..., 1] > 0, -z, z)
    return torch.stack([x, y, z, w], dim=-1)
