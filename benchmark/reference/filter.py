"""The filter's tail after the models, in float64 (src/mcl_3dl.cpp:402-751,
pf.h:245-360, state_6dof.h:316-355, filter.h:54-94).

The weights are multiplied by both models' scores and the odometry-error
prior and normalized (the entropy beside them); the bias toward the
previous pose weights the published mean; the mean's orientation is
taken through the averaged front and up vectors; the covariance is about
the unbiased mean with wrapped angles; the map-to-odometry transform is
smoothed by first-order low-pass filters, reset on a pose jump.
Quaternions are (x, y, z, w).
"""

from __future__ import annotations

import math

import torch

EPS_IDENTITY = 1e-6


def mul(a, b):
    x1, y1, z1, w1 = a.unbind(-1)
    x2, y2, z2, w2 = b.unbind(-1)
    return torch.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
                        w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
                        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1)


def inv(q):
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0]) / (q * q).sum(
        -1, keepdim=True)


def rotate(q, v):
    u, w = q[..., :3], q[..., 3:]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def angle(q):
    """Rotation angle in (-pi, pi], 0 near the identity."""
    w = q[..., 3]
    ang = torch.acos(w.clamp(-1.0, 1.0)) * 2.0
    ang = torch.where(ang > math.pi, ang - 2.0 * math.pi, ang)
    return torch.where(w.abs() >= 1.0 - EPS_IDENTITY, torch.zeros_like(ang),
                       ang)


def to_rpy(q):
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.atan2(2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
        torch.asin((-2 * (x * z - w * y)).clamp(-1, 1)),
        torch.atan2(2 * (x * y + w * z), 1 - 2 * (y * y + z * z))], -1)


def from_rpy(rpy):
    cr, sr = torch.cos(rpy[..., 0] / 2), torch.sin(rpy[..., 0] / 2)
    cp, sp = torch.cos(rpy[..., 1] / 2), torch.sin(rpy[..., 1] / 2)
    cy, sy = torch.cos(rpy[..., 2] / 2), torch.sin(rpy[..., 2] / 2)
    return torch.stack([cy * sr * cp - sy * cr * sp,
                        cy * cr * sp + sy * sr * cp,
                        sy * cr * cp - cy * sr * sp,
                        cy * cr * cp + sy * sr * sp], -1)


def from_frame(front, up):
    """The quaternion of a (front, up) frame (quat.h:59-75)."""
    xv = front / torch.linalg.vector_norm(front)
    yv = torch.linalg.cross(up, xv, dim=-1)
    yv = yv / torch.linalg.vector_norm(yv)
    zv = torch.linalg.cross(xv, yv, dim=-1)
    zv = zv / torch.linalg.vector_norm(zv)
    xx, yy, zz = xv[0], yv[1], zv[2]
    w = torch.sqrt((1 + xx + yy + zz).clamp(min=0)) / 2
    x = torch.sqrt((1 + xx - yy - zz).clamp(min=0)) / 2
    y = torch.sqrt((1 - xx + yy - zz).clamp(min=0)) / 2
    z = torch.sqrt((1 - xx - yy + zz).clamp(min=0)) / 2
    x = torch.where(zv[1] - yv[2] > 0, -x, x)
    y = torch.where(xv[2] - zv[0] > 0, -y, y)
    z = torch.where(yv[0] - xv[1] > 0, -z, z)
    return torch.stack([x, y, z, w])


def normal(x, sigma):
    return torch.exp(-x * x / (2 * sigma * sigma)) / math.sqrt(
        2 * math.pi * sigma * sigma)


def weighted_mean(pos, rot, w):
    """Weighted mean position and orientation (front/up averaging)."""
    x, y, z, qw = rot.unbind(-1)
    front = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y + qw * z),
                         2 * (x * z - qw * y)], -1)
    up = torch.stack([2 * (x * z + qw * y), 2 * (y * z - qw * x),
                      1 - 2 * (x * x + y * y)], -1)
    total = w.sum()
    return ((pos * w[:, None]).sum(0) / total,
            from_frame((front * w[:, None]).sum(0), (up * w[:, None]).sum(0)))


def covariance(pos, rot, w):
    mean_pos, mean_rot = weighted_mean(pos, rot, w)
    d_rpy = to_rpy(rot) - to_rpy(mean_rot)
    d_rpy = d_rpy - 2 * math.pi * torch.round(d_rpy / (2 * math.pi))
    d = torch.cat([pos - mean_pos, d_rpy], -1)
    return (d * w[:, None]).T @ d / w.sum()


def lpf_step(k, x, out, is_angle, value):
    """One sample through first-order filters ``(k [.., 4], x, out)``:
    ``(x, out)``; an angle input is unwrapped to within pi of the
    output."""
    wrapped = out + (value - out) - 2 * math.pi * torch.round(
        (value - out) / (2 * math.pi))
    v = torch.where(is_angle, wrapped, value)
    x = k[..., 0] * v + k[..., 1] * x
    return x, k[..., 2] * v + k[..., 3] * x


def lpf_set(k, value):
    return (1 - k[..., 2]) * value / k[..., 3], value


def tail(state, lik, m, odom_pos, odom_rot, prev_pos, prev_rot, f_pos,
         f_ang):
    """The step after the models for one robot, all float64.

    ``state``: the particles before the step (``pos``, ``rot``, ``prob``,
    ``odom_err_lin``, ``n_active``); ``lik`` [N] the product of the two
    models' scores; ``f_pos``/``f_ang``: the output filters as ``(k, x,
    out, angle)``.  Returns the raw (biased mean) and published poses,
    the covariance and the entropy."""
    d = torch.float64
    pos, rot = state["pos"].to(d), state["rot"].to(d)
    n = pos.shape[0]
    mask = (torch.arange(n, device=pos.device) < int(state["n_active"])).to(d)
    odom_err = normal(torch.linalg.vector_norm(
        state["odom_err_lin"].to(d), dim=-1), m["odom_err_integ_lin_sigma"])
    prob = state["prob"].to(d) * lik.to(d) * odom_err * mask
    total = prob.sum()
    if total > 0:
        prob = prob / total
        entropy = -torch.where(prob > 0, prob * torch.log(prob),
                               torch.zeros_like(prob)).sum()
    else:
        prob, entropy = state["prob"].to(d), prob.new_zeros(())
    prev_pos, prev_rot = prev_pos.to(d), prev_rot.to(d)
    bias = (normal(torch.linalg.vector_norm(pos - prev_pos, dim=-1),
                   m["bias_var_dist"])
            * normal(angle(mul(rot, inv(prev_rot))), m["bias_var_ang"])
            + 1e-6)
    e_pos, e_rot = weighted_mean(pos, rot, prob * bias * mask)
    e_rot = e_rot / torch.linalg.vector_norm(e_rot)
    cov = covariance(pos, rot, prob * mask)

    odom_pos, odom_rot = odom_pos.to(d), odom_rot.to(d)
    map_rot = mul(e_rot, inv(odom_rot))
    map_pos = e_pos - rotate(map_rot, odom_pos)
    jumped = bool((torch.linalg.vector_norm(e_pos - prev_pos) > m["jump_dist"])
                  | (angle(mul(inv(e_rot), prev_rot)).abs() > m["jump_ang"]))
    rpy = to_rpy(map_rot)
    filters = []
    for (k, x, out, is_angle), value in ((f_ang, rpy), (f_pos, map_pos)):
        k, x, out = k.to(d), x.to(d), out.to(d)
        if jumped:
            x, out = lpf_set(k, value)
        filters.append(lpf_step(k, x, out, is_angle, value)[1])
    rpy_s, map_pos_s = filters
    map_rot_s = from_rpy(rpy_s)
    return dict(raw_pos=e_pos, raw_rot=e_rot, pos=map_pos_s + rotate(
        map_rot_s, odom_pos), rot=mul(map_rot_s, odom_rot), cov=cov,
        entropy=entropy)
