"""Per-particle scores of both LIDAR models, in blocks of particles.

Likelihood field (lidar_measurement_model_likelihood.cpp:105-139): each
sampled point moved by the particle's pose; a point whose field distance
``d`` is at most ``match_dist_min`` adds ``match_weight *
(match_dist_min - max(d, match_dist_flat))``; the quality is the matched
share of the valid points.  An empty sample scores 1 with quality 0.

Beam model (lidar_measurement_model_beam.cpp:124-192): a ray from the
particle's sensor origin to each sampled beam point.  Its first
collision is a total reflection when the incidence is grazing (sine at
most ``sin(ang_total_ref)``), a hit within ``hit_range`` of the scan
point, else short; no collision is long.  Short beams are penalized (and
long ones unless ``add_penalty_short_only_mode``); the score is
``beam_likelihood ** (penalized / num_points)``, floored at
``beam_likelihood``.  Two raycasts, as the program states them: the
reference's fixed march (raycasts/raycast_using_kdtree.h:58-109), probes
every ``map_grid_min`` from the second probe to ``(|ray| + hit_range) /
grid``, a collision where the field is within the voxel's half
diagonal; and the port's sphere trace at tier 2, which steps by the
field's clearance, at least one grid step, for at most
``max_sphere_steps`` probes.  The incidence is the field's drop over the
span from where the ray enters the truncation band to the collision.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.field import Field, f32

BLOCK = 1 << 18


def rotation(rot):
    """Rotation matrices [N, 3, 3] of quaternions (x, y, z, w) [N, 4]."""
    q = rot / torch.linalg.vector_norm(rot, dim=-1, keepdim=True)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        dim=-1).reshape(-1, 3, 3)


def _move(rmat, pos, pts):
    """``pts`` [K, 3] moved by each pose: [N, K, 3]."""
    return (rmat[:, None, :, :] * pts[None, :, None, :]).sum(-1) \
        + pos[:, None, :]


def likelihood(field: Field, pos, rot, pts, valid, m, dtype=torch.float32):
    """``(score [N], quality [N])`` in float32, computed in ``dtype``."""
    out_s, out_q = [], []
    n_valid = int(valid.sum())
    mdm = f32(m["match_dist_min"])
    for s in range(0, pos.shape[0], BLOCK):
        rmat = rotation(rot[s:s + BLOCK]).to(dtype)
        q = _move(rmat, pos[s:s + BLOCK].to(dtype), pts.to(dtype))
        d = field.nearest(q, dtype)
        matched = (d <= mdm) & valid[None, :]
        contrib = (f32(m["match_weight"]) * (
            mdm - torch.clamp(d, min=f32(m["match_dist_flat"])))).clamp(min=0)
        score = torch.where(matched, contrib, torch.zeros_like(contrib)).sum(
            -1).float()
        count = matched.sum(-1).float()
        out_s.append(score)
        out_q.append(count / max(n_valid, 1))
    score, qual = torch.cat(out_s), torch.cat(out_q)
    if n_valid == 0:
        return torch.ones_like(score), torch.zeros_like(qual)
    return score, qual


def _fixed_march(field, begin, direction, length, m, dtype):
    """``(found, collision point, sine of incidence)`` of the fixed
    march."""
    grid = f32(m["map_grid_min"])
    radius = f32(math.sqrt(2.0) * m["map_grid_max"] / 2.0)
    entry_thr = f32(field.trunc * 0.99)
    l_b = torch.floor((length + f32(m["hit_range"]))
                      / torch.full((), grid, dtype=dtype,
                                   device=begin.device))
    shape = begin.shape[:-1]
    found = torch.zeros(shape, dtype=torch.bool, device=begin.device)
    t_hit = torch.zeros(shape, dtype=dtype, device=begin.device)
    d_hit = torch.zeros_like(t_hit)
    t_entry = torch.full_like(t_hit, -1.0)
    d_entry = torch.full_like(t_hit, f32(field.trunc))
    for i in range(1, int(m["fixed_steps"])):
        ti = f32(i * grid)
        d = field.nearest(begin + direction * ti, dtype)
        elig = (i < l_b) & ~found
        enter = elig & (d < entry_thr) & (t_entry < 0)
        t_entry = torch.where(enter, torch.full_like(t_entry, ti), t_entry)
        d_entry = torch.where(enter, d, d_entry)
        hit = elig & (d <= radius)
        t_hit = torch.where(hit, torch.full_like(t_hit, ti), t_hit)
        d_hit = torch.where(hit, d, d_hit)
        found = found | hit
    span = t_hit - t_entry
    sin = torch.where(found & (t_entry >= 0) & (span > grid),
                      ((d_entry - d_hit) / span.clamp(min=1e-6)).clamp(0, 1),
                      torch.ones_like(span))
    cpos = torch.where(found[..., None], begin + direction * t_hit[..., None],
                       torch.zeros_like(begin))
    return found, cpos, torch.where(found, sin, torch.zeros_like(sin))


def _sphere_trace(field, begin, direction, length, m, dtype):
    """``(found, collision point, sine of incidence)`` of the sphere
    trace."""
    grid = f32(m["map_grid_min"])
    radius = f32(math.sqrt(2.0) * m["map_grid_max"] / 2.0)
    entry_thr = f32(field.trunc * 0.99)
    dev = begin.device
    max_t = torch.floor((length + f32(m["hit_range"]))
                        / torch.full((), grid, dtype=dtype, device=dev)) * grid
    w = torch.tensor(field.weights, dtype=dtype, device=dev)
    wu = torch.linalg.vector_norm(direction * w, dim=-1)
    shape = begin.shape[:-1]
    found = torch.zeros(shape, dtype=torch.bool, device=dev)
    t = torch.full(shape, grid, dtype=dtype, device=dev)
    cpos = torch.zeros_like(begin)
    d_hit = torch.zeros(shape, dtype=dtype, device=dev)
    t_entry = torch.full_like(d_hit, -1.0)
    d_entry = torch.full_like(d_hit, f32(field.trunc))
    for _ in range(int(m["max_sphere_steps"])):
        p = begin + direction * t[..., None]
        d = field.nearest(p, dtype)
        live = (t < max_t) & ~found
        enter = live & (d < entry_thr) & (t_entry < 0)
        t_entry = torch.where(enter, t, t_entry)
        d_entry = torch.where(enter, d, d_entry)
        hit = live & (d <= radius)
        cpos = torch.where(hit[..., None], p, cpos)
        d_hit = torch.where(hit, d, d_hit)
        step = ((d - radius) / wu.clamp(min=1e-6)).clamp(min=grid)
        t = torch.where(live & ~hit, t + step, t)
        found = found | hit
    span = torch.linalg.vector_norm(
        cpos - (begin + direction * t_entry[..., None]), dim=-1).clamp(min=1e-6)
    sin = torch.where(found & (t_entry >= 0) & (span > grid),
                      ((d_entry - d_hit) / span).clamp(0, 1),
                      torch.ones_like(span))
    return found, cpos, torch.where(found, sin, torch.zeros_like(sin))


def beam(field: Field, pos, rot, pts, origins, valid, m, sphere=False,
         dtype=torch.float32):
    """The beam model's score [N] in float32, computed in ``dtype``, with
    the sphere trace where ``sphere``, else the fixed march."""
    march = _sphere_trace if sphere else _fixed_march
    n_valid = int(valid.sum())
    per_beam = m["beam_likelihood"] ** (1.0 / float(m["num_points"]))
    hr2 = f32(m["hit_range"] ** 2)
    out = []
    for s in range(0, pos.shape[0], BLOCK):
        rmat = rotation(rot[s:s + BLOCK]).to(dtype)
        p = pos[s:s + BLOCK].to(dtype)
        begin = _move(rmat, p, origins.to(dtype))
        end = _move(rmat, p, pts.to(dtype))
        seg = end - begin
        length = torch.linalg.vector_norm(seg, dim=-1)
        direction = seg / length.clamp(min=1e-12)[..., None]
        found, cpos, sin = march(field, begin, direction, length, m, dtype)
        dist2 = ((end - cpos) ** 2).sum(-1)
        graze = found & (sin <= f32(math.sin(m["ang_total_ref"])))
        short = found & ~graze & (dist2 >= hr2)
        pen = short | (~found & (not m["add_penalty_short_only_mode"]))
        n_pen = (pen & valid[None, :]).sum(-1).float()
        out.append(torch.clamp(per_beam ** n_pen,
                               min=f32(m["beam_likelihood"])))
    score = torch.cat(out)
    return score if n_valid else torch.ones_like(score)
