"""Beam LIDAR measurement model (src/lidar_measurement_model_beam.cpp:
124-192) with both raycasters of the reference: the kd-tree-style march
(raycasts/raycast_using_kdtree.h:58-109) over the distance field, and
the DDA march (raycasts/raycast_using_dda.h:106-159) over the occupancy
grid.

Beam classification: first collision -> TOTAL_REFLECTION if grazing,
else HIT within ``hit_range`` of the scan endpoint, else SHORT; no
collision -> LONG.  Score = beam_likelihood_min^(penalized/num) floored
at beam_likelihood_min (:146-152).

Tier 0 (``beam_measure_grouped``) runs kernel K2 over the pose-grouped
layout shared with the likelihood model and rescores envelope outliers
with the exact fixed march (``march_fixed``: kernel M1,
``csrc/beam_march.cu``, on the card; ``raycast_fixed`` is its plain
version); tier 2 (``beam_measure``) is the sphere
trace or, with ``use_dda``, the half-cell march over the occupancy grid:
kernels M2 (``march_sphere``) and M3 (``march_dda``, ``csrc/tier2.cu``)
on the card, each ray marched to its own exit with no host read; their
plain versions ``raycast_df`` and ``raycast_occ`` check the loop's exit
on the host every probe.
"""

from __future__ import annotations

import torch

from mcl_3dl_tpu_torch.map.distance_field import DistanceField
from mcl_3dl_tpu_torch.map.occupancy import OccupancyGrid
from mcl_3dl_tpu_torch.math import device_constant, f32
from mcl_3dl_tpu_torch.math import quat as mq
from mcl_3dl_tpu_torch.ops import build
from mcl_3dl_tpu_torch.ops import grouped as og


class BeamStatus:
    HIT = 0
    SHORT = 1
    LONG = 2
    TOTAL_REFLECTION = 3


def _cdiv(x, c):
    """``x / c`` with ``c`` as a device scalar: a true f32 division (a
    Python-scalar divisor becomes a reciprocal multiply on CUDA)."""
    return x / torch.full((), f32(c), device=x.device)


def _ray(begin, end):
    seg = end - begin
    length = torch.linalg.vector_norm(seg, dim=-1)
    return length, seg / torch.clamp(length, min=1e-12)[..., None]


def _sphere_setup(df: DistanceField, begin, end, map_grid_min,
                  hit_tolerance):
    """The sphere trace's set-up: ``(direction, max_t, wu)``, the unit
    ray, its range ``floor((|ray| + tol) / grid) * grid`` and ``|W u|``."""
    length, direction = _ray(begin, end)
    max_t = torch.floor(_cdiv(length + f32(hit_tolerance), map_grid_min)) \
        * f32(map_grid_min)
    w_vec = device_constant(df.weights, torch.float32, begin.device)
    return direction, max_t, torch.linalg.vector_norm(direction * w_vec,
                                                      dim=-1)


def _sphere_loop(df: DistanceField, begin, direction, max_t, wu,
                 map_grid_min, map_grid_max, num_steps, early_exit):
    """The sphere trace's loop over every ray at once: ``(carry, probes)``,
    ``carry = (found, cpos, d0_hit, t_entry, d_entry)``; with
    ``early_exit`` it stops once no ray is live (not hit, ``t < max_t``),
    read on the host each iteration, and ``probes`` counts the live rays'
    probes (else ``None``)."""
    radius = f32(2.0 ** 0.5 * map_grid_max / 2.0)
    shape = begin.shape[:-1]
    dev = begin.device
    d_entry_thr = f32(float(df.trunc) * 0.99)
    found = torch.zeros(shape, dtype=torch.bool, device=dev)
    t = torch.full(shape, f32(map_grid_min), device=dev)
    cpos = torch.zeros(shape + (3,), device=dev)
    d0_hit = torch.zeros(shape, device=dev)
    t_entry = torch.full(shape, -1.0, device=dev)
    d_entry = torch.full(shape, f32(df.trunc), device=dev)
    probes = 0 if early_exit else None
    for _ in range(num_steps):
        if early_exit:
            live = int(torch.count_nonzero(~found & (t < max_t)))
            if live == 0:
                break
            probes += live
        pos = begin + direction * t[..., None]
        d = df.sample_nearest(pos)
        active = (t < max_t) & ~found
        enter = active & (d < d_entry_thr) & (t_entry < 0.0)
        t_entry = torch.where(enter, t, t_entry)
        d_entry = torch.where(enter, d, d_entry)
        hit_now = (d <= radius) & active
        cpos = torch.where(hit_now[..., None], pos, cpos)
        d0_hit = torch.where(hit_now, d, d0_hit)
        advance = torch.clamp((d - radius) / torch.clamp(wu, min=1e-6),
                              min=f32(map_grid_min))
        t = torch.where(active & ~hit_now, t + advance, t)
        found = found | hit_now
    return (found, cpos, d0_hit, t_entry, d_entry), probes


def _sphere_result(begin, direction, map_grid_min, found, cpos, d0_hit,
                   t_entry, d_entry):
    """The incidence epilogue: ``(found, cpos, sin_angle)``, the field drop
    over the entry -> hit span."""
    span = torch.clamp(torch.linalg.vector_norm(
        cpos - (begin + direction * t_entry[..., None]), dim=-1), min=1e-6)
    sin_ang = torch.where(
        found & (t_entry >= 0.0) & (span > f32(map_grid_min)),
        torch.clamp((d_entry - d0_hit) / span, 0.0, 1.0), 1.0)
    return found, cpos, torch.where(found, sin_ang, 0.0)


def raycast_df(df: DistanceField, begin, end, map_grid_min: float,
               map_grid_max: float, hit_tolerance: float, num_steps: int,
               early_exit: bool = True):
    """Sphere-traced kd-tree-style raycast against the distance field:
    ``(collision, collision_pos [..., 3], sin_angle)``; the plain version
    of kernel M2 (``march_sphere``).

    The field value bounds the weighted distance to the nearest map
    point, so stepping ``(d - radius) / ||W u||`` (at least ``grid_min``)
    can never skip a collision; a probe with ``d <= radius`` is a
    collision as in the reference's fixed march.  The loop stops when
    every ray has hit or passed ``floor((|ray| + tol) / grid) * grid``,
    checked on the host each iteration, or after ``num_steps``; with
    ``early_exit=False`` it always runs ``num_steps`` (no host read, the
    same result: a finished ray's iterations change nothing).  The
    incidence estimate is the field drop over the entry -> hit span.
    """
    direction, max_t, wu = _sphere_setup(df, begin, end, map_grid_min,
                                         hit_tolerance)
    carry, _ = _sphere_loop(df, begin, direction, max_t, wu, map_grid_min,
                            map_grid_max, num_steps, early_exit)
    return _sphere_result(begin, direction, map_grid_min, *carry)


def march_sphere(df: DistanceField, begin, end, map_grid_min: float,
                 map_grid_max: float, hit_tolerance: float, num_steps: int,
                 early_exit: bool = True):
    """Kernel M2 (``csrc/tier2.cu``): ``raycast_df``'s ``(found,
    collision_pos [..., 3], sin_angle)`` for CUDA tensors, bit for bit,
    with or without ``early_exit`` (each thread marches its ray to its own
    exit); ``raycast_df`` itself, its plain version, for CPU tensors.  The
    set-up (``_sphere_setup``) and the incidence epilogue stay torch; the
    kernel returns the loop's carry.  It replaces no Pallas kernel: on the
    TPU the march is XLA's ``lax.while_loop``
    (mcl_3dl_tpu/models/beam.py:132)."""
    if not begin.is_cuda:
        return raycast_df(df, begin, end, map_grid_min, map_grid_max,
                          hit_tolerance, num_steps, early_exit)
    shape = begin.shape[:-1]
    direction, max_t, wu = _sphere_setup(df, begin, end, map_grid_min,
                                         hit_tolerance)
    trunc = float(df.trunc)
    wx, wy, wz = (f32(w) for w in df.weights)
    carry = build.op("march_sphere")(
        begin.reshape(-1, 3).contiguous(),
        direction.reshape(-1, 3).contiguous(), max_t.reshape(-1).contiguous(),
        wu.reshape(-1).contiguous(), df.field, df.origin, num_steps, wx, wy,
        wz, f32(df.cell), f32(trunc / 255.0), f32(trunc), f32(map_grid_min),
        f32(2.0 ** 0.5 * map_grid_max / 2.0), f32(trunc * 0.99))
    march_sphere.launches += 1
    found, cpos, d0_hit, t_entry, d_entry = carry
    return _sphere_result(
        begin, direction, map_grid_min, found.reshape(shape),
        cpos.reshape(shape + (3,)), d0_hit.reshape(shape),
        t_entry.reshape(shape), d_entry.reshape(shape))


march_sphere.launches = 0
march_sphere.plain = raycast_df


def _sum3(x):
    """``x[..., 0] + x[..., 1] + x[..., 2]``: a sum over a last axis of 3 in
    a stated order (kernel M3 adds the same way)."""
    return x[..., 0] + x[..., 1] + x[..., 2]


def _dda_setup(occ: OccupancyGrid, begin, end, hit_tolerance):
    """The DDA march's set-up: ``(direction, max_t, begin_inside,
    begin_voxel)``."""
    length, direction = _ray(begin, end)
    dims = device_constant(occ.shape, torch.float32, begin.device)
    dims_hi = occ.origin + dims * f32(occ.cell)
    begin_inside = torch.all((begin >= occ.origin) & (begin <= dims_hi),
                             dim=-1)
    return (direction, length + f32(hit_tolerance), begin_inside,
            occ.voxel(begin))


def _dda_loop(occ: OccupancyGrid, begin, direction, max_t, begin_inside,
              begin_voxel, filter_label_max, num_steps, ray_angle_half,
              min_dist_thr_sq, early_exit):
    """The DDA march's loop over every ray at once: ``((found, cpos),
    probes)``; with ``early_exit`` it stops once no ray is live (not hit,
    inside the map, ``t < max_t``), read on the host each probe, and
    ``probes`` counts the live rays' probes (else ``None``)."""
    step = f32(occ.cell * 0.5)
    refine = ray_angle_half > 0.0 or min_dist_thr_sq > 0.0
    shape = begin.shape[:-1]
    found = torch.zeros(shape, dtype=torch.bool, device=begin.device)
    cpos = torch.zeros(shape + (3,), device=begin.device)
    probes = 0 if early_exit else None
    for s in range(num_steps):
        t = f32((s + 1) * step)      # one f32 product, as in JAX
        if early_exit:
            live = int(torch.count_nonzero(~found & (t < max_t)
                                           & begin_inside))
            if live == 0:
                break
            probes += live
        pos = begin + direction * t
        occ_hit, label, rep_pos = occ.lookup(pos)        # rep_pos [..., R, 3]
        same_as_begin = torch.all(occ.voxel(pos) == begin_voxel, dim=-1)
        if refine:
            rel = rep_pos - begin[..., None, :]
            foot = torch.abs(_sum3(rel * direction[..., None, :]))
            thr_sq = torch.clamp((f32(ray_angle_half) * foot) ** 2,
                                 min=f32(min_dist_thr_sq))
            pass_r = _sum3(rel * rel) - foot * foot < thr_sq
            near_ray = torch.any(pass_r, dim=-1)
            # the first passing representative (argmax returns the first
            # maximum; no bool argmax on CUDA)
            first = torch.argmax(pass_r.to(torch.uint8), dim=-1)
            point_pos = torch.gather(
                rep_pos, -2, first[..., None, None].expand(
                    first.shape + (1, 3)))[..., 0, :]
        else:
            near_ray = True
            point_pos = rep_pos[..., 0, :]
        blocked = (occ_hit & near_ray & (label <= int(filter_label_max))
                   & ~same_as_begin & (t < max_t) & begin_inside & ~found)
        cpos = torch.where(blocked[..., None], point_pos, cpos)
        found = found | blocked
    return (found, cpos), probes


def raycast_occ(occ: OccupancyGrid, begin, end, hit_tolerance: float,
                filter_label_max: int, num_steps: int,
                ray_angle_half: float = 0.0, min_dist_thr_sq: float = 0.0,
                early_exit: bool = True):
    """DDA-style raycast against the occupancy grid: ``(collision,
    collision_pos [..., 3], sin_angle)``, ``sin_angle`` 1 on a hit (the
    reference hardcodes it, raycast_using_dda.h:151-152); the plain
    version of kernel M3 (``march_dda``).

    Probes every half cell from ``t = step`` (a superset of the exact
    voxel walk, raycast_using_dda.h:106-159) until ``|ray| +
    hit_tolerance``.  A ray starting outside the map's box never collides
    (:70-75), and the voxel holding the ray's origin is skipped.  An
    occupied voxel whose minimum label is at most ``filter_label_max``
    blocks when one of its representative points lies within
    ``max((ray_angle_half * foot)^2, min_dist_thr_sq)`` of the ray
    (squared perpendicular distance, ``foot`` the distance from the ray's
    begin to the point's foot; :237-258); the first passing representative
    is the collision point.  With both thresholds 0 every occupied voxel
    blocks at its first representative.  The loop stops once every ray
    has hit or passed its range, checked on the host each probe, or
    after ``num_steps`` (always, with ``early_exit=False``).
    """
    direction, max_t, begin_inside, begin_voxel = _dda_setup(
        occ, begin, end, hit_tolerance)
    (found, cpos), _ = _dda_loop(
        occ, begin, direction, max_t, begin_inside, begin_voxel,
        filter_label_max, num_steps, ray_angle_half, min_dist_thr_sq,
        early_exit)
    return found, cpos, torch.where(found, 1.0, 0.0)


def march_dda(occ: OccupancyGrid, begin, end, hit_tolerance: float,
              filter_label_max: int, num_steps: int,
              ray_angle_half: float = 0.0, min_dist_thr_sq: float = 0.0,
              early_exit: bool = True):
    """Kernel M3 (``csrc/tier2.cu``): ``raycast_occ``'s ``(found,
    collision_pos [..., 3], sin_angle)`` for CUDA tensors, bit for bit,
    with or without ``early_exit``; ``raycast_occ`` itself, its plain
    version, for CPU tensors.  The set-up (``_dda_setup``) stays torch.
    It replaces no Pallas kernel: on the TPU the march is XLA's
    ``lax.while_loop`` (mcl_3dl_tpu/models/beam.py:259)."""
    if not begin.is_cuda:
        return raycast_occ(occ, begin, end, hit_tolerance, filter_label_max,
                           num_steps, ray_angle_half, min_dist_thr_sq,
                           early_exit)
    shape = begin.shape[:-1]
    direction, max_t, begin_inside, begin_voxel = _dda_setup(
        occ, begin, end, hit_tolerance)
    found, cpos = build.op("march_dda")(
        begin.reshape(-1, 3).contiguous(),
        direction.reshape(-1, 3).contiguous(), max_t.reshape(-1).contiguous(),
        begin_inside.reshape(-1).contiguous(),
        begin_voxel.reshape(-1, 3).contiguous(), occ.occupied, occ.min_label,
        occ.rep_point, occ.origin, num_steps, f32(occ.cell * 0.5),
        f32(occ.cell), int(filter_label_max), f32(ray_angle_half),
        f32(min_dist_thr_sq), ray_angle_half > 0.0 or min_dist_thr_sq > 0.0)
    march_dda.launches += 1
    found = found.reshape(shape)
    return found, cpos.reshape(shape + (3,)), torch.where(found, 1.0, 0.0)


march_dda.launches = 0
march_dda.plain = raycast_occ


def raycast_fixed(df: DistanceField, begin, end, map_grid_min: float,
                  map_grid_max: float, hit_tolerance: float, num_steps: int):
    """The reference's fixed-step march (raycast_using_kdtree.h:58-109):
    probes at t = i*grid for 1 <= i < floor((|ray|+tol)/grid), collision
    at field <= sqrt(2)*grid_max/2, incidence over the entry -> hit span.
    The semantics K2 reproduces over the sorted layout."""
    radius = f32(2.0 ** 0.5 * map_grid_max / 2.0)
    d_entry_thr = f32(float(df.trunc) * 0.99)
    length, direction = _ray(begin, end)
    l_b = torch.floor(_cdiv(length + f32(hit_tolerance), map_grid_min))
    shape = begin.shape[:-1]
    dev = begin.device
    grid = f32(map_grid_min)
    found = torch.zeros(shape, dtype=torch.bool, device=dev)
    t_hit = torch.zeros(shape, device=dev)
    d_hit = torch.zeros(shape, device=dev)
    t_entry = torch.full(shape, -1.0, device=dev)
    d_entry = torch.full(shape, f32(df.trunc), device=dev)
    for s in range(num_steps + 1):
        i = float(s - 1)
        ti = f32(i * grid)      # one f32 product, as i * grid_min in f32
        d = df.sample_nearest(begin + direction * ti)
        elig = (i >= 1.0) & (i < l_b) & ~found
        enter = elig & (d < d_entry_thr) & (t_entry < 0.0)
        t_entry = torch.where(enter, ti, t_entry)
        d_entry = torch.where(enter, d, d_entry)
        hit_now = elig & (d <= radius)
        t_hit = torch.where(hit_now, ti, t_hit)
        d_hit = torch.where(hit_now, d, d_hit)
        found = found | hit_now

    span = t_hit - t_entry
    sin_ang = torch.where(
        found & (t_entry >= 0.0) & (span > grid),
        torch.clamp((d_entry - d_hit) / torch.clamp(span, min=f32(1e-6)),
                    0.0, 1.0), 1.0)
    sin_ang = torch.where(found, sin_ang, 0.0)
    cpos = begin + direction * t_hit[..., None]
    cpos = torch.where(found[..., None], cpos, 0.0)
    return found, cpos, sin_ang


def march_fixed(df: DistanceField, begin, end, map_grid_min: float,
                map_grid_max: float, hit_tolerance: float, num_steps: int):
    """Kernel M1 (``csrc/beam_march.cu``): ``raycast_fixed``'s ``(found,
    collision_pos [..., 3], sin_angle)`` for CUDA tensors, bit for bit;
    ``raycast_fixed`` itself, its plain version, for CPU tensors.  The
    ray set-up (``_ray`` and the probe limit ``l_b``) stays torch, so its
    rounding is the plain version's; the kernel marches each ray to its
    first hit or its limit.  It replaces no Pallas kernel: on the TPU the
    march is XLA's ``lax.fori_loop`` (mcl_3dl_tpu/models/beam.py:269-331)."""
    if not begin.is_cuda:
        return raycast_fixed(df, begin, end, map_grid_min, map_grid_max,
                             hit_tolerance, num_steps)
    shape = begin.shape[:-1]
    length, direction = _ray(begin, end)
    l_b = torch.floor(_cdiv(length + f32(hit_tolerance), map_grid_min))
    trunc = float(df.trunc)
    wx, wy, wz = (f32(w) for w in df.weights)
    found, cpos, sin_ang = build.op("march_fixed")(
        begin.reshape(-1, 3).contiguous(),
        direction.reshape(-1, 3).contiguous(), l_b.reshape(-1).contiguous(),
        df.field, df.origin, num_steps, wx, wy, wz, f32(df.cell),
        f32(trunc / 255.0), f32(trunc), f32(map_grid_min),
        f32(2.0 ** 0.5 * map_grid_max / 2.0), f32(trunc * 0.99))
    march_fixed.launches += 1
    return (found.reshape(shape), cpos.reshape(shape + (3,)),
            sin_ang.reshape(shape))


march_fixed.launches = 0
march_fixed.plain = raycast_fixed


class BeamVirtualPoints:
    """Particle-independent probe schedule of the grouped fixed march:
    probe ``i`` of beam ``b`` is the virtual point ``org_b + dir_b *
    i*grid`` (rotation preserves ray length).  ``vpf``/``chainf`` are the
    [B*nprobe] virtual points / chain validity."""

    def __init__(self, points, origin_idx, valid, origins, map_grid_min,
                 hit_range, num_steps):
        self.nprobe = num_steps + 1                            # i = -1..S-1
        sensor_org = origins[origin_idx]                       # [B, 3]
        self.length, dirb = _ray(sensor_org, points)
        i_vals = torch.arange(self.nprobe, dtype=torch.float32,
                              device=points.device) - 1.0
        vp = (sensor_org[:, None, :]
              + dirb[:, None, :] * (i_vals[None, :, None] * f32(map_grid_min)))
        l_b = torch.floor(_cdiv(self.length + f32(hit_range), map_grid_min))
        chain = (i_vals[None, :] < l_b[:, None]) & valid[:, None]
        self.bb = points.shape[0]
        self.vpf = vp.reshape(self.bb * self.nprobe, 3)
        self.chainf = chain.reshape(self.bb * self.nprobe)


def _penalized(found, sin_ang, dist_sq, valid, *, hit_range, sin_total_ref,
               long_pen):
    graze = found & (sin_ang <= f32(sin_total_ref))
    short = found & ~graze & (dist_sq >= f32(hit_range * hit_range))
    long_p = ~found & bool(long_pen)
    return (short | long_p) & valid


def _overflow_beam_pen(df_beam, pos, rot, over_idx, points, origin_idx,
                       valid, origins, *, map_grid_min, map_grid_max,
                       hit_range, sin_total_ref, long_pen, num_steps):
    """Exact penalized-beam counts [cap] of the envelope outliers: the
    fixed march on the [cap, B] subset (sentinel rows read particle
    N-1; they are dropped on scatter)."""
    idx = torch.clamp(over_idx, max=pos.shape[0] - 1)
    posc = pos[idx]
    rmatc = mq.rotation_matrix(mq.normalize(rot[idx]))
    sensor_org = origins[origin_idx]                           # [B, 3]
    begins = torch.einsum("bj,cij->cbi", sensor_org, rmatc) + posc[:, None, :]
    ends = torch.einsum("bj,cij->cbi", points, rmatc) + posc[:, None, :]
    found, cpos, sin_ang = march_fixed(
        df_beam, begins, ends, map_grid_min, map_grid_max, hit_range,
        num_steps)
    dist_sq = torch.sum((ends - cpos) ** 2, dim=-1)
    pen = _penalized(found, sin_ang, dist_sq, valid[None, :],
                     hit_range=hit_range, sin_total_ref=sin_total_ref,
                     long_pen=long_pen)
    return torch.sum(pen, dim=-1).to(torch.float32)


def _score(n_pen, valid, beam_likelihood_min, num_points_default):
    per_beam = beam_likelihood_min ** (1.0 / float(num_points_default))
    score = torch.clamp(per_beam ** n_pen, min=f32(beam_likelihood_min))
    return torch.where(torch.sum(valid) > 0, score, 1.0)


def grouped_beam_inputs(df_beam: DistanceField, stats, lo, vp, valid,
                        map_grid_max):
    """K2's inputs besides the layout: ``(meta, pts_fp, aux, skip,
    tables [B, nprobe, G, R, ZW])``."""
    trunc = float(df_beam.trunc)
    radius = 2.0 ** 0.5 * map_grid_max / 2.0
    tables, z_used = og.extract_tables(
        df_beam.field2d, df_beam.shape[1], df_beam.field2d.shape[1], lo,
        vp.chainf)
    aux = torch.stack([torch.round(vp.length * 65536.0).to(torch.int32),
                       valid.to(torch.int32)], dim=-1).contiguous()
    # a block whose minimum reachable distance is at or above the entry
    # threshold and above the collision radius can neither enter nor hit;
    # a probe whose blocks all qualify is empty space and skipped whole
    min_d = og.block_min_dist(tables, trunc, lo, z_used,
                              og.query_bands(stats, vp.vpf))
    skip = og.pack_block_skip((min_d >= f32(trunc * 0.99)) & (min_d > f32(radius)))
    tables = tables.reshape(vp.bb, vp.nprobe, og.G_GROUPS, og.R_ROWS, og.ZW)
    return og.make_meta(lo, z_used), og.points_fp(vp.vpf), aux, skip, tables


def beam_measure_grouped(df_beam: DistanceField, pos, rot, points,
                         origin_idx, valid, origins, *, map_grid_min,
                         map_grid_max, hit_range, beam_likelihood_min,
                         num_points_default, sin_total_ref,
                         add_penalty_short_only_mode, num_steps, grouped):
    """Tier 0: the beam likelihood [N] through kernel K2 over the sorted
    layout ``grouped = (stats, layout, lo, fits, vp)`` (``fits`` True),
    with the envelope outliers rescored exactly."""
    stats, layout, lo, _, vp = grouped
    long_pen = not add_penalty_short_only_mode
    meta, pfp, aux, skip, tables = grouped_beam_inputs(
        df_beam, stats, lo, vp, valid, map_grid_max)
    npen_sorted = og.grouped_beam_pen(
        layout.A, layout.tile_group, meta, pfp, aux, skip, tables,
        nprobe=vp.nprobe, trunc=float(df_beam.trunc), grid_min=map_grid_min,
        radius=2.0 ** 0.5 * map_grid_max / 2.0, hit_range=hit_range,
        sin_total_ref=sin_total_ref, long_pen=long_pen, tol=hit_range)
    n_pen = npen_sorted[layout.dest]
    n_pen_of = _overflow_beam_pen(
        df_beam, pos, rot, layout.over_idx, points, origin_idx, valid,
        origins, map_grid_min=map_grid_min, map_grid_max=map_grid_max,
        hit_range=hit_range, sin_total_ref=sin_total_ref, long_pen=long_pen,
        num_steps=num_steps)
    n_pen = og.scatter_overflow(n_pen, layout.over_idx, n_pen_of)
    return _score(n_pen, valid, beam_likelihood_min, num_points_default)


def beam_measure(df_beam: DistanceField, pos, rot, points, origin_idx,
                 valid, origins, *, map_grid_min, map_grid_max, hit_range,
                 beam_likelihood_min, num_points_default, sin_total_ref,
                 add_penalty_short_only_mode, num_steps, use_dda=False,
                 occ: OccupancyGrid = None, filter_label_max=0xFFFFFFFF,
                 ray_angle_half=0.0, min_dist_thr_sq=0.0, early_exit=True):
    """Tier 2: ``(likelihood [N], status [N, B])`` on every (particle,
    beam) through the sphere trace ``march_sphere``, or with ``use_dda``
    through ``march_dda`` over ``occ`` (which reads the label and
    perpendicular-distance parameters).  On the card both are kernels
    that read nothing on the host; on the CPU ``early_exit=False`` marches
    a fixed trip count with no host read (the batched fleet), the same
    result."""
    rmat = mq.rotation_matrix(mq.normalize(rot))
    ends = torch.einsum("bj,nij->nbi", points, rmat) + pos[:, None, :]
    sensor_org = origins[origin_idx]
    begins = torch.einsum("bj,nij->nbi", sensor_org, rmat) + pos[:, None, :]
    if use_dda:
        collision, cpos, sin_ang = march_dda(
            occ, begins, ends, hit_range, filter_label_max, num_steps,
            ray_angle_half=ray_angle_half, min_dist_thr_sq=min_dist_thr_sq,
            early_exit=early_exit)
    else:
        collision, cpos, sin_ang = march_sphere(
            df_beam, begins, ends, map_grid_min, map_grid_max, hit_range,
            num_steps, early_exit)
    dist_sq = torch.sum((ends - cpos) ** 2, dim=-1)
    graze = sin_ang <= f32(sin_total_ref)
    status = torch.where(
        collision,
        torch.where(graze, BeamStatus.TOTAL_REFLECTION,
                    torch.where(dist_sq < f32(hit_range ** 2), BeamStatus.HIT,
                                BeamStatus.SHORT)),
        BeamStatus.LONG)
    penalized = (status == BeamStatus.SHORT) | (
        (not add_penalty_short_only_mode) & (status == BeamStatus.LONG))
    n_pen = torch.sum(penalized & valid[None, :], dim=-1).to(torch.float32)
    return _score(n_pen, valid, beam_likelihood_min, num_points_default), status
