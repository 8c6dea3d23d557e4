"""The plain global-mode step: the measurement update the node runs while
more than ``num_particles`` particles are active, as after
/global_localization (src/mcl_3dl.cpp:363-893 under
setGlobalLocalizationStatus, lidar_measurement_model_likelihood.cpp:
63-77, the decay at src/mcl_3dl.cpp:875-888, pf.h:399-436).

Plain PyTorch and NumPy, as ``reference/`` is, whose field, cloud, draws,
models and filter helpers it reuses: it imports no ``jax``, no
``mcl_3dl_tpu`` and nothing of ``mcl_3dl_tpu_torch``.

The seeding (src/mcl_3dl.cpp:1039-1099) is built again from the map
(``build``): the map voxelized at the model's ``map_leaf`` and again at
``global_localization_grid_lin``, the points kept that have no map point
within that radius of the point raised by 0.01 m plus the radius, under
the field's ``weights``; one seed a (kept point, yaw bin), the bins
``2 pi / global_localization_grid_ang`` of them, each with the weight
``1 / points``.  The step whose state holds as many particles as that
seeding runs from the seeding so built, not from the program's; a
global-mode step at a count the seeding's decay never reaches answers an
infinite position, which no limit admits.  The other global-mode steps
run from the program's state before them, the output of a step compared
before.  From that state and the program's random generator state:

* the draws made again: the likelihood's sample at the step's slot
  bucket, one beam slot, the comb offset, then the jitter and noise
  normals of every capacity slot;
* the point ramp: ``num_points * num_particles // n`` likelihood points,
  at least ``num_points_global``, at most the slots; the other slots
  count as invalid;
* nearest sampling of the field (``reference/models.py``), the beam
  model dropped (its global budget, ``num_points_global``, is 0);
* the tail in float64 with the bias weights 1 and the jump forced, so
  the output filters are set to the step's map-to-odometry transform
  before their step;
* the noise column after the step: the noise normals times their
  scales, then the decay's resize to max(0.75 n, ``num_particles``).

Departures from the node, each as the program states it:

* the sample is drawn at a power-of-two slot bucket (the smallest
  doubling of ``num_points_global`` that holds the ramp, at most
  ``num_points``) and the ramp's count is kept by masking; the node
  draws the ramp's count itself;
* the particles live in power-of-two capacity buckets: the decay's
  resize fills the whole capacity from the comb, and the state is cut
  back to the bucket of the decayed count (at least that of
  ``num_particles``), so the noise column compared is cut the same way;
* the resize's comb: tooth ``k`` takes the number of particles whose
  cumulative weight has ``floor((c_j - p0) / pstep) + 1 <= k`` (the
  count of teeth at or below each cumulative weight), the program's
  closed form; the node walks the CDF.  After resampling the weights are
  equal (``1 / n``, all that the resize reads of the resampled state:
  the noise is redrawn after it), and at a 0.75x decay every fourth
  tooth falls on a cumulative weight to within one rounding, so only
  this arithmetic, with the scan in rows of 1,024 (``cloud.scan``),
  gives the exact rows that ``noise_gap`` holds;
* the standable search tests every map point's weighted distance in
  float64; the node asks a k-d tree (FLANN) in float32, the program a
  k-d tree in float64, whose kept points the reference's equal on the
  benchmark's world;
* the IMU attitude the seeds are composed with is the seed in slot 0
  (the first point's yaw bin 0, so the attitude itself, normalized): a
  record holds no IMU reading, so a rotation common to every seed reads
  as another attitude and is not caught; every other part of the seeding
  is;
* outside global mode (``n_active <= num_particles``) the step is
  ``check.reference_step``'s.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark import check
from benchmark.reference import cloud as rc
from benchmark.reference import field as rf
from benchmark.reference import filter as rfl
from benchmark.reference import models as rm

DECAY = 0.75         # the particle count's decay a global-mode step


class World(NamedTuple):
    field: rf.Field      # the likelihood's field, ``reference/field.py``'s
    cells: np.ndarray    # [P, 3] f32: the standable points the seeds stand on


def build(map_points, model, device):
    return World(rf.build(map_points, check.field_config(model), device),
                 standable(map_points, model, device))


def standable(map_points, model, device) -> np.ndarray:
    """The map's points a robot could stand on, at the global grid: those
    with no point within ``grid`` (weighted) of the point raised by
    ``0.01 + grid`` (src/mcl_3dl.cpp:1050-1074)."""
    grid = float(model["global_localization_grid_lin"])
    pts = rf.voxel_downsample(rf.voxel_downsample(map_points,
                                                  model["map_leaf"]), grid)
    d = torch.float64
    w = torch.tensor(model["weights"], dtype=d, device=device)
    p = torch.as_tensor(pts, device=device).to(d)
    probe = (p + torch.tensor([0.0, 0.0, 0.01 + grid], dtype=d,
                              device=device)) * w
    p = p * w
    keep = torch.empty(len(pts), dtype=torch.bool, device=device)
    for i in range(0, len(pts), 512):
        dx, dy, dz = (probe[i:i + 512, None, :] - p[None]).unbind(-1)
        keep[i:i + 512] = ~(dx * dx + dy * dy + dz * dz < grid * grid).any(1)
    return pts[keep.cpu().numpy()]


def div_yaw(model: dict) -> int:
    return int(round(2.0 * np.pi / model["global_localization_grid_ang"]))


def episode(model: dict, seeds: int) -> list:
    """The particle counts of the global-mode steps after a seeding."""
    counts = [seeds]
    while counts[-1] > model["num_particles"]:
        counts.append(decayed(model, counts[-1]))
    return counts[:-1]


def seeded(model: dict, cells: np.ndarray, attitude, device) -> dict:
    """The state the service leaves: seed ``k`` on cell ``k // bins`` at
    yaw bin ``k % bins`` composed with ``attitude`` [4], weight
    ``1 / cells``, in the capacity bucket of the seed count."""
    div = div_yaw(model)
    n = len(cells) * div
    cap = rc.bucket(n, rc.bucket(model["num_particles"], 64))
    idx = np.arange(cap)
    yaw = (2.0 * np.pi * (idx % div) / div).astype(np.float32)
    rpy = torch.zeros((cap, 3), dtype=torch.float32, device=device)
    rpy[:, 2] = torch.as_tensor(yaw, device=device)
    rot = rfl.mul(rfl.from_rpy(rpy), attitude.to(device, torch.float32))
    prob = np.where(idx < n, np.float32(1.0 / len(cells)), np.float32(0.0))
    return dict(
        pos=torch.as_tensor(cells[np.minimum(idx // div, len(cells) - 1)],
                            device=device),
        rot=rot / torch.linalg.vector_norm(rot, dim=-1, keepdim=True),
        prob=torch.as_tensor(prob, device=device),
        odom_err_lin=torch.zeros((cap, 3), device=device),
        n_active=torch.tensor(n, dtype=torch.int32, device=device))


def unreachable(rec) -> tuple:
    """The answer to a step that no seeding of this map leads to."""
    inf = np.full(3, np.inf)
    rot = np.array([0.0, 0.0, 0.0, 1.0])
    return (dict(raw_pos=inf, pos=inf, raw_rot=rot, rot=rot, cov=np.eye(6),
                 entropy=np.inf),
            torch.full(rec["post_noise"].shape, float("inf")))


def ramp(model: dict, n: int):
    """``(slots, points)``: the likelihood's slot bucket and the ramp's
    point count at ``n`` active particles."""
    lp = model["likelihood"]
    want = max(lp["num_points"] * model["num_particles"] // max(n, 1),
               lp["num_points_global"])
    slots = max(lp["num_points_global"], 1)
    while slots < min(want, lp["num_points"]):
        slots *= 2
    slots = min(slots, lp["num_points"])
    return slots, min(want, slots)


def decayed(model: dict, n: int) -> int:
    """The particle count after a global-mode step at ``n``."""
    return max(int(np.float32(n) * np.float32(DECAY)),
               model["num_particles"])


def resize_rows(n: int, new_n: int, cap: int, device) -> torch.Tensor:
    """The rows [cap] the decay's resize takes, over the equal weights
    ``1 / n`` the resampling left on the first ``n`` of ``cap`` slots."""
    mask = torch.arange(cap, device=device) < n
    prob = mask / torch.tensor(float(n), device=device)
    total = torch.sum(prob * mask)
    pstep = total / torch.tensor(float(new_n), device=device)
    accum = rc.scan(prob * mask)
    teeth = torch.floor((accum - pstep) / pstep).to(torch.int32) + 1
    teeth = torch.clamp(teeth, min=0, max=cap).to(torch.int64)
    first = torch.cumsum(torch.bincount(teeth, minlength=cap + 1)[:cap], 0)
    return torch.clamp(first, max=n - 1)


def tail(state, lik, m, odom_pos, odom_rot, f_pos, f_ang):
    """``reference/filter.py``'s tail in global mode: the bias weights 1
    and the jump forced."""
    d = torch.float64
    pos, rot = state["pos"].to(d), state["rot"].to(d)
    mask = (torch.arange(pos.shape[0], device=pos.device)
            < int(state["n_active"])).to(d)
    odom_err = rfl.normal(torch.linalg.vector_norm(
        state["odom_err_lin"].to(d), dim=-1), m["odom_err_integ_lin_sigma"])
    prob = state["prob"].to(d) * lik.to(d) * odom_err * mask
    total = prob.sum()
    if total > 0:
        prob = prob / total
        entropy = -torch.where(prob > 0, prob * torch.log(prob),
                               torch.zeros_like(prob)).sum()
    else:
        prob, entropy = state["prob"].to(d), prob.new_zeros(())
    e_pos, e_rot = rfl.weighted_mean(pos, rot, prob * mask)
    e_rot = e_rot / torch.linalg.vector_norm(e_rot)
    cov = rfl.covariance(pos, rot, prob * mask)
    odom_pos, odom_rot = odom_pos.to(d), odom_rot.to(d)
    map_rot = rfl.mul(e_rot, rfl.inv(odom_rot))
    map_pos = e_pos - rfl.rotate(map_rot, odom_pos)
    filters = []
    for (k, _, _, is_angle), value in ((f_ang, rfl.to_rpy(map_rot)),
                                       (f_pos, map_pos)):
        k = k.to(d)
        x, out = rfl.lpf_set(k, value)
        filters.append(rfl.lpf_step(k, x, out, is_angle, value)[1])
    rpy_s, map_pos_s = filters
    map_rot_s = rfl.from_rpy(rpy_s)
    return dict(raw_pos=e_pos, raw_rot=e_rot, pos=map_pos_s + rfl.rotate(
        map_rot_s, odom_pos), rot=rfl.mul(map_rot_s, odom_rot), cov=cov,
        entropy=entropy)


def step(world, model, rec, device, dtype=torch.float32):
    """``(answer, post noise)`` for one record, as
    ``check.reference_step`` gives them."""
    n = int(rec["state"]["n_active"])
    if n <= model["num_particles"]:
        return check.reference_step(world.field, model, rec, device, dtype)
    counts = episode(model, len(world.cells) * div_yaw(model))
    if n not in counts:
        return unreachable(rec)
    if n == counts[0]:
        state = seeded(model, world.cells, rec["state"]["rot"][0], device)
    else:
        state = {k: v.to(device) for k, v in rec["state"].items()}
    lp, bp, fp = model["likelihood"], model["beam"], model["filter"]
    clouds = rec["cloud"]
    odom_pos, odom_rot = (np.asarray(v, np.float32) for v in clouds[-1][2])
    moved = [rc.to_base(pts, origin, odom_pos, odom_rot)
             for pts, origin, _ in clouds]
    base = np.concatenate([b for b, _ in moved])
    org = np.stack([o for _, o in moved])
    labels = np.concatenate([np.full(len(b), i) for i, (b, _) in
                             enumerate(moved)])
    cl = rc.prepare(base, org, model["scan_leaf"], device, labels)
    like_keep, beam_keep = rc.keeps(cl, lp, bp)
    cap = state["pos"].shape[0]
    slots, points = ramp(model, n)
    d = rc.draws(rec["gen_state"], device, like_keep, beam_keep, slots,
                 max(bp["num_points_global"], 1), cap)
    like_valid = (torch.arange(slots, device=device) < points) & bool(
        like_keep.any())
    score, _ = rm.likelihood(world.field, state["pos"], state["rot"],
                             cl.points[d.like_idx], like_valid, lp, dtype)
    answer = tail(state, score.double(), fp,
                  torch.as_tensor(odom_pos, device=device),
                  torch.as_tensor(odom_rot, device=device),
                  tuple(t.to(device) for t in rec["f_pos"]),
                  tuple(t.to(device) for t in rec["f_ang"]))
    scale = torch.tensor(fp["odom_noise_scale"], dtype=torch.float32,
                         device=device)
    new_n = decayed(model, n)
    noise = (d.noise_normals.float() * scale)[resize_rows(n, new_n, cap,
                                                         device)]
    keep = rc.bucket(new_n, rc.bucket(model["num_particles"], 64))
    return {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in answer.items()}, noise[:keep]
