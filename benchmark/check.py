"""How ``correct`` is decided: each sampled update's answer against the
plain reference's, worked out from the same inputs and the program's
state before that step.

Numbers compared, each the worst over the sampled updates:

* ``pose_gap_m``: the distance between the program's and the
  reference's raw (biased mean) and published positions;
* ``yaw_gap_rad``: the difference of their raw and published yaws,
  away from +-pi (``YAW_NEAR_PI``); roll and pitch, whose components
  carry the square root of a float32 rounding near a level pose (~3e-4
  rad, the control's size), are held by the covariance instead;
* ``cov_gap``: the largest entry of the covariances' difference over the
  reference covariance's largest entry;
* ``entropy_gap``: the difference of the weights' entropies (nats);
* ``noise_gap``: the largest difference of the odometry-noise column of
  the state the step returned from the reference's (its draws times the
  noise scale), which a step that returns its state unchanged fails.

The control is the reference put in the program's place with both
measurement models computed in bfloat16 (``dtype``), the configuration
stating float32; its draws and everything after the models are the
reference's own.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import cloud as rc
from benchmark.reference import field as rf
from benchmark.reference import filter as rfl
from benchmark.reference import models as rm

NUMBERS = ("pose_gap_m", "yaw_gap_rad", "cov_gap", "entropy_gap",
           "noise_gap")
# the mean orientation is built from the averaged front and up vectors
# (quat.h:59-75), whose w component is the square root of a sum that
# nears 0 as the yaw nears +-pi: within YAW_NEAR_PI of it the program's
# float32 yaw carries the square root of a rounding (up to ~1.5e-4 rad),
# so yaw_gap_rad leaves those answers out
YAW_NEAR_PI = 0.1


def field_config(model: dict) -> dict:
    return dict(map_leaf=model["map_leaf"], cell=model["cell"],
                weights=model["weights"],
                match_dist_min=model["match_dist_min"],
                unmatch_output_dist=model["unmatch_output_dist"],
                map_grid_min=model["map_grid_min"],
                map_grid_max=model["map_grid_max"])


def field_cells(map_points, model: dict) -> int:
    """Cells of the field's grid (the roofline counts read it)."""
    fc = field_config(model)
    pts = rf.voxel_downsample(map_points, fc["map_leaf"])
    dims = rf.grid(pts.astype(np.float64) * np.asarray(fc["weights"]),
                   fc["cell"], rf.truncation(fc))[1]
    return int(np.prod(dims))


def reference_step(field, model, rec, device, dtype=torch.float32):
    """The reference's answer for one record: ``(answer, post noise)``."""
    lp, bp, fp = model["likelihood"], model["beam"], model["filter"]
    pts, origin, odom = rec["cloud"]
    odom_pos, odom_rot = (np.asarray(v, np.float32) for v in odom)
    base, org = rc.to_base(pts, origin, odom_pos, odom_rot)
    if model["scan_leaf"] is None:
        cl = rc.raw(base, org, device)
    else:
        cl = rc.prepare(base, org, model["scan_leaf"], device)
    like_keep, beam_keep = rc.keeps(cl, lp, bp)
    state = {k: v.to(device) for k, v in rec["state"].items()}
    cap = state["pos"].shape[0]
    d = rc.draws(rec["gen_state"], device, like_keep, beam_keep,
                 lp["num_points"], bp["num_points"], cap)
    any_like, any_beam = bool(like_keep.any()), bool(beam_keep.any())
    like_valid = torch.full((lp["num_points"],), any_like, device=device)
    beam_valid = torch.full((bp["num_points"],), any_beam, device=device)
    score_l, _ = rm.likelihood(field, state["pos"], state["rot"],
                               cl.points[d.like_idx], like_valid, lp, dtype)
    score_b = rm.beam(field, state["pos"], state["rot"],
                      cl.points[d.beam_idx],
                      cl.origins[cl.labels[d.beam_idx]], beam_valid, bp,
                      sphere=rec["tier_beam"] == 2, dtype=dtype)
    answer = rfl.tail(state, score_l.double() * score_b.double(), fp,
                      torch.as_tensor(odom_pos, device=device),
                      torch.as_tensor(odom_rot, device=device),
                      rec["prev_pos"].to(device), rec["prev_rot"].to(device),
                      tuple(t.to(device) for t in rec["f_pos"]),
                      tuple(t.to(device) for t in rec["f_ang"]))
    # the draws stay float32 in the control too: it differs from the
    # reference in the measurement models alone
    scale = torch.tensor(fp["odom_noise_scale"], dtype=torch.float32,
                         device=device)
    noise = d.noise_normals.float() * scale
    return {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in answer.items()}, noise


def _yaw(q) -> float:
    x, y, z, w = np.asarray(q, np.float64)
    return float(np.arctan2(2 * (x * y + w * z), 1 - 2 * (y * y + z * z)))


def _yaw_gap(a, b) -> float:
    d = _yaw(a) - _yaw(b)
    return float(abs(d - 2 * np.pi * np.round(d / (2 * np.pi))))


def gaps(got: dict, want: dict, noise_got, noise_want) -> dict:
    cov_w = np.asarray(want["cov"], np.float64)
    return dict(
        pose_gap_m=max(float(np.linalg.norm(np.asarray(got[k], np.float64)
                                            - np.asarray(want[k])))
                       for k in ("raw_pos", "pos")),
        yaw_gap_rad=max(_yaw_gap(got[k], want[k]) if abs(_yaw(want[k]))
                        < np.pi - YAW_NEAR_PI else 0.0
                        for k in ("raw_rot", "rot")),
        cov_gap=float(np.abs(np.asarray(got["cov"], np.float64) - cov_w).max()
                      / max(np.abs(cov_w).max(), 1e-300)),
        entropy_gap=abs(float(got["entropy"]) - float(want["entropy"])),
        noise_gap=float((noise_got.to(noise_want.device).float()
                         - noise_want).abs().max()))


def within(numbers: dict, limits: dict) -> bool:
    """Every compared number read and within its limit."""
    return all(numbers.get(k) is not None and numbers[k] <= limits[k]
               for k in NUMBERS)


def verdict(attempted: int, failed: int, numbers: dict,
            limits: dict) -> bool:
    """``correct``: the run pushed work, every update came back with a
    finite answer, and every compared number keeps to its limit."""
    return attempted > 0 and failed == 0 and within(numbers, limits)


def worst(rows) -> dict:
    return {k: max(r[k] for r in rows) for k in NUMBERS} if rows else {}


def compare(records, model, map_points, device, control=False, log=None):
    """``(numbers, control numbers or None)`` over the records: the
    program's answers against the reference's, and with ``control`` the
    bfloat16 reference's against the float32 one's."""
    field = rf.build(map_points, field_config(model), device)
    rows, ctl = [], []
    for rec in records:
        want, noise = reference_step(field, model, rec, device)
        rows.append(gaps(rec["result"], want, rec["post_noise"], noise))
        if control:
            low, low_noise = reference_step(field, model, rec, device,
                                            torch.bfloat16)
            ctl.append(gaps(low, want, low_noise, noise))
        if log is not None:
            log(f"check: {rows[-1]}" + (f" control {ctl[-1]}" if control
                                        else ""))
    return worst(rows), (worst(ctl) if control else None)
