"""Tier-3 regression gate (the reference's bag-replay CI stage,
test/CMakeLists.txt:120-168) through the port, on the synthetic drive of
``tools/tier3.py``.

    python -m mcl_3dl_tpu_torch.tools.run_tier3 [--steps 220] [--cpu]
        [--interp nearest|trilinear] [--log converted_bag.npz]

The reference's gate math:

* compare_pose.cpp:89-98: every output pose within 0.3 m of the
  time-interpolated reference trajectory and within 3 sigma of the
  self-reported covariance on each axis;
* compare_tf.cpp:84-85: the TF-composed (smoothed) pose within 0.05 m of
  the published raw pose.

Three variants, as the JAX package's ``tools/run_tier3.py`` runs them:
with IMU, without IMU (test/CMakeLists.txt:147-159), and without
odometry (config/test_localization_noodom.yaml: fake odometry from the
IMU attitude on a walking-pace drive).  The drive holds a kidnap: when
the engine reports an auto expansion reset, the operator loop below calls
the correlative global-localization service once (a yaw prior from the
still-valid attitude, a same-floor z prior), whose 512 seeds put the
next step above ``num_particles``, in global mode.  The gates skip
``RECOVERY_WINDOW`` seconds after the kidnap and hold every later pose.

``--interp`` sets the likelihood field's sampling for every variant, as
the JAX package's ``--interp`` does (its trilinear record is
``docs/TIER3_GATE_TRILINEAR.json``); the default is the shipped
``nearest``.

Prints one JSON object with the layout of the JAX package's record
(``docs/TIER3_GATE.json``, with ``interp``), each variant's wall seconds
and the device added; exits 1 if a gate fails.  The engine runs on the CUDA device
unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from mcl_3dl_tpu_torch import MCL3DL, Params
from mcl_3dl_tpu_torch.config import LikelihoodParams
from mcl_3dl_tpu_torch.engine import resolve_device
from mcl_3dl_tpu_torch.io.replay import IMU, ReplayDriver, ReplayLog
from mcl_3dl_tpu_torch.math import quat_np as mqn
from mcl_3dl_tpu_torch.tools.tier3 import TIER3_PARAMS, build_log

RECOVERY_WINDOW = 1.0   # seconds after the kidnap excluded from gates
STEPS = 220             # >= 200 gated poses

# the no-odom variant (config/test_localization_noodom.yaml): IMU attitude
# in place of wheel odometry and boosted resample variances, at 0.2x speed
# on the west edge, where the motion axis is richly constrained
NO_ODOM_OVERRIDE = dict(
    fake_odom=True,
    num_particles=256,
    resample_var_x=0.2, resample_var_y=0.2, resample_var_z=0.05,
    bias_var_dist=100.0,
    match_dist_min=0.3,
    # the drive starts at circuit arc length 0.2 on the west edge
    init_x=-2.8, init_y=-2.6,
)


def without_imu(log: ReplayLog) -> ReplayLog:
    """The log with its IMU events dropped (the no-imu rostest variant)."""
    keep = log.kinds != IMU
    return dataclasses.replace(
        log, times=log.times[keep], kinds=log.kinds[keep],
        odom_pos=log.odom_pos[keep], odom_rot=log.odom_rot[keep],
        imu_acc=log.imu_acc[keep], imu_rot=log.imu_rot[keep],
        cloud_start=log.cloud_start[keep], cloud_len=log.cloud_len[keep],
        cloud_origin=log.cloud_origin[keep],
        cloud_frame=log.cloud_frame[keep])


def run_gate(log: ReplayLog, use_imu=True, params_override=None, device=None,
             trace=None) -> dict:
    """Replay ``log`` through ``MCL3DL`` on ``device`` with the operator
    recovery loop and gate the poses.  ``trace``, a list, receives one
    ``(tier_like, tier_beam, n_active, capacity, like_slots)`` tuple a
    measurement."""
    if not use_imu:
        log = without_imu(log)
    pdict = dict(TIER3_PARAMS)
    pdict.update(params_override or {})
    eng = MCL3DL(Params.from_dict(pdict), device=device)
    driver = ReplayDriver(eng, log)
    kidnap_t = float(log.kidnap_time) if log.kidnap_time is not None else -1.0
    counters = {"expansions": 0, "gl_calls": 0}

    def on_pose(t, res):
        if trace is not None:
            a = eng.last_aux
            trace.append((a["tier_like"], a["tier_beam"], res.particle_size,
                          eng.pstate.capacity, a["like_slots"]))
        # the operator loop: auto expansion resetting flags the lost
        # state; the first time, fire the one-shot correlative search with
        # a yaw prior from the still-valid attitude and a same-floor z
        if res.expanded:
            counters["expansions"] += 1
            if counters["gl_calls"] == 0:
                yaw = float(mqn.to_rpy(np.asarray(res.rot, np.float64))[2])
                eng.global_localization_correlative(
                    num_seeds=512, yaw_prior=(yaw, 0.4),
                    seed_z=float(res.pos[2]))
                counters["gl_calls"] += 1

    driver.on_pose = on_pose
    t0 = time.perf_counter()
    driver.run()
    seconds = time.perf_counter() - t0
    exclude = (kidnap_t, kidnap_t + RECOVERY_WINDOW) if kidnap_t > 0 else None
    max_err, violations = driver.compare_to_reference(0.3, exclude=exclude)
    tf_diff, tf_violations = driver.compare_tf(0.05, exclude=exclude)
    n_after = sum(1 for (t, *_) in driver.poses
                  if exclude is not None and t > exclude[1])
    out = {
        "poses": len(driver.poses),
        "max_error_m": round(float(max_err), 4),
        "tolerance_m": 0.3,
        "pose_violations": len(violations),
        "max_tf_diff_m": round(float(tf_diff), 4),
        "tf_tolerance_m": 0.05,
        "tf_violations": len(tf_violations),
        "pass": not violations and not tf_violations,
    }
    if kidnap_t > 0:
        out["kidnap"] = {
            "kidnap_time": kidnap_t,
            "recovery_window_s": RECOVERY_WINDOW,
            "poses_gated_after_recovery": n_after,
            "auto_expansions": counters["expansions"],
            "global_localization_calls": counters["gl_calls"],
        }
        # the event must have exercised the recovery, and the drive must
        # be long enough to gate again afterwards
        out["pass"] = (out["pass"] and counters["expansions"] > 0
                       and counters["gl_calls"] > 0 and n_after >= 10)
    out["seconds"] = seconds
    return out


def run_all(steps=STEPS, device=None, log_path=None, traces=None,
            interp=None) -> dict:
    """The three variants on the synthetic drive of ``steps`` scans (or
    with and without IMU on a converted log): the result object.
    ``traces``, a dict, receives each variant's per-measurement trace;
    ``interp`` overrides ``likelihood.interp`` in every variant."""
    base = {"likelihood.interp": interp} if interp else {}

    def gate(name, log, params_override=None, **kw):
        trace = [] if traces is not None else None
        gates[name] = run_gate(log, device=device, trace=trace,
                               params_override=dict(base,
                                                    **(params_override or {})),
                               **kw)
        if traces is not None:
            traces[name] = trace

    gates = {}
    if log_path:
        log = ReplayLog.load(log_path)
        source = log_path
        gate("with_imu", log, use_imu=True)
        gate("no_imu", log, use_imu=False)
    else:
        log = build_log(n_steps=steps)
        source = (f"synthetic_circuit_v2 (mcl_3dl_tpu_torch/tools/tier3.py, "
                  f"seed 0: {steps} steps, dual-LIDAR, sharp corners, ~2 cm/s"
                  f" + yaw odometric drift, kidnap at step 24)")
        gate("with_imu", log, use_imu=True)
        gate("no_imu", log, use_imu=False)
        gate("no_odom", build_log(n_steps=steps, odom_mode="none",
                                  kidnap_step=-1, speed_scale=0.2,
                                  s_start=0.2),
             use_imu=True, params_override=NO_ODOM_OVERRIDE)
    result = {"source": source, **gates}
    result["interp"] = interp or LikelihoodParams().interp
    result["pass"] = all(g["pass"] for g in gates.values())
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log", default=None,
                    help="converted real bag (ReplayLog npz); default: the "
                         "synthetic drive")
    ap.add_argument("--steps", type=int, default=None,
                    help=f"synthetic drive length (default {STEPS})")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    ap.add_argument("--interp", default=None, choices=["nearest", "trilinear"],
                    help="likelihood field sampling of every variant "
                         "(default: the shipped nearest)")
    args = ap.parse_args(argv)
    if args.log and args.steps is not None:
        ap.error("--steps applies to the synthetic drive, not --log")
    device = "cpu" if args.cpu else None
    result = run_all(args.steps or STEPS, device, args.log,
                     interp=args.interp)
    result["device"] = resolve_device(device).type
    print(json.dumps(result, indent=1))
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
