"""The Tier-3 regression log: a deterministic recorded drive, the
synthetic stand-in for the reference's short_test3.bag
(test/CMakeLists.txt:122-132), in the ``ReplayLog`` format.

The JAX package's generator (``tools/make_tier3_log.py``: ``build_log``,
``make_world``, ``TIER3_PARAMS``) restated on the port's worlds and
quaternions, so it runs where JAX is not installed; from one seed it
writes the same log.  ``mcl_3dl_tpu_torch.tools.run_tier3`` replays it
and applies the reference's gate math.

Drive profile v2: two LIDARs (fore/up and aft/up), each emitting its own
cloud per scan period and round-accumulated by the engine
(``accum_cloud=1``); a square circuit with 90-degree corners at the
1.5 rad/s yaw-rate cap at 1.2 m/s, with roll/pitch wobble; ~2 cm/s
systematic and random-walk odometric drift plus a slow yaw drift; and a
KIDNAP at ``kidnap_step``: the true pose teleports ~1.8 m while odometry
goes on smoothly.

    python -m mcl_3dl_tpu_torch.tools.tier3 out.npz [--steps 60]
"""

import argparse

import numpy as np

from mcl_3dl_tpu_torch.io.replay import CLOUD, IMU, ODOM, ReplayLog
from mcl_3dl_tpu_torch.math import quat_np as mqn
from mcl_3dl_tpu_torch.worlds import make_room, simulate_scan

# Sensor mounts in the base frame (fore/up and aft/up, like a dual-VLP
# cart); the second entry is only used when dual_lidar is on.
SENSOR_OFFSETS = np.array([[0.2, 0.0, 0.3], [-0.2, 0.0, 0.5]], np.float32)

# Square circuit geometry: corners at (+-HALF, +-HALF), walked
# counter-clockwise starting on the west edge heading north.
HALF = 2.8
SPEED = 0.12          # m per 0.1 s step = 1.2 m/s
YAW_RATE = 0.15       # rad per step cap = 1.5 rad/s at corners
# NOTE on the aggressiveness ceiling: the accumulation protocol measures
# with a one-period-stale scan (the reference's CloudAccumulationLogic
# triggers on the NEXT first-key cloud, src/cloud_accum.cpp:63-67), so
# the per-step motion is un-modelled scan error; 1.2 m/s + 1.5 rad/s is
# the regime where that inherent bias stays well inside the 0.3 m /
# 0.05 m gates — matching the reference demo bag's cart dynamics.
KIDNAP_DELTA = np.array([1.4, -1.1, 0.0], np.float32)


def _circuit_pose(s):
    """Position + edge heading at arc length ``s`` along the square."""
    per_edge = 2 * HALF
    s = s % (4 * per_edge)
    edge, u = int(s // per_edge), s % per_edge
    if edge == 0:    # west edge, heading +y
        return np.array([-HALF, -HALF + u]), np.pi / 2
    if edge == 1:    # north edge, heading +x
        return np.array([-HALF + u, HALF]), 0.0
    if edge == 2:    # east edge, heading -y
        return np.array([HALF, HALF - u]), -np.pi / 2
    return np.array([HALF - u, -HALF]), np.pi


def make_world():
    """Asymmetric room: 12x9 rectangle with an L-notch walled off in the
    NE corner, plus pillars.  The rectangle kills the square's 90-degree
    yaw aliases; the notch changes the wall OUTLINE itself so even the
    180-degree alias mismatches in both the correlative search and the
    likelihood field (a symmetric room is genuinely unlocalizable for
    any scan matcher after a kidnap)."""
    room = make_room(x0=-6, x1=6, y0=-4.5, y1=4.5, grid=0.15)
    zz = np.arange(0.0, 2.0 + 0.075, 0.15)
    # notch wall x=3.4, y in [1.8, 4.5]; and y=1.8, x in [3.4, 6]
    yy = np.arange(1.8, 4.5 + 0.075, 0.15)
    gy, gz = np.meshgrid(yy, zz, indexing="ij")
    w1 = np.stack([np.full(gy.size, 3.4), gy.ravel(), gz.ravel()], 1)
    xx = np.arange(3.4, 6.0 + 0.075, 0.15)
    gx, gz = np.meshgrid(xx, zz, indexing="ij")
    w2 = np.stack([gx.ravel(), np.full(gx.size, 1.8), gz.ravel()], 1)
    room = np.concatenate([room, w1, w2])
    pillars = []
    for (px0, px1, py0, py1, pz1) in (
        (3.0, 4.0, 2.0, 3.0, 2.0),
        (-4.5, -3.8, 1.0, 1.6, 1.4),
        (0.5, 1.2, -4.6, -4.0, 1.8),
    ):
        xx = np.arange(px0, px1, 0.2)
        yy = np.arange(py0, py1, 0.2)
        zz = np.arange(0.0, pz1, 0.2)
        gx, gy, gz = np.meshgrid(xx, yy, zz, indexing="ij")
        pillars.append(np.stack([gx.ravel(), gy.ravel(), gz.ravel()], 1))
    return np.concatenate([room] + pillars)


def build_log(n_steps=60, seed=0, kidnap_step=24, dual_lidar=True,
              n_rays=320, odom_mode="normal", drift_scale=1.0,
              speed_scale=1.0, s_start=1.8):
    """``odom_mode``: "normal" emits wheel-odometry events with drift;
    "none" emits NO odometry (the reference's no-odom profile,
    config/test_localization_noodom.yaml — the engine synthesizes fake
    odometry from the IMU attitude, so clouds are recorded in that
    zero-translation frame).  ``drift_scale`` scales the odometric
    drift: 1.0 = ~2 cm/s systematic + random walk + slow yaw drift.
    ``speed_scale`` scales the drive speed: without odometry the filter
    must infer translation from scans alone, and the resample-noise
    random walk bounds the trackable speed (the reference's no-odom CI
    replays a walking-pace cart; 1.2 m/s is beyond what ANY odometry-
    free MCL tracks with 0.2 m resample jitter at 10 Hz)."""
    room = make_world()
    n_sensors = 2 if dual_lidar else 1
    no_odom = odom_mode == "none"

    rng = np.random.default_rng(seed)
    times, kinds = [], []
    opos, orot, iacc, irot = [], [], [], []
    cstart, clen, corig, cframe = [], [], [], []
    rt, rp, rr = [], [], []
    allpts = []
    drift = np.zeros(3)
    yaw_drift = 0.0
    kidnap = np.zeros(3)       # accumulated true-pose teleport
    t = 0.0
    yaw = np.pi / 2            # start heading of the west edge
    s0 = s_start               # arc-length start along the circuit

    def pad(skip_odom=False, skip_imu=False, skip_cloud=False):
        if not skip_odom:
            opos.append(np.zeros(3)); orot.append(np.zeros(4))
        if not skip_imu:
            iacc.append(np.zeros(3)); irot.append(np.zeros(4))
        if not skip_cloud:
            cstart.append(0); clen.append(0)
            corig.append(np.zeros(3)); cframe.append(0)

    kidnap_time = -1.0
    for i in range(n_steps):
        xy, heading = _circuit_pose(s0 + SPEED * speed_scale * i)
        # rate-limited yaw toward the edge heading: 90-degree corners
        # take ~10 steps at the 1.5 rad/s cap
        dyaw = (heading - yaw + np.pi) % (2 * np.pi) - np.pi
        yaw += float(np.clip(dyaw, -YAW_RATE, YAW_RATE))
        roll = 0.04 * np.sin(0.7 * i)
        pitch = 0.04 * np.cos(0.9 * i)

        if i == kidnap_step:
            kidnap = kidnap + KIDNAP_DELTA     # odometry never sees this

        tp = np.array([xy[0], xy[1], 0.4], np.float32) + kidnap
        tr = mqn.from_rpy(np.array([roll, pitch, yaw])).astype(np.float32)
        # ~2 cm/s systematic + random-walk translational drift plus a
        # slow yaw drift (the TF-gate budget, compare_tf.cpp:84-85, is
        # only meaningful at realistic drift rates).  The drift is a
        # slowly wandering odom->map offset: odom pose = D(true pose
        # without the kidnap), clouds are recorded in the SAME drifted
        # odom frame (the node receives them TF-ed by the drifting
        # odometry, src/mcl_3dl.cpp:274-302), so the composition the
        # engine does at measure time stays consistent.
        drift += drift_scale * (
            rng.normal(0, 0.002, 3) + np.array([0.002, 0.0, 0.0]))
        drift[2] = 0.0
        yaw_drift += drift_scale * (0.0002 + rng.normal(0, 0.0002))
        dq = mqn.from_rpy(np.array([0.0, 0.0, yaw_drift]))
        if no_odom:
            # fake-odom frame: zero translation, IMU attitude
            op = np.zeros(3, np.float32)
            o_rot = tr
        else:
            o_rot = mqn.mul(dq, tr).astype(np.float32)
            op = (mqn.rotate(dq, tp - kidnap) + drift).astype(np.float32)

        t += 0.1
        if i == kidnap_step:
            kidnap_time = t
        if not no_odom:
            times.append(t); kinds.append(ODOM)
            opos.append(op); orot.append(o_rot); pad(skip_odom=True)
        acc = mqn.rotate(mqn.inv(tr), np.array([0.0, 0.0, 1.0]))
        times.append(t + 0.001); kinds.append(IMU)
        iacc.append(acc); irot.append(tr); pad(skip_imu=True)
        for j in range(n_sensors):
            off = SENSOR_OFFSETS[j]
            sensor_world = tp + mqn.rotate(tr, off)
            sb = simulate_scan(room, sensor_world, tr, n_rays=n_rays,
                               seed=i * 4 + j, noise=0.005)
            pb = sb + off                     # base-frame points
            # odom-frame points/origin in the (drifted or fake) odom
            # frame the odometry events describe
            so = mqn.rotate(o_rot, pb) + op
            oo = mqn.rotate(o_rot, off) + op
            times.append(t + 0.002 + 0.001 * j); kinds.append(CLOUD)
            cstart.append(sum(len(a) for a in allpts)); clen.append(len(so))
            corig.append(oo); cframe.append(j)
            allpts.append(so); pad(skip_cloud=True)
        rt.append(t + 0.002); rp.append(tp); rr.append(tr)

    return ReplayLog(
        times=np.asarray(times), kinds=np.asarray(kinds, np.int32),
        odom_pos=np.asarray(opos, np.float32),
        odom_rot=np.asarray(orot, np.float32),
        imu_acc=np.asarray(iacc, np.float32),
        imu_rot=np.asarray(irot, np.float32),
        cloud_start=np.asarray(cstart, np.int64),
        cloud_len=np.asarray(clen, np.int64),
        cloud_origin=np.asarray(corig, np.float32),
        cloud_frame=np.asarray(cframe, np.int32),
        cloud_points=np.concatenate(allpts).astype(np.float32),
        map_points=make_world().astype(np.float32),
        ref_times=np.asarray(rt), ref_pos=np.asarray(rp, np.float32),
        ref_rot=np.asarray(rr, np.float32),
        kidnap_time=np.asarray(kidnap_time),
    )


TIER3_PARAMS = dict(
    num_particles=384,
    # the reference's own Tier-3 CI configuration
    # (config/test_localization.yaml): near-raw output smoothing,
    # widened match band, softened z anisotropy
    lpf_step=1.0,
    match_dist_min=0.5,
    dist_weight_z=2.0,
    init_x=-2.8, init_y=-1.0, init_z=0.4, init_yaw=float(np.pi / 2),
    init_var_x=0.2, init_var_y=0.2, init_var_z=0.05,
    init_var_roll=0.02, init_var_pitch=0.02, init_var_yaw=0.1,
    # the beam model is ON (the reference's headline combo): the
    # likelihood field alone cannot veto a 180-degree room alias after a
    # kidnap (unmatched points score 0, not negative) — beams through
    # known walls can (lidar_measurement_model_beam.cpp raycast veto)
    use_beam_model=True,
    odom_err_lin_lin=0.1, odom_err_lin_ang=0.05,
    accum_cloud=1,                 # dual-LIDAR round accumulation
    # clip the floor out of the measurement cloud (clip_z_min is the
    # reference's own likelihood-model knob, parameters.cpp:230-234) —
    # floor points match at ANY (x, y), so a kidnap is only visible in
    # the match ratio when walls/pillars dominate the scored cloud
    clip_z_min=-0.2,
    match_ratio_thresh=0.5,       # auto expansion resetting on kidnap
    seed=11,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-kidnap", action="store_true")
    args = ap.parse_args()
    log = build_log(args.steps, args.seed,
                    kidnap_step=-1 if args.no_kidnap else 24)
    log.save(args.out)
    print(f"wrote {args.out}: {len(log.times)} events, "
          f"{len(log.map_points)} map points")


if __name__ == "__main__":
    main()
