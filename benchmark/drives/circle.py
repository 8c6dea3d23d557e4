"""Drive ``circle``: one robot drives a closed circle of ``radius_m``
about the room's centre, ``lap_scans`` scans a lap, one lap made once
and looped by ``cells.single``.

Odometry at ``odom_hz`` is the true pose seen through a drifting frame
(a random walk of about ``odom_drift_mps`` and ``yaw_drift_rps``,
bridged so that it closes with the lap), the IMU at ``imu_hz`` reads
gravity with ``imu_noise``, and one scan a ``scan_period_s`` goes in the
drifting odometry frame.  Every message is stamped in drive time; a mix
with ``episode_scans`` re-seeds the filter at the true pose (the loop
uses ``reseed_cov``) every that many scans.  The seed sets the lap's
phase on the circle, the drift and the scans' draws.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.traffic import (GRAVITY, SENSOR_Z, Lap, Message, bridged_walk,
                               cast, yaw_quat)

LOOP = "single"


def make(mix: dict, cfg: dict, seed: int) -> Lap:
    """One lap of the drive, with ``cfg["cloud_points"]`` a scan."""
    points = cfg["cloud_points"]
    rng = np.random.default_rng([seed, 0])
    period = mix["scan_period_s"]
    scans = mix["lap_scans"]
    duration = scans * period
    omega = 2 * math.pi / duration
    phase = rng.uniform(-math.pi, math.pi)
    r = mix["radius_m"]

    def truth(t):
        th = phase + omega * np.asarray(t)
        return r * np.cos(th), r * np.sin(th), th + math.pi / 2

    n_odom = int(round(duration * mix["odom_hz"]))
    t_odom = np.arange(n_odom) / mix["odom_hz"]
    drift_step = mix["odom_drift_mps"] / mix["odom_hz"]
    dxy = bridged_walk(rng, n_odom, drift_step, drift_step, 2)
    dyaw = bridged_walk(rng, n_odom, mix["yaw_drift_rps"] / mix["odom_hz"],
                         mix["yaw_drift_rps"] / mix["odom_hz"], 1)[:, 0]

    def odom(i):
        x, y, yaw = truth(t_odom[i])
        c, s = math.cos(dyaw[i]), math.sin(dyaw[i])
        return (np.array([c * x - s * y + dxy[i, 0], s * x + c * y + dxy[i, 1],
                          0.0]), yaw + dyaw[i])

    msgs = []
    for i in range(n_odom):
        pos, yaw = odom(i)
        msgs.append(Message("odom", float(t_odom[i]), pos, yaw_quat(yaw)))
    n_imu = int(round(duration * mix["imu_hz"]))
    acc = rng.normal(0.0, mix["imu_noise"], (n_imu, 3)) + [0.0, 0.0, GRAVITY]
    for i in range(n_imu):
        t = i / mix["imu_hz"]
        j = min(int(t * mix["odom_hz"] + 1e-9), n_odom - 1)
        msgs.append(Message("imu", t, acc[i], yaw_quat(odom(j)[1])))
    sx, sy, syaw = truth(np.arange(scans) * period)
    clouds = cast(rng, sx, sy, syaw, points, mix["scan_noise_m"])
    every = int(round(mix["odom_hz"] * period))
    for k in range(scans):
        pos, yaw = odom(k * every)
        c, s = math.cos(yaw), math.sin(yaw)
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        pts = clouds[k].astype(np.float64) @ rot.T + pos
        origin = rot @ np.array([0.0, 0.0, SENSOR_Z]) + pos
        t = k * period
        if mix.get("episode_scans") and k % mix["episode_scans"] == 0:
            msgs.append(Message("reseed", t, np.array([sx[k], sy[k], 0.0]),
                                yaw_quat(syaw[k])))
        msgs.append(Message("cloud", t, pts, origin))
    order = {"odom": 0, "imu": 1, "reseed": 2, "cloud": 3}
    msgs.sort(key=lambda m: (m.t, order[m.kind]))
    return Lap(msgs, duration, np.column_stack([sx, sy, syaw]))
