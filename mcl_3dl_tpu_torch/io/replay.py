"""Offline replay driver — the bag-replay regression harness.

A copy of the JAX package's ``io/replay.py`` (numpy only, the same log
format, so a log saved by either package loads in the other), kept here
so the port imports nothing of that package.

The reference's Tier-3 regression replays ``short_test3.bag`` through
the live ROS node (test/tests/localization_rostest.test.in).  Here, a
bag is converted offline (tools/bag_to_npz.py) into a ``ReplayLog`` npz
with time-ordered sensor events, and :class:`ReplayDriver` feeds them to
the engine, mirroring the node's callback routing:

* ``odom``  events -> :meth:`MCL3DL.odometry`  (cbOdom)
* ``imu``   events -> :meth:`MCL3DL.imu`       (cbImu)
* ``cloud`` events -> :meth:`MCL3DL.push_cloud` (cbCloud + accumulation)

Log schema (all arrays time-ordered):
  times[E] float64, kinds[E] uint8 (0=odom, 1=imu, 2=cloud),
  odom_pos[E,3], odom_rot[E,4], imu_acc[E,3], imu_rot[E,4],
  cloud_start[E], cloud_len[E] into cloud_points[M,3] (odom frame),
  cloud_origin[E,3] (sensor origin, odom frame), cloud_frame[E] uint16
  (sensor id), plus map_points[K,3].
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

ODOM, IMU, CLOUD = 0, 1, 2


@dataclass
class ReplayLog:
    times: np.ndarray
    kinds: np.ndarray
    odom_pos: np.ndarray
    odom_rot: np.ndarray
    imu_acc: np.ndarray
    imu_rot: np.ndarray
    cloud_start: np.ndarray
    cloud_len: np.ndarray
    cloud_origin: np.ndarray
    cloud_frame: np.ndarray
    cloud_points: np.ndarray
    map_points: np.ndarray
    ref_times: Optional[np.ndarray] = None     # reference trajectory
    ref_pos: Optional[np.ndarray] = None
    ref_rot: Optional[np.ndarray] = None
    # scalar time of a recorded kidnap event (true pose teleport the
    # odometry cannot see), or -1; gates exclude a bounded recovery
    # window after it (mcl_3dl_tpu_torch/tools/run_tier3.py)
    kidnap_time: Optional[np.ndarray] = None

    def save(self, path):
        np.savez_compressed(path, **{
            k: v for k, v in self.__dict__.items() if v is not None
        })

    @classmethod
    def load(cls, path) -> "ReplayLog":
        data = np.load(path)
        kwargs = {k: data[k] for k in data.files}
        return cls(**kwargs)


@dataclass
class ReplayDriver:
    engine: object
    log: ReplayLog
    on_pose: Optional[Callable] = None
    poses: list = field(default_factory=list)
    raw_poses: list = field(default_factory=list)

    def run(self, t_end: Optional[float] = None):
        """Feed every event to the engine in time order."""
        eng = self.engine
        if self.log.map_points.size:
            eng.load_map(self.log.map_points)
        for i in range(len(self.log.times)):
            t = float(self.log.times[i])
            if t_end is not None and t > t_end:
                break
            kind = int(self.log.kinds[i])
            if kind == ODOM:
                eng.odometry(self.log.odom_pos[i], self.log.odom_rot[i], t)
            elif kind == IMU:
                eng.imu(self.log.imu_acc[i], self.log.imu_rot[i], t)
            elif kind == CLOUD:
                s, n = int(self.log.cloud_start[i]), int(self.log.cloud_len[i])
                res = eng.push_cloud(
                    f"lidar{int(self.log.cloud_frame[i])}",
                    self.log.cloud_points[s:s + n],
                    self.log.cloud_origin[i],
                    t,
                )
                if res is not None and res.pos is not None:
                    # record at the measurement stamp (= last accumulated
                    # cloud's stamp, mcl_3dl.cpp:317,712) — the stamp the
                    # node publishes and compare_pose interpolates at
                    ts = float(res.stamp) if res.stamp is not None else t
                    self.poses.append((ts, np.asarray(res.pos),
                                       np.asarray(res.rot),
                                       np.asarray(res.cov)))
                    self.raw_poses.append(
                        (ts, np.asarray(res.raw_pos), np.asarray(res.raw_rot)))
                    if self.on_pose:
                        self.on_pose(ts, res)
        return self.poses

    def compare_to_reference(self, tolerance: float = 0.3,
                             exclude: Optional[tuple] = None):
        """Mirror compare_pose.cpp:40-113: every output pose within
        ``tolerance`` of the time-interpolated reference position AND
        within 3 sigma of the self-reported covariance per axis.
        ``exclude=(t0, t1)`` skips poses in a declared recovery window
        (e.g. after a recorded kidnap event) — everything outside it is
        still gated.

        Returns (max_error, violations list).
        """
        assert self.log.ref_times is not None, "log has no reference trajectory"
        violations = []
        max_err = 0.0
        for t, pos, rot, cov in self.poses:
            if exclude is not None and exclude[0] <= t <= exclude[1]:
                continue
            j = np.searchsorted(self.log.ref_times, t)
            j = min(max(j, 1), len(self.log.ref_times) - 1)
            t0, t1 = self.log.ref_times[j - 1], self.log.ref_times[j]
            a = 0.0 if t1 == t0 else (t - t0) / (t1 - t0)
            ref = (1 - a) * self.log.ref_pos[j - 1] + a * self.log.ref_pos[j]
            err_vec = pos - ref
            err = float(np.linalg.norm(err_vec))
            max_err = max(max_err, err)
            if err > tolerance:
                violations.append((t, "dist", err))
            for axis in range(3):
                sigma = np.sqrt(max(cov[axis, axis], 1e-12))
                if abs(err_vec[axis]) > 3.0 * sigma + 1e-2:
                    violations.append((t, f"3sigma_axis{axis}", err_vec[axis]))
        return max_err, violations

    def compare_tf(self, tolerance: float = 0.05,
                   exclude: Optional[tuple] = None):
        """Mirror compare_tf.cpp:42-101: the TF-composed (LPF-smoothed)
        pose must agree with the published raw pose within ``tolerance``
        metres at every output.  Returns (max_diff, violations list).
        """
        violations = []
        max_diff = 0.0
        for (t, pos, _, _), (_, raw, _) in zip(self.poses, self.raw_poses):
            if exclude is not None and exclude[0] <= t <= exclude[1]:
                continue
            diff = float(np.linalg.norm(pos - raw))
            max_diff = max(max_diff, diff)
            if diff > tolerance:
                violations.append((t, "tf", diff))
        return max_diff, violations
