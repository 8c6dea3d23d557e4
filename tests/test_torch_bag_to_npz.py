"""The port's bag converter (``mcl_3dl_tpu_torch/tools/bag_to_npz.py``)
against the JAX package's (``tools/bag_to_npz.py``), each run as a
command on the synthetic ROS1 v2.0 bags of ``tests/test_bag_roundtrip.py``
(a bz2 chunk with every consumed message type, and an uncompressed chunk
of three scans), with the scan topic named, sniffed, and with scans
subsampled: the two ``.npz`` logs must hold the same arrays, equal in
value and dtype.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mcl_3dl_tpu.math import quat_np as mq
from test_bag_roundtrip import (_connection, _message, _msg_imu,
                                _msg_odometry, _msg_pointcloud2, _msg_tf,
                                write_bag)

ROOT = Path(__file__).resolve().parents[1]


def _tiny():
    """``test_bag_roundtrip.test_bag_roundtrip``'s bag (bz2)."""
    t0 = 1000.0
    q_laser = np.asarray(mq.from_rpy(np.asarray([0.0, 0.0, np.pi / 2])))
    t_laser = np.asarray([0.1, 0.0, 0.5])
    q_imu = np.asarray(mq.from_rpy(np.asarray([0.0, np.pi, 0.0])))
    q_base = np.asarray(mq.from_rpy(np.asarray([0.0, 0.0, 0.3])))
    t_base = np.asarray([1.0, -2.0, 0.0])
    scan = np.asarray([[1.0, 0.0, 0.0], [2.0, 1.0, -0.5], [np.nan, 0.0, 0.0],
                       [0.5, -0.25, 0.25]])
    mappts = np.asarray([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [2.0, 0.5, 0.25]])
    imu_quat = np.asarray(mq.from_rpy(np.asarray([0.05, -0.02, 1.2])))
    conns = {1: ("/tf_static", "tf2_msgs/TFMessage"),
             2: ("/tf", "tf2_msgs/TFMessage"),
             3: ("/odom", "nav_msgs/Odometry"),
             4: ("/imu/data", "sensor_msgs/Imu"),
             5: ("/cloud", "sensor_msgs/PointCloud2"),
             6: ("/mapcloud", "sensor_msgs/PointCloud2")}
    records = [_connection(cid, top, typ) for cid, (top, typ) in conns.items()]
    records += [
        _message(1, t0, _msg_tf([
            (t0, "base_link", "laser", t_laser, q_laser),
            (t0, "base_link", "imu_link", np.zeros(3), q_imu)])),
        _message(2, t0 + 0.5, _msg_tf([
            (t0 + 0.5, "odom", "base_link", t_base + 100.0, q_base)])),
        _message(2, t0 + 0.1, _msg_tf([
            (t0 + 0.1, "odom", "base_link", t_base, q_base)])),
        _message(3, t0 + 0.10, _msg_odometry(t0 + 0.10, "odom", "base_link",
                                             t_base, q_base)),
        _message(4, t0 + 0.11, _msg_imu(t0 + 0.11, "imu_link", imu_quat,
                                        np.asarray([0.1, 0.2, 9.7]))),
        _message(5, t0 + 0.12, _msg_pointcloud2(
            t0 + 0.12, "laser", scan,
            fields=[("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1),
                    ("intensity", 12, 7, 1), ("label", 20, 6, 1)],
            point_step=24, extra_cols={"intensity": np.arange(1.0, 5.0),
                                       "label": np.arange(4)})),
        _message(6, t0 + 0.2, _msg_pointcloud2(
            t0 + 0.2, "map", mappts,
            fields=[("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1)],
            point_step=12)),
    ]
    return records, "bz2"


def _plain():
    """``test_bag_roundtrip.test_bag_roundtrip_uncompressed``'s bag."""
    t0 = 5.0
    records = [_connection(1, "/tf", "tf2_msgs/TFMessage"),
               _connection(2, "/cloud", "sensor_msgs/PointCloud2"),
               _message(1, t0, _msg_tf([
                   (t0, "odom", "base_link", np.zeros(3),
                    np.array([0, 0, 0, 1.0])),
                   (t0, "base_link", "laser", np.zeros(3),
                    np.array([0, 0, 0, 1.0]))]))]
    for k in range(3):
        records.append(_message(2, t0 + 0.1 * k, _msg_pointcloud2(
            t0 + 0.1 * k, "laser", np.asarray([[float(k), 0.0, 0.0]]),
            fields=[("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1)],
            point_step=12)))
    return records, "none"


CASES = {
    "tiny_bz2": (_tiny, ["--cloud-topic", "/cloud"]),
    "tiny_bz2_sniffed": (_tiny, []),
    "tiny_bz2_subsampled": (_tiny, ["--cloud-topic", "/cloud",
                                    "--max-points", "2"]),
    "plain_uncompressed": (_plain, ["--cloud-topic", "/cloud"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_converter_matches_jax(tmp_path, case):
    make, args = CASES[case]
    records, compression = make()
    bag = tmp_path / "in.bag"
    write_bag(bag, records, compression=compression)
    outs = {"jax": tmp_path / "jax.npz", "port": tmp_path / "port.npz"}
    for name, cmd in (("jax", ["tools/bag_to_npz.py"]),
                      ("port", ["-m", "mcl_3dl_tpu_torch.tools.bag_to_npz"])):
        r = subprocess.run([sys.executable, *cmd, str(bag), str(outs[name]),
                            *args], cwd=ROOT, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
    want, got = np.load(outs["jax"]), np.load(outs["port"])
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got["kinds"]) > 0
