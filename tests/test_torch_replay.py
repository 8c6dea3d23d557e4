"""Replay and the Tier-3 gate of the port: ``io/replay.py`` against the
JAX package's (a log saved by either loads in the other; the gate math
gives the same numbers on the same poses), the port's Tier-3 log
generator (``tools/tier3.py``) against ``tools/make_tier3_log.py``, and
the gate itself through the port on the CPU.

Tolerances and why: log event times, kinds and frames equal; points and
poses to 1e-5 (the JAX generator rotates in jnp float32, the port in
torch float32, a few ulps apart); the gate math's outputs equal (the
same numpy code on the same arrays).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcl_3dl_tpu.io import replay as jreplay

from mcl_3dl_tpu_torch.io import replay as treplay
from mcl_3dl_tpu_torch.tools import run_tier3, tier3

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

torch.set_num_threads(2)   # several test workers share the CPU


def _log(cls, rng, with_ref=True):
    e, m = 12, 40
    kw = dict(
        times=np.sort(rng.uniform(0, 2, e)), kinds=rng.integers(0, 3, e).astype(np.int32),
        odom_pos=rng.normal(size=(e, 3)).astype(np.float32),
        odom_rot=rng.normal(size=(e, 4)).astype(np.float32),
        imu_acc=rng.normal(size=(e, 3)).astype(np.float32),
        imu_rot=rng.normal(size=(e, 4)).astype(np.float32),
        cloud_start=np.arange(e, dtype=np.int64),
        cloud_len=np.full(e, 3, np.int64),
        cloud_origin=rng.normal(size=(e, 3)).astype(np.float32),
        cloud_frame=rng.integers(0, 2, e).astype(np.int32),
        cloud_points=rng.normal(size=(m, 3)).astype(np.float32),
        map_points=rng.normal(size=(m, 3)).astype(np.float32))
    if with_ref:
        kw.update(ref_times=np.linspace(0, 2, 9),
                  ref_pos=rng.normal(size=(9, 3)).astype(np.float32),
                  ref_rot=rng.normal(size=(9, 4)).astype(np.float32),
                  kidnap_time=np.asarray(1.25))
    return cls(**kw)


@pytest.mark.parametrize("writer,reader", [(jreplay, treplay),
                                           (treplay, jreplay)],
                         ids=["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("with_ref", [True, False])
def test_replay_log_loads_in_the_other_package(tmp_path, writer, reader,
                                               with_ref):
    log = _log(writer.ReplayLog, np.random.default_rng(0), with_ref)
    path = tmp_path / "log.npz"
    log.save(path)
    back = reader.ReplayLog.load(path)
    for k, v in log.__dict__.items():
        got = getattr(back, k)
        if v is None:
            assert got is None, k
        else:
            assert got.dtype == v.dtype, k
            np.testing.assert_array_equal(got, v, err_msg=k)


def _poses(rng, log, n=30, spread=0.2):
    """Output poses around the reference, some beyond the gates."""
    ts = np.sort(rng.uniform(log.ref_times[0], log.ref_times[-1], n))
    poses, raw = [], []
    for t in ts:
        pos = rng.normal(0, spread, 3) + log.ref_pos[0]
        cov = np.diag(rng.uniform(0.001, 0.05, 6))
        poses.append((t, pos, np.array([0, 0, 0, 1.0]), cov))
        raw.append((t, pos + rng.normal(0, 0.03, 3), np.array([0, 0, 0, 1.0])))
    return poses, raw


@pytest.mark.parametrize("exclude", [None, (0.5, 1.2)])
def test_gate_math_matches_jax(exclude):
    rng = np.random.default_rng(1)
    log = _log(jreplay.ReplayLog, rng)
    poses, raw = _poses(rng, log)
    outs = []
    for mod in (jreplay, treplay):
        d = mod.ReplayDriver(engine=None, log=log)
        d.poses, d.raw_poses = list(poses), list(raw)
        outs.append((d.compare_to_reference(0.3, exclude=exclude),
                     d.compare_tf(0.05, exclude=exclude)))
    (pj, tj), (pt, tt) = outs
    assert pj[0] == pt[0] and tj[0] == tt[0]
    assert pj[1] == pt[1] and tj[1] == tt[1]
    assert len(pt[1]) > 0 and len(tt[1]) > 0    # the data crosses the gates


@pytest.mark.parametrize("kw", [
    dict(kidnap_step=4),
    dict(odom_mode="none", kidnap_step=-1, speed_scale=0.2, s_start=0.2),
    dict(dual_lidar=False, kidnap_step=-1, drift_scale=2.0),
], ids=["kidnap", "no-odom", "one-lidar"])
def test_build_log_matches_jax(kw):
    from tools import make_tier3_log as jgen

    want = jgen.build_log(n_steps=8, **kw)
    got = tier3.build_log(n_steps=8, **kw)
    for k in ("times", "kinds", "cloud_start", "cloud_len", "cloud_frame",
              "ref_times", "kidnap_time"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    for k in ("odom_pos", "odom_rot", "imu_acc", "imu_rot", "cloud_origin",
              "cloud_points", "map_points", "ref_pos", "ref_rot"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=k)
    assert tier3.TIER3_PARAMS == jgen.TIER3_PARAMS


def _gate(steps):
    result = run_tier3.run_all(steps=steps, device="cpu")
    assert set(result) >= {"with_imu", "no_imu", "no_odom", "pass"}
    for name in ("with_imu", "no_imu", "no_odom"):
        g = result[name]
        assert g["pose_violations"] == 0 and g["tf_violations"] == 0, (name, g)
        assert g["max_error_m"] <= 0.3 and g["max_tf_diff_m"] <= 0.05
        assert g["pass"], (name, g)
    for name in ("with_imu", "no_imu"):
        k = result[name]["kidnap"]
        assert k["auto_expansions"] >= 1 and k["global_localization_calls"] == 1
    assert result["pass"]
    return result


def test_tier3_gate_through_the_port_60_steps():
    """The three variants at 60 steps (the kidnap at step 24, so the
    correlative recovery and its global-mode step run), on the CPU."""
    _gate(60)


@pytest.mark.slow
def test_tier3_gate_through_the_port_full_drive():
    """The full 220-step gate (>= 200 gated poses) on the CPU; slow only
    by the suite's budget (about half a minute)."""
    res = _gate(run_tier3.STEPS)
    assert res["with_imu"]["kidnap"]["poses_gated_after_recovery"] >= 180


def test_gate_recovery_runs_global_mode():
    """At the first auto expansion the operator loop's correlative search
    seeds 512 particles above ``num_particles`` 384: the next measurement
    runs in global mode (the ramp's 96 * 384 / 512 = 72 points in the
    96-slot bucket, beam dropped) and decays the count to 384, and
    capacity stays at the 512 bucket."""
    log = tier3.build_log(n_steps=32)
    trace = []
    run_tier3.run_gate(log, device="cpu", trace=trace)
    glob = [i for i, t in enumerate(trace) if t[1] == -1]
    assert len(glob) == 1, trace
    i = glob[0]
    assert trace[i][2:] == (384, 512, 96)
    assert trace[i + 1][1] == 2 and trace[i + 1][4] == 96
    assert {t[3] for t in trace} == {512}
