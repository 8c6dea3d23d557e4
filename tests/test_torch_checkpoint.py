"""Checkpoints of the port (``checkpoint.py``) on the CPU: a round trip
continues bit for bit, a JAX package checkpoint loads its particles,
filters and bookkeeping (not its random stream), and a bad file raises.

Tolerances: none.  The round trip is compared with ``torch.equal`` on
particles and weights and ``np.array_equal`` on published poses; the JAX
file's arrays load unchanged (float32 in, float32 out).
"""

import json

import numpy as np
import pytest
import torch

from mcl_3dl_tpu import MCL3DL as JMCL3DL
from mcl_3dl_tpu import checkpoint as jckpt
from mcl_3dl_tpu.config import Params as JParams

from mcl_3dl_tpu_torch import MCL3DL, Params, checkpoint, convert, worlds
from mcl_3dl_tpu_torch.tools import all_options as ao

torch.set_num_threads(2)   # several test workers share the CPU


def _engine():
    return ao.engine("cpu", num_particles=1024)


@pytest.mark.parametrize("options", ["all", "defaults"])
def test_round_trip_continues_bit_equal(tmp_path, options):
    """Two measurements, a checkpoint, then three measurements on the
    running engine and on a fresh one loaded from the file (fed the scan
    the running engine holds in its accumulation buffer): equal bits."""
    if options == "all":
        make = _engine
    else:
        def make():
            eng = MCL3DL(Params(num_particles=1024), device="cpu")
            eng.load_map(worlds.world_map())
            return eng
    eng = make()
    eng.initial_pose(np.zeros(3), ao.IDENT, worlds.TRACKING_COV)
    scans = ao.Scans(np.random.default_rng(0), 256)
    ao.measure(eng, scans, 2)
    path = tmp_path / "ckpt.npz"
    checkpoint.save_checkpoint(eng, path)
    twin = make()
    checkpoint.load_checkpoint(twin, path)
    assert torch.equal(twin._gen.get_state(), eng._gen.get_state())
    assert twin._tf_seeded and twin.cnt_measure == eng.cnt_measure == 2
    assert scans.again(twin)[0] is None
    last = ao.measure(eng, scans, 3, twin=twin)       # raises on a difference
    assert last is not None and np.isfinite(last.pos).all()
    assert torch.equal(eng.f_pos.out, twin.f_pos.out)


def test_checkpoint_before_the_first_measurement_keeps_the_tf_seed_pending(
        tmp_path):
    eng = _engine()
    path = tmp_path / "fresh.npz"
    checkpoint.save_checkpoint(eng, path)
    twin = _engine()
    twin._tf_seeded = True
    checkpoint.load_checkpoint(twin, path)
    assert twin._tf_seeded is False


def test_jax_checkpoint_loads_particles_and_filters(tmp_path):
    jp = JParams(num_particles=200, seed=5)
    eng_j = JMCL3DL(jp)
    eng_j.initial_pose(np.float32([0.1, -0.2, 0.0]), np.float32([0, 0, 0, 1]),
                       np.diag([0.05 ** 2] * 6))
    eng_j.odometry(np.float32([0.0, 0.0, 0.0]), np.float32([0, 0, 0, 1]), 0.0)
    eng_j.odometry(np.float32([0.1, 0.0, 0.0]), np.float32([0, 0, 0, 1]), 0.2)
    eng_j.imu(np.float32([0, 0, 9.8]), np.float32([0, 0, 0, 1]), 0.0)
    eng_j.imu(np.float32([0.1, 0, 9.8]), np.float32([0, 0, 0, 1]), 0.2)
    eng_j.cnt_measure = 7
    path = tmp_path / "jax.npz"
    jckpt.save_checkpoint(eng_j, path)

    eng = MCL3DL(convert.params({"num_particles": 200, "seed": 5}),
                 device="cpu")
    gen_before = eng._gen.get_state().clone()
    checkpoint.load_checkpoint(eng, path)
    for got, want in zip(eng.pstate, eng_j.pstate):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for name in ("f_pos", "f_ang", "f_acc", "localize_rate"):
        for got, want in zip(getattr(eng, name), getattr(eng_j, name)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=name)
    assert eng.f_pos.x.device == eng.device and eng.f_acc.x.device.type == "cpu"
    np.testing.assert_array_equal(eng.state_prev_rot.numpy(),
                                  np.asarray(eng_j.state_prev_rot))
    for name in ("odom_pos", "odom_rot", "odom_prev_pos", "imu_quat"):
        np.testing.assert_array_equal(getattr(eng, name),
                                      np.asarray(getattr(eng_j, name)))
    for name in ("has_odom", "has_imu", "odom_last", "imu_last",
                 "cnt_measure", "_tf_seeded"):
        assert getattr(eng, name) == getattr(eng_j, name), name
    assert eng._n_active_host == 200
    # the random stream is the engine's own: jax.random does not carry over
    assert torch.equal(eng._gen.get_state(), gen_before)


def _rewrite(path, out, **meta_changes):
    data = dict(np.load(path, allow_pickle=False))
    meta = json.loads(str(data.pop("__meta__")))
    meta.update(meta_changes)
    np.savez(out, __meta__=json.dumps(meta), **data)


def test_bad_files_raise(tmp_path):
    eng = _engine()
    path = tmp_path / "ok.npz"
    checkpoint.save_checkpoint(eng, path)
    _rewrite(path, tmp_path / "v2.npz", version=2)
    with pytest.raises(ValueError, match="version 2"):
        checkpoint.load_checkpoint(_engine(), tmp_path / "v2.npz")
    # a port file from another device type does not reseed silently
    _rewrite(path, tmp_path / "cuda.npz", device="cuda")
    with pytest.raises(ValueError, match="cuda"):
        checkpoint.load_checkpoint(_engine(), tmp_path / "cuda.npz")
