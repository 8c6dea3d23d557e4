"""The single-robot services of the port against the JAX engine on the
CPU: landmark, map update, the inspection calls, the match-cloud
throttle, the beam status in both raycast modes, and PCD I/O.

Tolerances and why:
* ``landmark``: with JAX's resample draws injected, particles and
  weights within 1e-5 (the Gaussian's ``exp`` and the weight sums in two
  libraries; the systematic comb picks the same particles);
* ``update_map``: the merged map's points equal, its ``df`` (field and
  corner pack) and occupancy grid byte-equal (JAX's native builders
  switched off);
* ``get_particles``: positions and weights equal, rotations to 2.5e-7
  (an ulp or two of a unit quaternion, normalized in two libraries);
  ``diagnostics`` equal;
* ``classify_cloud``: masks equal on points whose trilinear distance is
  not within 1e-5 of a threshold and whose cell coordinate is not within
  1e-4 of a cell face (``test_torch_trilinear.py``);
* the throttle: the callback fires at the same stamps;
* ``debug_beam_status``: statuses equal on at least 95% of beams in each
  mode (the sphere trace accumulates f32 steps along the ray,
  ``test_torch_models.py``; the DDA march may take the other voxel at a
  face, ``test_torch_dda.py``);
* PCD: the port writes the bytes JAX's ``write_pcd`` writes (binary and
  ascii), and each package reads the other's file back equal.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mcl_3dl_tpu.map.native as jnative
from mcl_3dl_tpu import MCL3DL as JMCL3DL
from mcl_3dl_tpu.config import Params as JParams
from mcl_3dl_tpu.io import pcd as jpcd
from mcl_3dl_tpu.math import quat as jq
from mcl_3dl_tpu.math.nd import NormalLikelihoodNd as JNd

from mcl_3dl_tpu_torch import MCL3DL, convert, worlds
from mcl_3dl_tpu_torch.io import pcd as tpcd
from mcl_3dl_tpu_torch.math import quat as tq
from mcl_3dl_tpu_torch.math.nd import NormalLikelihoodNd
from mcl_3dl_tpu_torch.status import ConvergenceStatus, ErrorCode

torch.set_num_threads(2)   # several test workers share the CPU

IDENT = np.array([0.0, 0.0, 0.0, 1.0])
ORIGIN = np.array([[0.0, 0.0, worlds.SENSOR_Z]], np.float32)


def _params(**kw):
    jp = JParams(num_particles=256, use_beam_model=False, **kw)
    jp = dataclasses.replace(jp, likelihood=dataclasses.replace(
        jp.likelihood, num_points=8))
    return jp, convert.params(dataclasses.asdict(jp))


def _pair(**kw):
    """A JAX and a port engine on the flagship map (JAX's native builders
    off), the port's particles set to the JAX engine's."""
    jp, tp = _params(**kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "build_distance_field_native", lambda *a, **k: None)
        mp.setattr(jnative, "build_occupancy_rep_native", lambda *a, **k: None)
        eng_j = JMCL3DL(jp)
        eng_j.load_map(worlds.world_map())
    eng = MCL3DL(tp, device="cpu")
    eng.load_map(worlds.world_map())
    eng.pstate = convert.particle_state(*(np.asarray(x) for x in eng_j.pstate))
    return eng_j, eng


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_landmark_matches_jax(pair):
    eng_j, eng = pair
    rng = np.random.default_rng(0)
    cov = np.diag(rng.uniform(0.01, 0.05, 6) ** 2)
    mpos = np.float32([0.05, -0.03, 0.01])
    mrot = np.asarray(jq.from_rpy(jnp.float32([0.01, 0.0, 0.05])))
    key = jax.random.PRNGKey(3)
    nd = JNd(cov)
    js = jax.jit(eng_j._landmark_step)(
        eng_j.pstate, key, jnp.asarray(mpos), jnp.asarray(mrot),
        jnp.asarray(nd.a, jnp.float32), nd.sigma_inv)
    key_u, key_n = jax.random.split(key)
    cap = eng.pstate.capacity
    ts = eng.landmark_step(
        eng.pstate, torch.as_tensor(mpos), torch.as_tensor(mrot),
        NormalLikelihoodNd(cov),
        torch.as_tensor(np.asarray(jax.random.uniform(key_u, (), jnp.float32))),
        torch.as_tensor(np.asarray(jax.random.normal(key_n, (cap, 6)))))
    for name in ("pos", "rot", "prob", "odom_err_lin", "noise"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), atol=1e-5,
                                   err_msg=name)
    assert int(ts.n_active) == int(js.n_active)
    # the update moved the particles toward the landmark
    assert not np.allclose(ts.pos.numpy(), eng.pstate.pos.numpy())


def test_landmark_service_pulls_toward_the_measured_pose():
    _, eng = _pair()
    before = float(torch.linalg.vector_norm(
        eng.pstate.pos.mean(0) - torch.tensor([0.3, 0.0, 0.0])))
    eng.landmark(np.array([0.3, 0.0, 0.0]), IDENT, np.diag([0.02 ** 2] * 6))
    after = float(torch.linalg.vector_norm(
        eng.pstate.pos.mean(0) - torch.tensor([0.3, 0.0, 0.0])))
    assert after < before


def test_update_map_matches_jax():
    eng_j, eng = _pair()
    rng = np.random.default_rng(1)
    wall = np.stack([rng.uniform(-0.5, 0.5, 300), np.full(300, 4.6),
                     rng.uniform(0.0, 1.0, 300)], axis=1)
    labels = rng.integers(0, 3, 300).astype(np.uint32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "build_distance_field_native", lambda *a, **k: None)
        mp.setattr(jnative, "build_occupancy_rep_native", lambda *a, **k: None)
        jm = eng_j.update_map(wall, labels)
    old_shape = eng.map.df.shape
    tm = eng.update_map(wall, labels)
    assert tm is eng.map and tm.df.shape != old_shape      # the grid grew
    np.testing.assert_array_equal(tm.points, jm.points)
    np.testing.assert_array_equal(tm.labels, jm.labels)
    np.testing.assert_array_equal(tm.df.field.numpy(), np.asarray(jm.df.field))
    np.testing.assert_array_equal(tm.df.field2d.numpy(),
                                  np.asarray(jm.df.field2d))
    np.testing.assert_array_equal(tm.df.packed.numpy().view(np.uint32),
                                  np.asarray(jm.df.packed))
    np.testing.assert_array_equal(tm.occ.occupied.numpy(),
                                  np.asarray(jm.occ.occupied))
    np.testing.assert_array_equal(tm.occ.rep_point.numpy(),
                                  np.asarray(jm.occ.rep_point))
    np.testing.assert_array_equal(tm.occ.min_label.numpy().astype(np.uint32),
                                  np.asarray(jm.occ.min_label))
    np.testing.assert_array_equal(tm.occ.origin.numpy(),
                                  np.asarray(jm.occ.origin))
    # the engine measures on the new map
    res = eng.measure_direct(worlds.scan(rng, 256), ORIGIN,
                             np.zeros(256, np.int32), 0.1)
    assert np.isfinite(res.pos).all()


def test_get_particles_and_diagnostics_match_jax(pair):
    eng_j, eng = pair
    for got, want, atol in zip(eng.get_particles(), eng_j.get_particles(),
                               (0.0, 2.5e-7, 0.0)):
        assert got.dtype == np.asarray(want).dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)
    for error, conv in ((ErrorCode.NORMAL, ConvergenceStatus.NORMAL),
                        (ErrorCode.POINTS_NOT_FOUND, ConvergenceStatus.NORMAL),
                        (ErrorCode.NORMAL, ConvergenceStatus.LARGE_STD_VALUE)):
        for e in (eng_j, eng):
            e.status.error, e.status.convergence_status = error, conv
        assert dataclasses.asdict(eng.diagnostics()) == dataclasses.asdict(
            eng_j.diagnostics())
    eng.status.error = ErrorCode.NORMAL
    eng.status.convergence_status = ConvergenceStatus.NORMAL


def test_classify_cloud_matches_jax(pair):
    eng_j, eng = pair
    rng = np.random.default_rng(2)
    pts = worlds.scan(rng, 2048).astype(np.float32)
    pts += rng.normal(0, 0.2, pts.shape).astype(np.float32)
    pos = np.float32([0.03, -0.02, 0.01])
    rot = np.asarray(jq.from_rpy(jnp.float32([0.0, 0.0, 0.03])))
    matched, unmatched = eng.classify_cloud(pts, pos, rot)
    jm, ju = eng_j.classify_cloud(pts, pos, rot)
    q = np.asarray(jq.rotate(jnp.asarray(rot), jnp.asarray(pts))) + pos
    d = np.asarray(eng_j.map.df.sample_trilinear(jnp.asarray(q)))
    p = eng.params
    u = (q.astype(np.float64) * np.asarray(eng_j.map.df.weights)
         - np.asarray(eng_j.map.df.origin, np.float64)) / eng_j.map.df.cell
    ok = ((np.abs(d - p.match_output_dist) > 1e-5)
          & (np.abs(d - p.unmatch_output_dist) > 1e-5)
          & ~(np.abs(u - np.round(u)) < 1e-4).any(axis=1))
    assert ok.mean() > 0.99
    np.testing.assert_array_equal(matched[ok], np.asarray(jm)[ok])
    np.testing.assert_array_equal(unmatched[ok], np.asarray(ju)[ok])
    assert matched.sum() > 100 and unmatched.sum() > 100


STAMPS = (0.1, 0.2, 0.25, 0.31, 0.4, 0.45, 0.7, 0.5, -0.9, -0.85, -0.5)


def test_match_cloud_throttle_fires_at_the_same_stamps():
    """``match_output_interval_interval`` 0.2 s: 0.1 fires, 0.2 and 0.25
    do not, 0.31 fires, ...; 0.5 after 0.7 is a small backward step (no
    fire), -0.9 is more than 1 s back (re-armed)."""
    eng_j, eng = _pair(match_output_interval_interval=0.2)
    fired = {}
    rng = np.random.default_rng(4)
    scans = [worlds.scan(rng, 128) for _ in STAMPS]
    for name, e in (("jax", eng_j), ("port", eng)):
        calls = []
        e.on_match_clouds = lambda t, m, u, calls=calls: calls.append(
            (t, m.shape[1], u.shape[1]))
        for t, scan in zip(STAMPS, scans):
            e.measure_direct(scan, ORIGIN, np.zeros(len(scan), np.int32), t)
        fired[name] = calls
    stamps = [c[0] for c in fired["port"]]
    assert stamps == [c[0] for c in fired["jax"]]
    assert stamps == [0.1, 0.31, 0.7, -0.9, -0.5]
    assert all(c[1] == 3 and c[2] == 3 for c in fired["port"])


@pytest.mark.parametrize("dda", [False, True], ids=["df", "dda"])
def test_debug_beam_status_matches_jax(dda):
    jp, tp = _params()
    jp = dataclasses.replace(jp, beam=dataclasses.replace(
        jp.beam, use_raycast_using_dda=dda))
    tp = convert.params(dataclasses.asdict(jp))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "build_distance_field_native", lambda *a, **k: None)
        mp.setattr(jnative, "build_occupancy_rep_native", lambda *a, **k: None)
        eng_j = JMCL3DL(jp)
        eng_j.load_map(worlds.world_map())
    eng = MCL3DL(tp, device="cpu")
    eng.load_map(worlds.world_map())
    rng = np.random.default_rng(5)
    pts = worlds.scan(rng, 256).astype(np.float32)
    pts[::4] += rng.normal(0, 0.5, pts[::4].shape).astype(np.float32)
    pos = np.float32([0.05, 0.02, 0.0])
    rot = np.asarray(jq.from_rpy(jnp.float32([0.0, 0.0, 0.04])))
    idx = np.zeros(len(pts), np.int64)
    got = eng.debug_beam_status(pos, rot, pts, idx, ORIGIN)
    want = np.asarray(eng_j.debug_beam_status(pos, rot, pts, idx, ORIGIN))
    assert got.shape == want.shape == (len(pts),)
    assert np.mean(got == want) >= 0.95
    assert len(np.unique(want)) >= 2


def _cloud(rng, n=50):
    return (rng.normal(size=(n, 3)).astype(np.float32),
            {"intensity": rng.uniform(size=n).astype(np.float32),
             "label": rng.integers(0, 9, n).astype(np.uint32)})


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_pcd_bytes_and_cross_reads(tmp_path, binary):
    pts, attrs = _cloud(np.random.default_rng(6))
    tpath, jpath = tmp_path / "port.pcd", tmp_path / "jax.pcd"
    tpcd.write_pcd(tpath, pts, attrs, binary=binary)
    jpcd.write_pcd(jpath, pts, attrs, binary=binary)
    assert tpath.read_bytes() == jpath.read_bytes()
    for reader, path in ((tpcd.read_pcd, jpath), (jpcd.read_pcd, tpath)):
        got, got_attrs = reader(path)
        np.testing.assert_array_equal(got, pts)
        assert set(got_attrs) == set(attrs)
        np.testing.assert_array_equal(got_attrs["label"], attrs["label"])
        np.testing.assert_allclose(got_attrs["intensity"], attrs["intensity"],
                                   rtol=0 if binary else 1e-7)


def test_save_accumulated_pcd(tmp_path):
    jp, tp = _params(output_pcd=True)
    eng = MCL3DL(tp, device="cpu")
    eng.load_map(worlds.world_map())
    assert eng.save_accumulated_pcd(tmp_path / "none.pcd") == 0
    rng = np.random.default_rng(7)
    n = 0
    for t in (0.1, 0.2, 0.3):
        res = eng.measure_direct(worlds.scan(rng, 256), ORIGIN,
                                 np.zeros(256, np.int32), t)
        n += len(eng._last_scan_base)
        assert np.isfinite(res.pos).all()
    path = tmp_path / "accum.pcd"
    assert eng.save_accumulated_pcd(path) == n
    pts, _ = tpcd.read_pcd(path)
    assert pts.shape == (n, 3)
    # the last scan, moved by the published pose
    last = eng._last_scan_base
    moved = tq.rotate(torch.as_tensor(res.rot),
                      torch.as_tensor(last, dtype=torch.float32))
    np.testing.assert_allclose(pts[-len(last):],
                               (moved + torch.as_tensor(res.pos)).numpy(),
                               atol=1e-6)
