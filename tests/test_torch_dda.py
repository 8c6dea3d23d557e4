"""The occupancy grid and the DDA raycast of the port against the JAX
package on the CPU, and the label-transparent wall of
``tests/test_beam_label.py`` through the port.

Tolerances and why:
* the occupancy grid: equal value for value to the JAX package's numpy
  build (its native builder switched off): ``occupied`` and
  ``rep_point`` byte-equal, ``min_label`` equal as uint32 (the port holds
  it as int64), ``origin`` equal;
* ``raycast_occ``: hit flags equal and collision points within 1e-6 m
  (a representative's offset ``q / 255`` is a division in the port and
  may be a reciprocal multiply in XLA: an ulp of the coordinate) on at
  least 99% of rays, and every ray that differs is a boundary ray, found in
  float64: a probe within 1e-4 cell of a voxel face (the voxel index is
  ``floor((p - origin) / cell)``, where JAX may divide by a reciprocal
  multiply and contract ``begin + dir * t`` into an FMA) or a
  representative point whose perpendicular test lies within 1e-5 m^2 of
  its threshold;
* ``beam_measure(use_dda=True)``: statuses equal on the rays that are not
  boundary rays; likelihoods rtol 1e-6 on particles without one.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mcl_3dl_tpu.map.native as jnative
from mcl_3dl_tpu.config import Params as JParams
from mcl_3dl_tpu.map.map_data import MapData as JMapData
from mcl_3dl_tpu.map.occupancy import build_occupancy_grid as j_build_occ
from mcl_3dl_tpu.math import quat as jq
from mcl_3dl_tpu.models import beam as jbeam

from mcl_3dl_tpu_torch import convert, worlds
from mcl_3dl_tpu_torch.config import BeamParams, Params
from mcl_3dl_tpu_torch.map.map_data import MapData
from mcl_3dl_tpu_torch.map.occupancy import REP_POINTS, build_occupancy_arrays
from mcl_3dl_tpu_torch.math import quat as tq
from mcl_3dl_tpu_torch.models import beam as tbeam
from mcl_3dl_tpu_torch.models.beam import BeamStatus

torch.set_num_threads(2)   # several test workers share the CPU

FACE = 1e-4
PERP = 1e-5
HIT, DDA_CELL = 0.3, 0.2


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(jnative, "build_occupancy_rep_native",
                        lambda *a, **k: None)
    monkeypatch.setattr(jnative, "build_distance_field_native",
                        lambda *a, **k: None)


def _labelled_points(seed):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([worlds.world_map(),
                          rng.uniform(-3.0, 3.0, (500, 3))])
    return pts, rng.integers(0, 20, len(pts)).astype(np.uint32)


@pytest.mark.parametrize("world", ["flagship", "labelled", "empty"])
def test_occupancy_grid_equals_numpy_build(no_native, world):
    if world == "flagship":
        pts, labels = worlds.world_map(), None
    elif world == "labelled":
        pts, labels = _labelled_points(1)
    else:
        pts, labels = np.zeros((0, 3)), None
    jocc = j_build_occ(pts, DDA_CELL, labels)
    occupied, min_label, rep, origin = build_occupancy_arrays(pts, DDA_CELL,
                                                              labels)
    np.testing.assert_array_equal(occupied, np.asarray(jocc.occupied))
    assert min_label.dtype == np.uint32
    np.testing.assert_array_equal(min_label, np.asarray(jocc.min_label))
    assert rep.dtype == np.uint8 and rep.shape[-2:] == (REP_POINTS, 3)
    np.testing.assert_array_equal(rep, np.asarray(jocc.rep_point))
    np.testing.assert_array_equal(np.float32(origin), np.asarray(jocc.origin))
    # the device container holds the same values
    tocc = convert.occupancy_grid(occupied, min_label, rep, origin, DDA_CELL)
    assert tocc.min_label.dtype == torch.int64
    np.testing.assert_array_equal(tocc.min_label.numpy().astype(np.uint32),
                                  np.asarray(jocc.min_label))
    np.testing.assert_array_equal(tocc.occupied.numpy(),
                                  np.asarray(jocc.occupied))


def test_map_data_builds_the_occupancy_grid(no_native):
    pts, labels = _labelled_points(2)
    jm = JMapData.build(pts, JParams(), labels)
    tm = MapData.build(pts, Params(), labels, device="cpu")
    np.testing.assert_array_equal(tm.occ.occupied.numpy(),
                                  np.asarray(jm.occ.occupied))
    np.testing.assert_array_equal(tm.occ.rep_point.numpy(),
                                  np.asarray(jm.occ.rep_point))
    np.testing.assert_array_equal(
        tm.occ.min_label.numpy().astype(np.uint32),
        np.asarray(jm.occ.min_label))
    assert tm.occ.cell == jm.occ.cell


def _rays(seed, n=512, beams=8):
    """Rays of ``n`` particles around the origin to ``beams`` scan points
    of the flagship world: ``(pos, rot, pts, begins, ends)``, f32."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.normal(0, 0.2, n), rng.normal(0, 0.2, n),
                    rng.normal(0, 0.05, n)], axis=1).astype(np.float32)
    rpy = np.stack([rng.normal(0, 0.03, n), rng.normal(0, 0.03, n),
                    rng.normal(0, 0.2, n)], axis=1).astype(np.float32)
    rot = np.asarray(jq.from_rpy(jnp.asarray(rpy)), np.float32)
    pts = worlds.scan(rng, beams).astype(np.float32)
    r = np.asarray(jq.rotation_matrix(jq.normalize(jnp.asarray(rot))))
    ends = (np.einsum("bj,nij->nbi", pts, r) + pos[:, None, :]).astype(np.float32)
    org = np.array([0.0, 0.0, worlds.SENSOR_Z], np.float32)
    begins = (np.einsum("j,nij->ni", org, r) + pos)[:, None, :]
    begins = np.broadcast_to(begins, ends.shape).astype(np.float32)
    return pos, rot, pts, begins, ends


def _boundary_rays(jocc, begins, ends, num_steps, rah, mdts):
    """Rays [...] with a probe within FACE of a voxel face, or a
    representative point (of an occupied voxel along them) whose squared
    perpendicular distance lies within PERP of its threshold, in
    float64."""
    b = np.asarray(begins, np.float64)
    seg = np.asarray(ends, np.float64) - b
    length = np.linalg.norm(seg, axis=-1)
    d = seg / np.maximum(length, 1e-12)[..., None]
    org = np.asarray(jocc.origin, np.float64)
    cell = jocc.cell
    occupied = np.asarray(jocc.occupied)
    rep = np.asarray(jocc.rep_point).reshape(-1, REP_POINTS, 3) / 255.0
    dims = np.array(occupied.shape)
    out = np.zeros(length.shape, bool)
    u_b = (b - org) / cell
    out |= (np.abs(u_b - np.round(u_b)) < FACE).any(-1)
    for s in range(num_steps):
        t = (s + 1) * cell * 0.5
        live = t < length + HIT
        u = (b + d * t - org) / cell
        out |= live & (np.abs(u - np.round(u)) < FACE).any(-1)
        idx = np.floor(u).astype(np.int64)
        inside = ((idx >= 0) & (idx < dims)).all(-1)
        ic = np.clip(idx, 0, dims - 1)
        flat = (ic[..., 0] * dims[1] + ic[..., 1]) * dims[2] + ic[..., 2]
        occ = occupied.reshape(-1)[flat] & inside & live
        rp = org + (ic[..., None, :] + rep[flat]) * cell       # [..., R, 3]
        rel = rp - b[..., None, :]
        foot = np.abs(np.sum(rel * d[..., None, :], -1))
        thr = np.maximum((rah * foot) ** 2, mdts)
        perp = np.sum(rel * rel, -1) - foot * foot
        out |= occ & (np.abs(perp - thr) < PERP).any(-1)
    return out


def _occ_pair():
    pts = worlds.world_map()
    jocc = j_build_occ(pts, DDA_CELL)
    tocc = convert.occupancy_grid(
        np.asarray(jocc.occupied), np.asarray(jocc.min_label),
        np.asarray(jocc.rep_point), np.asarray(jocc.origin), jocc.cell)
    return jocc, tocc


@pytest.mark.parametrize("refine", [True, False], ids=["perp", "voxel"])
def test_raycast_occ_matches_jax(no_native, refine):
    jocc, tocc = _occ_pair()
    p = Params()
    rah, mdts = ((p.beam.ray_angle_half, p.min_dist_thr_sq) if refine
                 else (0.0, 0.0))
    _, _, _, begins, ends = _rays(3)
    steps = int(np.ceil((p.beam.clip_far + HIT) / (DDA_CELL * 0.5))) + 2
    found, cpos, sin_ang = tbeam.raycast_occ(
        tocc, torch.as_tensor(begins), torch.as_tensor(ends), HIT,
        0xFFFFFFFF, steps, ray_angle_half=rah, min_dist_thr_sq=mdts)
    jfound, jcpos, jsin = jbeam.raycast_occ(
        jocc, jnp.asarray(begins), jnp.asarray(ends), HIT, 0xFFFFFFFF, steps,
        ray_angle_half=rah, min_dist_thr_sq=mdts)
    found, cpos = found.numpy(), cpos.numpy()
    jfound, jcpos = np.asarray(jfound), np.asarray(jcpos)
    same = (found == jfound) & np.all(np.abs(cpos - jcpos) <= 1e-6, axis=-1)
    assert same.mean() >= 0.99, same.mean()
    boundary = _boundary_rays(jocc, begins, ends, steps, rah, mdts)
    assert not (~same & ~boundary).any(), np.argwhere(~same & ~boundary)
    np.testing.assert_array_equal(sin_ang.numpy(), np.asarray(jsin))
    assert 0.2 < found.mean() < 1.0        # hits and misses both present


def test_beam_measure_dda_matches_jax(no_native):
    jocc, tocc = _occ_pair()
    p = Params()
    bp = p.beam
    pos, rot, pts, begins, ends = _rays(4, beams=3)
    steps = int(np.ceil((bp.clip_far + HIT) / (DDA_CELL * 0.5))) + 2
    kw = dict(map_grid_min=0.1, map_grid_max=0.1, hit_range=HIT,
              beam_likelihood_min=0.2, num_points_default=3,
              sin_total_ref=float(np.sin(bp.ang_total_ref)),
              add_penalty_short_only_mode=False, num_steps=steps,
              filter_label_max=bp.filter_label_max,
              ray_angle_half=bp.ray_angle_half,
              min_dist_thr_sq=p.min_dist_thr_sq)
    origins = np.array([[0.0, 0.0, worlds.SENSOR_Z]], np.float32)
    valid = np.ones(3, bool)
    lik, status = tbeam.beam_measure(
        None, torch.as_tensor(pos), torch.as_tensor(rot), torch.as_tensor(pts),
        torch.zeros(3, dtype=torch.int64), torch.as_tensor(valid),
        torch.as_tensor(origins), use_dda=True, occ=tocc, **kw)
    jlik, _, jstatus = jbeam.beam_measure(
        None, jocc, jnp.asarray(pos), jnp.asarray(rot), jnp.asarray(pts),
        jnp.zeros(3, jnp.int32), jnp.asarray(valid), jnp.asarray(origins),
        use_dda=True, **kw)
    boundary = _boundary_rays(jocc, begins, ends, steps, bp.ray_angle_half,
                              p.min_dist_thr_sq)
    ok_ray = ~boundary
    np.testing.assert_array_equal(status.numpy()[ok_ray],
                                  np.asarray(jstatus)[ok_ray])
    ok = ~boundary.any(axis=1)
    assert ok.mean() > 0.9
    np.testing.assert_allclose(lik.numpy()[ok], np.asarray(jlik)[ok],
                               rtol=1e-6)
    # DDA never reports total reflection (sin_angle is 1 on a hit)
    assert not (status.numpy() == BeamStatus.TOTAL_REFLECTION).any()
    assert len(np.unique(status.numpy())) >= 2


def _wall(x, half=3.0, grid=0.1):
    ys = np.arange(-half, half + grid / 2, grid)
    zs = np.arange(-1.0, 1.0 + grid / 2, grid)
    gy, gz = np.meshgrid(ys, zs, indexing="ij")
    return np.stack([np.full(gy.size, x), gy.ravel(), gz.ravel()], axis=1)


def _labelled_wall_world():
    """A real wall (label 0) at x = 3, a semi-transparent one (label 10)
    at x = 1.5 between it and the origin, and one behind (label 0)."""
    solid, ghost, back = _wall(3.0), _wall(1.5), _wall(-4.0)
    labels = np.concatenate([np.zeros(len(solid), np.uint32),
                             np.full(len(ghost), 10, np.uint32),
                             np.zeros(len(back), np.uint32)])
    return np.concatenate([solid, ghost, back]), labels


def _wall_status(params, use_dda):
    pts, labels = _labelled_wall_world()
    m = MapData.build(pts, params, labels, device="cpu", downsample=False)
    lik, status = tbeam.beam_measure(
        m.df_beam, torch.zeros((1, 3)), tq.identity()[None, :],
        torch.tensor([[3.0, 0.0, 0.0]]), torch.zeros(1, dtype=torch.int64),
        torch.ones(1, dtype=torch.bool), torch.zeros((1, 3)),
        use_dda=use_dda, occ=m.occ, map_grid_min=0.1, map_grid_max=0.1,
        hit_range=0.3, beam_likelihood_min=0.2, num_points_default=1,
        sin_total_ref=0.5, filter_label_max=params.beam.filter_label_max,
        add_penalty_short_only_mode=True, num_steps=64)
    return float(lik[0]), int(status[0, 0])


@pytest.mark.parametrize("use_dda", [True, False], ids=["dda", "df"])
def test_labelled_wall_is_transparent(use_dda):
    """tests/test_beam_label.py through the port: with filter_label_max 5
    the label-10 wall lets the ray through to the real wall (HIT); with
    the default every label blocks (SHORT)."""
    beam = BeamParams(filter_label_max=5, use_raycast_using_dda=use_dda)
    lik, status = _wall_status(dataclasses.replace(Params(), beam=beam),
                               use_dda)
    assert status == BeamStatus.HIT and abs(lik - 1.0) < 1e-6
    opaque = dataclasses.replace(
        Params(), beam=BeamParams(use_raycast_using_dda=use_dda))
    lik2, status2 = _wall_status(opaque, use_dda)
    assert status2 == BeamStatus.SHORT and abs(lik2 - 0.2) < 1e-6


def _raw_z_drive(make, params):
    """Ten measurements at the origin from the tracking spread: the raw
    z of each."""
    eng = make(params)
    eng.load_map(worlds.world_map())
    eng.initial_pose(np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]),
                     worlds.TRACKING_COV)
    rng = np.random.default_rng(0)
    zs, t = [], 0.0
    while len(zs) < 10:
        t += 0.1
        eng.odometry(np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]), t)
        res = eng.push_cloud("lidar", worlds.scan(rng, 512),
                             np.array([0.0, 0.0, worlds.SENSOR_Z]), t)
        if res is not None:
            zs.append(float(res.raw_pos[2]))
    return zs


def test_dda_beam_lifts_z_in_both_packages(no_native):
    """The DDA beam raises the estimate above the floor in the flagship
    world, in the JAX engine as in the port: a ray passes a floor voxel
    only farther than ``sqrt(min_dist_thr_sq)`` (0.17 m) from its points,
    so a floor ray of a raised pose ends later, short of fewer points.
    Ten scans at 1,024 particles: both raw z above 0.09 m and within
    0.03 m of each other (different random streams), under the 0.17 m
    bound; without the beam model the port's raw z stays under 0.02 m."""
    from mcl_3dl_tpu import MCL3DL as JMCL3DL
    from mcl_3dl_tpu_torch import MCL3DL

    jp = JParams(num_particles=1024)
    jp = dataclasses.replace(jp, beam=dataclasses.replace(
        jp.beam, use_raycast_using_dda=True))
    tp = convert.params(dataclasses.asdict(jp))
    jz = _raw_z_drive(JMCL3DL, jp)
    tz = _raw_z_drive(lambda p: MCL3DL(p, device="cpu"), tp)
    bound = float(np.sqrt(tp.min_dist_thr_sq))
    assert 0.09 < tz[-1] < bound and 0.09 < jz[-1] < bound, (tz, jz)
    assert abs(tz[-1] - jz[-1]) < 0.03, (tz, jz)
    no_beam = _raw_z_drive(lambda p: MCL3DL(p, device="cpu"),
                           dataclasses.replace(tp, use_beam_model=False))
    assert abs(no_beam[-1]) < 0.02, no_beam
