"""Parity of the port's measurement and motion models with the JAX
package on the CPU.

Tolerances and why:
* ``likelihood_measure``: the same tier id in each regime (0 grouped,
  1 per-point box, 2 gather), and scores bit-equal on every particle
  whose queries are not within 1e-4 cell of a .5 rounding boundary
  (XLA:CPU contracts ``a*b + c`` into FMA, eager torch does not; such a
  query may take the other cell).  Particles rescored by a sum over the
  points axis (tier 2, and the overflow bin of tier 0) are held to rtol
  1e-6: XLA and torch add the K terms in another order.
* ``beam_measure_grouped``: rtol 1e-6 outside boundary particles, i.e.
  the same penalized-beam counts (``per_beam ** n`` may differ by an ulp).
* the sphere-traced fallback ``raycast_df``: >= 99% of particles agree to
  rtol 1e-6; the adaptive step ``(d - r) / |W u|`` accumulates f32
  rounding along the ray, so a probe can cross a cell edge on one side
  only.
* motion and IMU models: atol 2e-6 / rtol 1e-5 (f32 chains with FMA and
  transcendental ulps).
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mcl_3dl_tpu.math import quat as jq
from mcl_3dl_tpu.models import beam as jbeam
from mcl_3dl_tpu.models import likelihood as jlike
from mcl_3dl_tpu.models import motion as jmotion
from mcl_3dl_tpu.models.imu_gravity import imu_gravity_likelihood as j_imu
from mcl_3dl_tpu.models.samplers import sample_uniform as j_sample_uniform
from mcl_3dl_tpu.map.distance_field import build_distance_field

from mcl_3dl_tpu_torch import convert
from mcl_3dl_tpu_torch.math import quat as tq
from mcl_3dl_tpu_torch.models import beam as tbeam
from mcl_3dl_tpu_torch.models import likelihood as tlike
from mcl_3dl_tpu_torch.models import motion as tmotion
from mcl_3dl_tpu_torch.models.imu_gravity import imu_gravity_likelihood
from mcl_3dl_tpu_torch.models.samplers import sample_uniform
from mcl_3dl_tpu_torch.ops import grouped as og

torch.set_num_threads(2)   # several test workers share the CPU

MDM, MDF, MW = 0.2, 0.05, 5.0
WINDOW = 1e-4


def _t(a, dtype=np.float32):
    return torch.as_tensor(np.array(a, dtype))


def _world(seed=5):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3.0, 3.0, (300, 3))
    jdf = build_distance_field(pts, 0.1, 0.6, weights=(1.0, 1.0, 2.0))
    tdf = convert.distance_field(np.asarray(jdf.field), np.asarray(jdf.origin),
                                 jdf.cell, jdf.trunc, jdf.weights)
    return rng, jdf, tdf


def _particles(rng, n, sxy, syaw, satt=0.02, sz=0.04):
    pos = np.stack([rng.normal(0, sxy, n), rng.normal(0, sxy, n),
                    rng.normal(0, sz, n)], axis=1).astype(np.float32)
    rpy = np.stack([rng.normal(0, satt, n), rng.normal(0, satt, n),
                    rng.normal(0, syaw, n)], axis=1).astype(np.float32)
    rot = np.asarray(jq.from_rpy(jnp.asarray(rpy)), np.float32)
    return pos, rot


def _boundary(df, pos, rot, pts):
    """Particles with a cell-space query within WINDOW of a .5 rounding
    boundary, for the raw and the 2^-16 fixed-point points, in float64."""
    r = np.asarray(jq.rotation_matrix(jq.normalize(jnp.asarray(rot))), np.float64)
    w = np.asarray(df.weights, np.float64)
    org = np.asarray(df.origin, np.float64)
    mask = np.zeros(pos.shape[0], bool)
    p_fp = np.round(np.asarray(pts, np.float32) * 65536.0).astype(np.int32) / 65536.0
    for p in (np.asarray(pts, np.float64), p_fp):
        q = np.einsum("nij,kj->nki", r, p) + pos[:, None, :]
        u = (q * w - org) / df.cell
        mask |= (np.abs(u - np.floor(u) - 0.5) < WINDOW).any(axis=(1, 2))
    return mask


# regime -> (particle spreads, expected tier)
REGIMES = {
    "grouped": (dict(sxy=0.04, syaw=0.1), 0),
    "box": (dict(sxy=0.3, syaw=0.02, satt=0.005, sz=0.005), 1),
    "gather": (dict(sxy=1.0, syaw=0.5), 2),
}


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_likelihood_measure_tiers_match_jax(regime):
    rng, jdf, tdf = _world()
    spread, tier = REGIMES[regime]
    n = 2 * og.TILE
    pos, rot = _particles(rng, n, **spread)
    pts = rng.uniform(-1.5, 1.5, (8, 3)).astype(np.float32)
    valid = rng.uniform(size=8) < 0.9
    jl, jq_, jtier = jlike.likelihood_measure(
        jdf, jnp.asarray(pos), jnp.asarray(rot), jnp.asarray(pts),
        jnp.asarray(valid), MDM, MDF, MW, trilinear=False, local_kernel=True,
        with_info=True)
    tl, tq_, ttier = tlike.likelihood_measure(
        tdf, _t(pos), _t(rot), _t(pts), _t(valid, bool), MDM, MDF, MW)
    assert int(jtier) == ttier == tier
    ok = ~_boundary(jdf, pos, rot, pts)
    assert ok.mean() > 0.9
    got, want = tl.numpy()[ok], np.asarray(jl)[ok]
    if tier == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert np.mean(got == want) > 0.95
    np.testing.assert_array_equal(tq_.numpy()[ok], np.asarray(jq_)[ok])
    assert float(tq_.sum()) > 0


def _beam_inputs(rng):
    scan = rng.uniform(-1.5, 1.5, (3, 3)).astype(np.float32)
    labels = np.zeros(3, np.int64)
    valid = np.ones(3, bool)
    origins = np.zeros((1, 3), np.float32)
    return scan, labels, valid, origins


BEAM_KW = dict(map_grid_min=0.1, map_grid_max=0.1, hit_range=0.3,
               beam_likelihood_min=0.2, num_points_default=3,
               sin_total_ref=math.sin(math.pi / 6.0),
               add_penalty_short_only_mode=False)


def test_beam_measure_grouped_matches_jax():
    rng, jdf, tdf = _world(9)
    n = 2 * og.TILE
    pos, rot = _particles(rng, n, sxy=0.04, syaw=0.1)
    scan, labels, valid, origins = _beam_inputs(rng)
    num_steps = 20
    jlik, jtier = jbeam.beam_measure_grouped(
        jdf, jnp.asarray(pos), jnp.asarray(rot), jnp.asarray(scan),
        jnp.asarray(labels, jnp.int32), jnp.asarray(valid),
        jnp.asarray(origins), num_steps=num_steps,
        active=jnp.ones(n, bool), fallback=lambda: jnp.zeros(n),
        with_info=True, **BEAM_KW)
    assert int(jtier) == 0
    tpos, trot = _t(pos), _t(rot)
    rmat = tq.rotation_matrix(tq.normalize(trot))
    stats = og.group_stats(tpos, rmat, trot, tdf.weights, tdf.cell, tdf.origin,
                           torch.ones(n, dtype=torch.bool))
    vp = tbeam.BeamVirtualPoints(_t(scan), _t(labels, np.int64), _t(valid, bool),
                                 _t(origins), 0.1, 0.3, num_steps)
    lo, fits = og.group_boxes(stats, vp.vpf, tdf.shape)
    assert bool((fits | ~vp.chainf[:, None]).all())
    layout = og.build_layout(stats, og.default_overflow_cap(n))
    tlik = tbeam.beam_measure_grouped(
        tdf, tpos, trot, _t(scan), _t(labels, np.int64), _t(valid, bool),
        _t(origins), num_steps=num_steps,
        grouped=(stats, layout, lo, True, vp), **BEAM_KW)
    probes = np.asarray(vp.vpf)
    ok = ~_boundary(jdf, pos, rot, probes)
    assert ok.mean() > 0.8
    np.testing.assert_allclose(tlik.numpy()[ok], np.asarray(jlik)[ok], rtol=1e-6)
    assert float(tlik.min()) < 1.0       # some beams are penalized


def test_raycast_df_fallback_matches_jax():
    rng, jdf, tdf = _world(11)
    n = 512
    pos, rot = _particles(rng, n, sxy=0.3, syaw=0.5)
    scan, labels, valid, origins = _beam_inputs(rng)
    jlik, _, jstatus = jbeam.beam_measure(
        jdf, None, jnp.asarray(pos), jnp.asarray(rot), jnp.asarray(scan),
        jnp.asarray(labels, jnp.int32), jnp.asarray(valid),
        jnp.asarray(origins), use_dda=False, filter_label_max=0xFFFFFFFF,
        num_steps=24, **BEAM_KW)
    tlik, tstatus = tbeam.beam_measure(
        tdf, _t(pos), _t(rot), _t(scan), _t(labels, np.int64), _t(valid, bool),
        _t(origins), num_steps=24, **BEAM_KW)
    close = np.isclose(tlik.numpy(), np.asarray(jlik), rtol=1e-6, atol=0)
    assert close.mean() >= 0.99, close.mean()
    assert np.mean(tstatus.numpy() == np.asarray(jstatus)) >= 0.99
    assert len(np.unique(np.asarray(jstatus))) > 1


def test_motion_imu_sampler_match_jax():
    rng = np.random.default_rng(13)
    n = 256
    pos, rot = _particles(rng, n, sxy=0.5, syaw=0.5)
    noise = rng.normal(0, 0.05, (n, 4)).astype(np.float32)
    from mcl_3dl_tpu.state import ParticleState as JPS

    fields = dict(pos=pos, rot=rot, odom_err_lin=pos * 0.1,
                  odom_err_ang=pos * 0.2, noise=noise,
                  prob=np.full(n, 1.0 / n, np.float32),
                  prob_bias=np.ones(n, np.float32))
    js = JPS(**{k: jnp.asarray(v) for k, v in fields.items()},
             n_active=jnp.int32(n))
    ts = convert.particle_state(**fields, n_active=n)
    p0, p1 = np.zeros(3, np.float32), np.array([0.3, 0.1, 0.0], np.float32)
    r0 = np.array([0, 0, 0, 1], np.float32)
    r1 = np.asarray(jq.from_rpy(jnp.asarray([0.0, 0.0, 0.2])), np.float32)
    jd = jmotion.OdomDelta.from_poses(jnp.asarray(p0), jnp.asarray(r0),
                                      jnp.asarray(p1), jnp.asarray(r1), 0.1)
    td = tmotion.OdomDelta.from_poses(p0, r0, p1, r1, 0.1)
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)
    js2 = jmotion.predict_differential_drive(js, jd, 10.0, 10.0)
    ts2 = tmotion.predict_differential_drive(ts, td, 10.0, 10.0)
    for a, b in zip(ts2[:5], js2[:5]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)

    acc = np.array([0.05, -0.02, 1.0], np.float32)
    acc /= np.linalg.norm(acc)
    np.testing.assert_allclose(
        imu_gravity_likelihood(_t(rot), _t(acc), math.pi / 4).numpy(),
        np.asarray(j_imu(jnp.asarray(rot), jnp.asarray(acc), math.pi / 4)),
        rtol=1e-5)

    cloud = rng.normal(size=(64, 3)).astype(np.float32)
    keep = rng.uniform(size=64) < 0.5
    from jax import random

    jpts, jok, jidx = j_sample_uniform(random.PRNGKey(2), jnp.asarray(cloud),
                                       jnp.asarray(keep), 16)
    assert keep[np.asarray(jidx)].all()
    tpts, tok, _ = sample_uniform(_t(cloud), _t(keep, bool),
                                  _t(np.asarray(jidx), np.int64))
    np.testing.assert_array_equal(tpts.numpy(), np.asarray(jpts))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
