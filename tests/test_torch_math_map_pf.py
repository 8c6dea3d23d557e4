"""Parity of the port's math, map and particle-filter layers with the JAX
package on the CPU, on inputs made from numpy seeds.

Tolerances and why:
* quaternion, filter and Gaussian functions: atol 2e-6 — f32 elementwise
  chains, where XLA:CPU may contract ``a*b + c`` into FMA and the two
  libraries' sin/cos/atan2 may differ by an ulp;
* the u8 distance fields and their z-major views: byte-identical to the
  JAX package's numpy build (its native builder is switched off in the
  test: it may differ by one code, tests/test_native.py);
* ``sample_nearest``: equal except queries within 1e-4 cell of a .5
  rounding boundary (the same FMA contraction in ``q*w - origin``);
* weighted mean and covariance: rtol 1e-5 (sums over particles in
  another order);
* ``pf.measure``: rtol 1e-6; the systematic-resampling indices are
  identical when the weights are injected from JAX.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mcl_3dl_tpu.map.native as jnative
from mcl_3dl_tpu import pf as jpf
from mcl_3dl_tpu import state as jst
from mcl_3dl_tpu.config import Params as JParams
from mcl_3dl_tpu.map.map_data import MapData as JMapData
from mcl_3dl_tpu.math import filters as jmf
from mcl_3dl_tpu.math import nd as jnd
from mcl_3dl_tpu.math import quat as jq
from mcl_3dl_tpu.math import quat_np as jqn

from worlds import make_room

from mcl_3dl_tpu_torch import convert, pf, state as st, worlds
from mcl_3dl_tpu_torch.config import Params
from mcl_3dl_tpu_torch.map.map_data import MapData
from mcl_3dl_tpu_torch.math import cumsum, row_scan
from mcl_3dl_tpu_torch.math import filters as mf
from mcl_3dl_tpu_torch.math import nd
from mcl_3dl_tpu_torch.math import quat as tq
from mcl_3dl_tpu_torch.math import quat_np as tqn

torch.set_num_threads(2)   # several test workers share the CPU

ATOL = 2e-6


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_quat_functions_match_jax():
    rng = np.random.default_rng(0)
    q1, q2 = _quats(rng, 64), _quats(rng, 64)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    rpy = rng.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    pairs = [
        (tq.mul(_t(q1), _t(q2)), jq.mul(q1, q2)),
        (tq.inv(_t(q1)), jq.inv(jnp.asarray(q1))),
        (tq.rotate(_t(q1), _t(v)), jq.rotate(q1, v)),
        (tq.rotation_matrix(_t(q1)), jq.rotation_matrix(q1)),
        (tq.from_rpy(_t(rpy)), jq.from_rpy(rpy)),
        (tq.to_rpy(_t(q1)), jq.to_rpy(q1)),
        (tq.angle(_t(q1)), jq.angle(q1)),
        (tq.normalize(_t(q1 * 3.0)), jq.normalize(q1 * 3.0)),
        (tq.from_frame(_t(v), _t(v[::-1].copy())), jq.from_frame(v, v[::-1])),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    axis_t, ang_t = tq.to_axis_angle(_t(q1))
    axis_j, ang_j = jq.to_axis_angle(q1)
    np.testing.assert_allclose(axis_t.numpy(), np.asarray(axis_j), atol=1e-5)
    np.testing.assert_allclose(ang_t.numpy(), np.asarray(ang_j), atol=ATOL)
    ident = np.tile(np.array([0, 0, 0, 1], np.float32), (2, 1))
    np.testing.assert_array_equal(tq.to_axis_angle(_t(ident))[0].numpy(),
                                  [[0, 0, 1], [0, 0, 1]])
    qd = q1.astype(np.float64)
    np.testing.assert_array_equal(tqn.to_rpy(qd), jqn.to_rpy(qd))
    np.testing.assert_array_equal(tqn.mul(qd, qd[::-1]), jqn.mul(qd, qd[::-1]))


def test_filters_and_gaussians_match_jax():
    rng = np.random.default_rng(1)
    seq = rng.uniform(-4.0, 4.0, (20, 3)).astype(np.float32)
    for init_t, init_j in ((mf.lpf_init, jmf.lpf_init), (mf.hpf_init, jmf.hpf_init)):
        ft = init_t(16.0, torch.zeros(3), angle=True)
        fj = init_j(16.0, jnp.zeros(3), angle=True)
        for x in seq:
            ft, yt = mf.filter_step(ft, _t(x))
            fj, yj = jmf.filter_step(fj, jnp.asarray(x))
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
        ft = mf.filter_set(ft, _t(seq[0]))
        fj = jmf.filter_set(fj, jnp.asarray(seq[0]))
        np.testing.assert_allclose(ft.x.numpy(), np.asarray(fj.x), rtol=1e-6)
    x = rng.uniform(0, 3, 100).astype(np.float32)
    np.testing.assert_allclose(nd.normal_likelihood(_t(x), 0.7).numpy(),
                               np.asarray(jnd.normal_likelihood(x, 0.7)),
                               rtol=1e-6)
    cov = np.diag([0.5, 0.2, 0.1])
    pts = rng.normal(size=(10, 3)).astype(np.float32)
    np.testing.assert_allclose(nd.NormalLikelihoodNd(cov)(_t(pts)).numpy(),
                               np.asarray(jnd.NormalLikelihoodNd(cov)(pts)),
                               rtol=1e-5)


def _numpy_map(monkeypatch, points, params_j):
    monkeypatch.setattr(jnative, "build_distance_field_native",
                        lambda *a, **k: None)
    return JMapData.build(points, params_j)


@pytest.mark.parametrize("world", ["room", "room_fine", "flagship"])
def test_distance_field_bytes_match_numpy_build(monkeypatch, world):
    points, kw = {
        "room": (make_room(grid=0.15), {}),
        "room_fine": (make_room(-2.0, 2.0, -2.0, 2.0, grid=0.1,
                                with_ceiling=True),
                      dict(dist_weight_z=2.0, df_cell_size=0.05)),
        "flagship": (worlds.world_map(), {}),
    }[world]
    jm = _numpy_map(monkeypatch, points, JParams(**kw))
    tm = MapData.build(points, Params(**kw), device="cpu")
    np.testing.assert_array_equal(tm.points, jm.points)
    for tdf, jdf in ((tm.df, jm.df), (tm.df_beam, jm.df_beam)):
        assert tdf.field.dtype == torch.uint8
        np.testing.assert_array_equal(tdf.field.numpy(), np.asarray(jdf.field))
        np.testing.assert_array_equal(tdf.field2d.numpy(), np.asarray(jdf.field2d))
        np.testing.assert_array_equal(tdf.origin.numpy(), np.asarray(jdf.origin))
        assert (tdf.cell, tdf.trunc, tdf.weights) == (jdf.cell, jdf.trunc,
                                                      jdf.weights)

    # nearest sampling: equal away from .5 rounding boundaries
    rng = np.random.default_rng(2)
    q = rng.uniform(-6.0, 6.0, (4096, 3)).astype(np.float32)
    got = tm.df.sample_nearest(_t(q)).numpy()
    want = np.asarray(jm.df.sample_nearest(jnp.asarray(q)))
    u = ((q.astype(np.float64) * np.asarray(jm.df.weights)
          - np.asarray(jm.df.origin, np.float64)) / jm.df.cell)
    near = (np.abs(u - np.floor(u) - 0.5) < 1e-4).any(axis=1)
    assert near.mean() < 1e-3
    np.testing.assert_array_equal(got[~near], want[~near])


def test_convert_carries_jax_state():
    jp = JParams(num_particles=100, seed=3)
    tp = convert.params(dataclasses.asdict(jp))
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert convert.params({"num_points_beam": 5}).beam.num_points == 5
    js = jst.init_diagonal(jnp.asarray(np.uint32([0, 7])), 128, 100,
                           jnp.zeros(3), jnp.zeros(3), jnp.full(6, 0.1))
    ts = convert.particle_state(*(np.asarray(x) for x in js))
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jf = jmf.lpf_init(16.0, jnp.ones(3), angle=True)
    tf = convert.filter_state(*(np.asarray(x) for x in jf))
    np.testing.assert_array_equal(tf.angle.numpy(), np.asarray(jf.angle))


def _particles(seed, n=512, active=480):
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    rpy = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    rot = np.asarray(jq.from_rpy(rpy))
    prob = rng.uniform(0.1, 1.0, n).astype(np.float32)
    prob[active:] = 0.0
    prob /= prob.sum()
    fields = dict(pos=pos, rot=rot, odom_err_lin=pos * 0.1,
                  odom_err_ang=rpy * 0.1,
                  noise=rng.normal(size=(n, 4)).astype(np.float32),
                  prob=prob, prob_bias=rng.uniform(0.5, 1, n).astype(np.float32))
    js = jst.ParticleState(**{k: jnp.asarray(v) for k, v in fields.items()},
                           n_active=jnp.int32(active))
    ts = convert.particle_state(**fields, n_active=active)
    return rng, js, ts


def test_weighted_mean_and_covariance_match_jax():
    _, js, ts = _particles(4)
    jm_pos, jm_rot = jpf.expectation_biased(js)
    tm_pos, tm_rot = pf.expectation_biased(ts)
    np.testing.assert_allclose(tm_pos.numpy(), np.asarray(jm_pos), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tm_rot.numpy(), np.asarray(jm_rot), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pf.covariance(ts).numpy(),
                               np.asarray(jpf.covariance(js)), rtol=1e-5,
                               atol=1e-7)
    jmax, tmax = jpf.max_particle(js), pf.max_particle(ts)
    np.testing.assert_array_equal(tmax["pos"].numpy(), np.asarray(jmax["pos"]))


def test_measure_and_resample_match_jax():
    rng, js, ts = _particles(5)
    lik = rng.uniform(0.0, 2.0, js.capacity).astype(np.float32)
    js2, jent = jpf.measure(js, jnp.asarray(lik))
    ts2, tent = pf.measure(ts, _t(lik))
    np.testing.assert_allclose(ts2.prob.numpy(), np.asarray(js2.prob), rtol=1e-6)
    np.testing.assert_allclose(float(tent), float(jent), rtol=1e-6)

    # the comb over JAX's own weights gives the same source indices
    prob = np.asarray(js2.prob)
    mask = np.asarray(js2.active_mask())
    total = np.float32(prob[mask].sum())
    pstep = jnp.float32(total) / jnp.float32(480)
    for u0 in (0.0, 0.37, 0.999):
        p0 = jnp.float32(u0) * pstep
        jidx = jpf._systematic_select(js2.prob, js2.active_mask(), js2.n_active,
                                      js2.capacity, p0, pstep)
        tidx = pf._systematic_select(_t(prob), _t(mask).bool(), ts2.n_active,
                                     ts2.capacity, _t(np.asarray(p0)),
                                     _t(np.asarray(pstep)))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))

    # the whole resample with JAX's draws injected
    from jax import random

    key_u, key_n = random.split(random.PRNGKey(9))
    u0 = random.uniform(key_u, (), jnp.float32, 0.0, 1.0)
    normals = random.normal(key_n, (js.capacity, 6), jnp.float32)
    sigma = jnp.full((6,), 0.05, jnp.float32)
    js3 = jpf.resample(js2, random.PRNGKey(9), sigma)
    ts3 = pf.resample(ts2, _t(np.asarray(u0)), _t(np.asarray(normals)),
                      _t(np.asarray(sigma)))
    np.testing.assert_allclose(ts3.pos.numpy(), np.asarray(js3.pos), atol=1e-6)
    np.testing.assert_allclose(ts3.rot.numpy(), np.asarray(js3.rot), atol=ATOL)
    np.testing.assert_array_equal(ts3.prob.numpy(), np.asarray(js3.prob))


def test_systematic_select_drops_indices_past_capacity():
    # weights ending in a heavy tail push comb counts past the end: they
    # are dropped, not clamped onto the last slot
    prob = torch.tensor([0.1, 0.1, 0.1, 0.7])
    mask = torch.ones(4, dtype=torch.bool)
    idx = pf._systematic_select(prob, mask, torch.tensor(4, dtype=torch.int32),
                                4, torch.tensor(0.5), torch.tensor(0.25))
    jidx = jpf._systematic_select(jnp.asarray(prob.numpy()), jnp.ones(4, bool),
                                  jnp.int32(4), 4, jnp.float32(0.5),
                                  jnp.float32(0.25))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("n, row", [(1, 4), (4, 4), (5, 4), (100, 4),
                                    (3000, 1024), ((1 << 20) + 5, 1024)])
def test_row_scan_is_an_inclusive_cumsum(n, row):
    # the scan resampling and point sampling use on CUDA, at each depth of
    # its recursion (rows, row totals, totals of totals) and ragged ends
    rng = np.random.default_rng(n)
    x = rng.uniform(0.0, 1.0, n).astype(np.float32)
    got = row_scan(torch.tensor(x), row).numpy()
    np.testing.assert_allclose(got, np.cumsum(x.astype(np.float64)), rtol=1e-6)
    xi = rng.integers(0, 5, n).astype(np.float32)        # sums exact in f32
    np.testing.assert_array_equal(row_scan(torch.tensor(xi), row).numpy(),
                                  np.cumsum(xi))
    # on the CPU the filter keeps the one-pass scan that JAX's matches
    xt = torch.tensor(x)
    assert torch.equal(cumsum(xt), torch.cumsum(xt, dim=0))


def test_init_multivariate_transform_reproduces_covariance():
    rng = np.random.default_rng(6)
    m = rng.normal(size=(6, 6))
    cov = (m @ m.T * 0.01 + np.eye(6) * 1e-3).astype(np.float32)
    tt = st.multivariate_transform(cov).numpy().astype(np.float64)
    np.testing.assert_allclose(tt @ tt.T, cov, atol=1e-6)
    s = st.init_multivariate(torch.zeros(64, 6), 64, 60, np.ones(3), np.zeros(3),
                             cov)
    np.testing.assert_allclose(s.pos.numpy(), np.ones((64, 3)), atol=0)
    assert float(s.prob.sum()) == pytest.approx(1.0)
    assert int(s.n_active) == 60
