"""The slice as a whole: the port's measurement step against the JAX
engine's on the flagship room world (``__graft_entry__``), at the small
settings of ``dryrun_multichip`` (2048 particles, 8 likelihood points,
beams clipped at 2 m / +-1 m), with JAX's random draws injected.

Tolerances and why:
* tiers: equal, and 0/0 (grouped kernels on both models);
* per-particle likelihoods ``lik_l``, ``lik_b``: rtol 1e-6 outside the
  particles with a query within 1e-4 cell of a .5 rounding boundary
  (XLA:CPU contracts ``a*b + c`` into FMA, eager torch does not) — the
  sums over points may take another order;
* ``e_pos``/``e_rot`` atol 1e-5 and ``cov`` rtol 1e-3 / atol 1e-9: means
  and moments over 2048 weighted particles summed in another order, and
  boundary particles may score differently.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as ge
from mcl_3dl_tpu.models.likelihood import clip_mask as j_clip_mask
from mcl_3dl_tpu.models.samplers import sample_uniform as j_sample_uniform

from mcl_3dl_tpu_torch import MCL3DL, StepDraws, convert, worlds
from mcl_3dl_tpu_torch.map.map_data import MapData
from mcl_3dl_tpu_torch.models.beam import BeamVirtualPoints
from mcl_3dl_tpu_torch.engine import beam_num_steps

from test_torch_models import _boundary

torch.set_num_threads(2)   # several test workers share the CPU

N = 2048
SMALL = dict(cloud_points=256, fast=True, like_points=8, beam_clip_far=2.0,
             beam_clip_z=1.0)


def _np(a, dtype=None):
    return np.array(a, dtype)


def _t(a, dtype=None):
    return torch.as_tensor(_np(a, dtype))


@pytest.fixture(scope="module")
def jax_world():
    return ge._build_engine_and_inputs(num_particles=N, **SMALL)


def _port_engine(eng_j):
    eng = MCL3DL(convert.params(dataclasses.asdict(eng_j.params)), device="cpu")
    jm = eng_j.map

    def df(d):
        return convert.distance_field(_np(d.field), _np(d.origin), d.cell,
                                      d.trunc, d.weights, _np(d.field2d))

    eng.map = MapData(points=jm.points, labels=jm.labels, df=df(jm.df),
                      df_beam=df(jm.df_beam), occ=None, params=eng.params)
    eng.has_map = True
    return eng


def _jax_draws(eng_j, args):
    """The draws the JAX step takes from its key (engine.py:835,
    pf.py:136-152, samplers.py:40)."""
    p = eng_j.params
    lp, bp = p.likelihood, p.beam
    cloud, valid = args[5], args[7]
    k_like, k_beam, k_resample, k_noise, k_expand = jax.random.split(args[1], 5)
    like_keep = valid & j_clip_mask(cloud, lp.clip_near, lp.clip_far,
                                    lp.clip_z_min, lp.clip_z_max)
    beam_keep = valid & j_clip_mask(cloud, bp.clip_near, bp.clip_far,
                                    bp.clip_z_min, bp.clip_z_max)
    _, _, like_idx = j_sample_uniform(k_like, cloud, like_keep, lp.num_points)
    _, _, beam_idx = j_sample_uniform(k_beam, cloud, beam_keep, bp.num_points)
    key_u, key_n = jax.random.split(k_resample)
    cap = args[0].capacity
    return StepDraws(
        like_idx=_t(like_idx, np.int64), beam_idx=_t(beam_idx, np.int64),
        u0=_t(jax.random.uniform(key_u, (), jnp.float32, 0.0, 1.0)),
        resample_normals=_t(jax.random.normal(key_n, (cap, 6), jnp.float32)),
        noise_normals=_t(jax.random.normal(k_noise, (cap, 4), jnp.float32)),
        expand_normals=_t(jax.random.normal(k_expand, (cap, 6), jnp.float32)))


def test_measurement_step_matches_jax(jax_world):
    eng_j, args = jax_world
    eng = _port_engine(eng_j)
    draws = _jax_draws(eng_j, args)
    p = eng.params
    state = convert.particle_state(*(_np(x) for x in args[0]))
    cloud, labels, valid, origins = (_t(args[5]), _t(args[6], np.int64),
                                     _t(args[7]), _t(args[9]))

    # per-particle likelihoods, on the points both sides sample
    (like_pts, like_valid, beam_pts, beam_labels, beam_valid, _,
     _) = eng.sample_points(cloud, labels, valid, draws)
    mask = state.active_mask()
    tl, tq, tb, ttl, ttb = eng._measure_models(
        state.pos, state.rot, mask, eng.map.df, eng.map.df_beam, like_pts,
        like_valid, beam_pts, beam_labels, beam_valid, origins)
    js = args[0]
    jl, jq, jb, jtl, jtb = jax.jit(eng_j._measure_models)(
        js.pos, js.rot, js.active_mask(), js.n_active, eng_j.map.df,
        eng_j.map.df_beam, eng_j.map.occ, jnp.asarray(like_pts.numpy()),
        jnp.asarray(like_valid.numpy()), jnp.asarray(beam_pts.numpy()),
        jnp.asarray(beam_labels.numpy(), jnp.int32),
        jnp.asarray(beam_valid.numpy()), args[9])
    assert (ttl, ttb) == (int(jtl), int(jtb)) == (0, 0)
    vp = BeamVirtualPoints(beam_pts, beam_labels, beam_valid, origins,
                           p.map_grid_min, p.beam.hit_range, beam_num_steps(p))
    pos, rot = _np(js.pos), _np(js.rot)
    ok = ~(_boundary(eng_j.map.df, pos, rot, like_pts.numpy())
           | _boundary(eng_j.map.df, pos, rot, vp.vpf.numpy()))
    assert ok.mean() > 0.8
    for got, want in ((tl, jl), (tq, jq), (tb, jb)):
        np.testing.assert_allclose(got.numpy()[ok], _np(want)[ok], rtol=1e-6)

    # the whole step
    fp, fa = (convert.filter_state(*(_np(x) for x in f)) for f in args[14:16])
    out = eng._measurement_step(
        state, eng.map.df, eng.map.df_beam, cloud, labels, valid, origins,
        _t(args[10]), _t(args[11]), _t(args[12]), _t(args[13]), fp, fa, False,
        (p.std_warn_thresh_xy, p.std_warn_thresh_z, p.std_warn_thresh_yaw),
        draws=draws)
    jout = eng_j._step(*args)
    aux, jaux = out[-1], jout[-1]
    assert (aux["tier_like"], aux["tier_beam"]) == (0, 0)
    assert (int(jaux["tier_like"]), int(jaux["tier_beam"])) == (0, 0)
    np.testing.assert_allclose(aux["e_pos"].numpy(), _np(jaux["e_pos"]), atol=1e-5)
    np.testing.assert_allclose(aux["e_rot"].numpy(), _np(jaux["e_rot"]), atol=1e-5)
    np.testing.assert_allclose(aux["cov"].numpy(), _np(jaux["cov"]), rtol=1e-3,
                               atol=1e-9)
    for key in ("jumped", "expanded", "points_not_found", "converged"):
        assert bool(aux[key]) == bool(jaux[key]), key


def test_drive_converges_on_cpu():
    """Six scans through odometry + push_cloud: tiers 0/0 and a published
    pose within 0.05 m / 0.05 rad of the truth (the origin)."""
    from mcl_3dl_tpu_torch import BeamParams, LikelihoodParams, Params

    params = Params(num_particles=N, use_beam_model=True,
                    likelihood=LikelihoodParams(num_points=8),
                    beam=BeamParams(clip_far=2.0, clip_z_min=-1.0,
                                    clip_z_max=1.0))
    eng = MCL3DL(params, device="cpu")
    eng.load_map(worlds.world_map())
    ident = np.array([0.0, 0.0, 0.0, 1.0])
    eng.initial_pose(np.zeros(3), ident, worlds.TRACKING_COV)
    rng = np.random.default_rng(0)
    results = []
    for i in range(7):
        t = 0.1 * i
        eng.odometry(np.zeros(3), ident, t)
        res = eng.push_cloud("lidar", worlds.scan(rng, 256),
                             np.array([0.0, 0.0, worlds.SENSOR_Z]), t)
        if res is not None:
            results.append(res)
    assert len(results) == 6
    last = results[-1]
    assert (eng.last_aux["tier_like"], eng.last_aux["tier_beam"]) == (0, 0)
    assert np.linalg.norm(last.pos) < 0.05
    assert 2.0 * np.arccos(min(abs(float(last.rot[3])), 1.0)) < 0.05
    assert np.linalg.norm(last.raw_pos[:2]) < 0.05
    assert np.isfinite(last.cov).all()
