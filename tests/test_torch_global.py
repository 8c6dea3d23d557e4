"""Global mode of the port against the JAX engine: ``pf.resize``, the
capacity buckets, the slot buckets of the global-mode step, one global-mode
step with JAX's draws injected, and the ``global_localization`` service;
then the port alone: the verify skill's decay probe and the two repairs
of the host shell (capacity after ``initial_pose``, ``particle_size``
from the device count).

Tolerances and why:
* ``pf.resize``: the selected indices, ``n_active`` and the gathered
  columns equal; ``prob`` to 1e-7 (both sides divide by the same float);
* grow/shrink: shapes and every value equal;
* one global-mode step: ``n_active``, ``did_resize``, ``tier_like`` and
  the ``jumped``/``large_std`` flags equal; per-particle likelihoods rtol
  1e-6 outside the particles with a query within 1e-4 cell of a .5
  rounding boundary (XLA:CPU contracts ``a*b + c`` into FMA, eager torch
  does not); ``e_pos``/``e_rot`` atol 1e-5 and ``cov`` rtol 1e-3 / atol
  1e-9 (weighted sums over 1,600 particles in another order);
* ``global_localization``: the standable mask and the count equal,
  ``pos``/``rot``/``prob`` to 1e-6.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from mcl_3dl_tpu import pf as jpf
from mcl_3dl_tpu.config import Params as JParams
from mcl_3dl_tpu.engine import MCL3DL as JMCL3DL
from mcl_3dl_tpu.engine import _standable_mask as j_standable_mask
from mcl_3dl_tpu.map.voxel import voxel_downsample as j_voxel_downsample
from mcl_3dl_tpu.models.likelihood import clip_mask as j_clip_mask
from mcl_3dl_tpu.models.samplers import sample_uniform as j_sample_uniform
from mcl_3dl_tpu.state import ParticleState as JParticleState

from mcl_3dl_tpu_torch import (MCL3DL, FilterStatus, Params, StepDraws,
                               convert, pf, worlds)
from mcl_3dl_tpu_torch.engine import global_slots, standable_mask
from mcl_3dl_tpu_torch.map.map_data import MapData

from test_torch_models import _boundary

torch.set_num_threads(2)   # several test workers share the CPU


def _np(a, dtype=None):
    return np.array(a, dtype)


def _t(a, dtype=None):
    return torch.as_tensor(_np(a, dtype))


def _random_state(rng, cap, n_active, spread=1.0):
    """Numpy columns of a particle state: positions and yaws spread by
    ``spread`` (m, rad), small roll/pitch, random weights."""
    rpy = np.stack([rng.normal(0, 0.02, cap), rng.normal(0, 0.02, cap),
                    rng.uniform(-spread, spread, cap)], axis=1)
    cr, sr = np.cos(rpy / 2).T, np.sin(rpy / 2).T
    rot = np.stack([sr[0] * cr[1] * cr[2] - cr[0] * sr[1] * sr[2],
                    cr[0] * sr[1] * cr[2] + sr[0] * cr[1] * sr[2],
                    cr[0] * cr[1] * sr[2] - sr[0] * sr[1] * cr[2],
                    cr[0] * cr[1] * cr[2] + sr[0] * sr[1] * sr[2]], axis=1)
    pos = rng.normal(0, spread, (cap, 3)) * np.array([1.0, 1.0, 0.05])
    pos[:, 2] += 0.05
    prob = rng.uniform(0.1, 1.0, cap) * (np.arange(cap) < n_active)
    return dict(pos=pos.astype(np.float32), rot=rot.astype(np.float32),
                odom_err_lin=rng.normal(0, 0.01, (cap, 3)).astype(np.float32),
                odom_err_ang=rng.normal(0, 0.01, (cap, 3)).astype(np.float32),
                noise=rng.normal(0, 0.1, (cap, 4)).astype(np.float32),
                prob=(prob / prob.sum()).astype(np.float32),
                prob_bias=np.ones(cap, np.float32), n_active=n_active)


def _both(cols):
    j = JParticleState(**{k: jnp.asarray(v) for k, v in cols.items()
                          if k != "n_active"},
                       n_active=jnp.asarray(cols["n_active"], jnp.int32))
    return j, convert.particle_state(**cols)


@pytest.mark.parametrize("new_n", [64, 150, 200])
def test_resize_matches_jax(new_n):
    cols = _random_state(np.random.default_rng(new_n), 256, 200)
    js, ts = _both(cols)
    out_j = jax.jit(jpf.resize)(js, jnp.asarray(new_n, jnp.int32))
    out_t = pf.resize(ts, new_n)
    # the comb at pstep * (i + 1) selects the same particles
    pstep_j = jnp.sum(js.prob * js.active_mask()) / new_n
    idx_j = jpf._systematic_select(js.prob, js.active_mask(), js.n_active,
                                   256, pstep_j, pstep_j)
    pstep_t = torch.sum(ts.prob * ts.active_mask()) / new_n
    idx_t = pf._systematic_select(ts.prob, ts.active_mask(), ts.n_active, 256,
                                  pstep_t, pstep_t)
    np.testing.assert_array_equal(idx_t.numpy(), _np(idx_j))
    assert int(out_t.n_active) == int(out_j.n_active) == new_n
    for name in ("pos", "rot", "odom_err_lin", "odom_err_ang", "noise",
                 "prob_bias"):
        np.testing.assert_array_equal(getattr(out_t, name).numpy(),
                                      _np(getattr(out_j, name)), err_msg=name)
    np.testing.assert_allclose(out_t.prob.numpy(), _np(out_j.prob), atol=1e-7)


def _engines(num_particles=64, capacity=None):
    p = Params(num_particles=num_particles)
    jp = JParams(num_particles=num_particles)
    return (JMCL3DL(jp, capacity=capacity),
            MCL3DL(p, capacity=capacity, device="cpu"))


def test_grow_and_shrink_capacity_match_jax():
    eng_j, eng = _engines()
    cols = _random_state(np.random.default_rng(3), 64, 64)
    eng_j.pstate, eng.pstate = _both(cols)
    for n in (300, 5000, 100):        # grow twice; a smaller n keeps it
        eng_j._grow_capacity(n)
        eng._grow_capacity(n)
        for a, b in zip(eng.pstate, eng_j.pstate):
            np.testing.assert_array_equal(a.numpy(), _np(b))
    assert eng.pstate.capacity == 8192
    for n in (3000, 64):              # 3000 -> 4096, then the base 64
        eng_j.pstate = eng_j.pstate._replace(n_active=jnp.asarray(n, jnp.int32))
        eng.pstate = eng.pstate._replace(n_active=torch.tensor(n, dtype=torch.int32))
        eng_j._maybe_shrink_capacity()
        eng._maybe_shrink_capacity(n)
        for a, b in zip(eng.pstate, eng_j.pstate):
            np.testing.assert_array_equal(a.numpy(), _np(b))
    assert eng.pstate.capacity == 64


@pytest.mark.parametrize("num_points", [96, 8, 40])
def test_global_slot_buckets_match_jax(num_points):
    """The port's slot bucket equals the JAX engine's choice of graph
    (tests/test_global_graph.py) over a sweep of particle counts."""
    kw = dict(num_particles=64, likelihood=dict(num_points=num_points))
    eng_j = JMCL3DL(JParams.from_dict(kw))
    p = Params.from_dict(kw)
    counts = sorted({int(x) for x in np.geomspace(1, 400_000, 300)}
                    | {65, 80, 300, 1000, 100_000})
    for n in counts:
        step = eng_j._global_step_for(n)
        k_j = [k for k, s in eng_j._step_global_cache.items() if s is step]
        assert [global_slots(p, n)] == k_j, n
    if num_points == 96:
        assert [global_slots(p, n) for n in (100_000, 1000, 300, 80)] == [
            8, 8, 32, 96]


# ---------------------------------------------------------------- one step

NUM_PARTICLES = 1024
CAP = 2048
N_ACTIVE = 1600
WORLD = dict(cloud_points=256, fast=True, beam_clip_far=2.0, beam_clip_z=1.0,
             capacity=CAP)


@pytest.fixture(scope="module")
def global_world():
    eng_t, args = ge._build_engine_and_inputs(num_particles=CAP, **WORLD)
    jp = dataclasses.replace(eng_t.params, num_particles=NUM_PARTICLES)
    eng_j = JMCL3DL(jp, capacity=CAP)
    eng_j.map, eng_j.has_map = eng_t.map, True
    eng = MCL3DL(convert.params(dataclasses.asdict(jp)), capacity=CAP,
                 device="cpu")
    jm = eng_t.map

    def df(d):
        return convert.distance_field(_np(d.field), _np(d.origin), d.cell,
                                      d.trunc, d.weights, _np(d.field2d))

    eng.map = MapData(points=jm.points, labels=jm.labels, df=df(jm.df),
                      df_beam=df(jm.df_beam), occ=None, params=eng.params)
    eng.has_map = True
    return eng_j, eng, args


def _jax_draws(eng_j, args, like_slots, beam_slots):
    """The draws the JAX step takes from its key (engine.py:835,
    pf.py:136-152, samplers.py:40) at the step's slot counts."""
    p = eng_j.params
    lp, bp = p.likelihood, p.beam
    cloud, valid = args[5], args[7]
    k_like, k_beam, k_resample, k_noise, k_expand = jax.random.split(args[1], 5)
    like_keep = valid & j_clip_mask(cloud, lp.clip_near, lp.clip_far,
                                    lp.clip_z_min, lp.clip_z_max)
    beam_keep = valid & j_clip_mask(cloud, bp.clip_near, bp.clip_far,
                                    bp.clip_z_min, bp.clip_z_max)
    _, _, like_idx = j_sample_uniform(k_like, cloud, like_keep, like_slots)
    _, _, beam_idx = j_sample_uniform(k_beam, cloud, beam_keep, beam_slots)
    key_u, key_n = jax.random.split(k_resample)
    cap = args[0].capacity
    return StepDraws(
        like_idx=_t(like_idx, np.int64), beam_idx=_t(beam_idx, np.int64),
        u0=_t(jax.random.uniform(key_u, (), jnp.float32, 0.0, 1.0)),
        resample_normals=_t(jax.random.normal(key_n, (cap, 6), jnp.float32)),
        noise_normals=_t(jax.random.normal(k_noise, (cap, 4), jnp.float32)),
        expand_normals=_t(jax.random.normal(k_expand, (cap, 6), jnp.float32)))


@pytest.mark.parametrize("spread,fix", [(0.05, False), (2.0, False),
                                        (2.0, True)],
                         ids=["tracking", "wide", "wide-fix"])
def test_global_step_matches_jax(global_world, spread, fix):
    """One global-mode step at capacity 2048 with 1,600 active particles
    (num_particles 1024): the ramp gives 61 of 64 likelihood slots, the
    beam is dropped, the count decays to 1200.  A tracking spread runs
    the grouped tier; a 2 m spread over the room falls back."""
    eng_j, eng, args = global_world
    k = global_slots(eng.params, N_ACTIVE)
    assert k == 64
    cols = _random_state(np.random.default_rng(int(spread * 100)), CAP,
                         N_ACTIVE, spread)
    js, state = _both(cols)
    jargs = list(args)
    jargs[0] = js
    jargs[16] = jnp.asarray(fix)
    like_slots, beam_slots, use_beam = eng.slots(True, k)
    assert (like_slots, beam_slots, use_beam) == (64, 1, False)
    draws = _jax_draws(eng_j, jargs, like_slots, beam_slots)
    p = eng.params
    cloud, labels, valid, origins = (_t(args[5]), _t(args[6], np.int64),
                                     _t(args[7]), _t(args[9]))

    # per-particle likelihoods on the points both sides sample
    (like_pts, like_valid, beam_pts, beam_labels, beam_valid, _,
     _) = eng.sample_points(cloud, labels, valid, draws, global_mode=True,
                            global_slots=k, n_active=state.n_active)
    assert int(like_valid.sum()) == 96 * NUM_PARTICLES // N_ACTIVE
    assert not bool(beam_valid.any())
    tl, tq, tb, ttl, ttb = eng._measure_models(
        state.pos, state.rot, state.active_mask(), eng.map.df,
        eng.map.df_beam, like_pts, like_valid, beam_pts, beam_labels,
        beam_valid, origins, use_beam=False)
    jl, jq, jb, jtl, jtb = jax.jit(eng_j._measure_models,
                                   static_argnames=("use_beam",))(
        js.pos, js.rot, js.active_mask(), js.n_active, eng_j.map.df,
        eng_j.map.df_beam, eng_j.map.occ, jnp.asarray(like_pts.numpy()),
        jnp.asarray(like_valid.numpy()), jnp.asarray(beam_pts.numpy()),
        jnp.asarray(beam_labels.numpy(), jnp.int32),
        jnp.asarray(beam_valid.numpy()), args[9], use_beam=False)
    assert (ttl, ttb) == (int(jtl), int(jtb))
    assert ttb == -1
    assert ttl == (0 if spread < 1.0 else 2)
    ok = ~_boundary(eng_j.map.df, cols["pos"], cols["rot"], like_pts.numpy())
    assert ok.mean() > 0.8
    for got, want in ((tl, jl), (tq, jq)):
        np.testing.assert_allclose(got.numpy()[ok], _np(want)[ok], rtol=1e-6)

    # the whole step
    fp, fa = (convert.filter_state(*(_np(x) for x in f)) for f in args[14:16])
    out = eng._measurement_step(
        state, eng.map.df, eng.map.df_beam, cloud, labels, valid, origins,
        _t(args[10]), _t(args[11]), _t(args[12]), _t(args[13]), fp, fa, fix,
        (p.std_warn_thresh_xy, p.std_warn_thresh_z, p.std_warn_thresh_yaw),
        draws=draws, global_mode=True, global_slots=k)
    jout = eng_j._global_step_for(N_ACTIVE)(*jargs)
    aux, jaux = out[-1], jout[-1]
    assert int(out[0].n_active) == int(jout[0].n_active) == 1200
    assert int(aux["n_active"]) == 1200
    assert out[0].capacity == CAP
    assert aux["tier_like"] == int(jaux["tier_like"]) == ttl
    assert aux["tier_beam"] == int(jaux["tier_beam"]) == -1
    for key in ("did_resize", "jumped", "large_std", "expanded",
                "points_not_found", "converged"):
        assert bool(aux[key]) == bool(jaux[key]), key
    assert bool(aux["did_resize"]) and bool(aux["jumped"])
    assert not (fix and bool(aux["large_std"]))
    np.testing.assert_allclose(aux["e_pos"].numpy(), _np(jaux["e_pos"]),
                               atol=1e-5)
    np.testing.assert_allclose(aux["e_rot"].numpy(), _np(jaux["e_rot"]),
                               atol=1e-5)
    np.testing.assert_allclose(aux["cov"].numpy(), _np(jaux["cov"]),
                               rtol=1e-3, atol=1e-9)
    # the decay's output: uniform weights over the 1200 kept, bias 1
    np.testing.assert_allclose(out[0].prob.numpy(), _np(jout[0].prob),
                               atol=1e-7)
    np.testing.assert_array_equal(out[0].prob_bias.numpy(), 1.0)


# ------------------------------------------------------ global localization

def test_global_localization_matches_jax():
    from mcl_3dl_tpu_torch.math import quat_np as mqn

    p = Params(num_particles=64)
    eng = MCL3DL(p, device="cpu")
    eng.load_map(worlds.world_map())
    eng_j = JMCL3DL(JParams(num_particles=64))
    eng_j.map = types.SimpleNamespace(points=eng.map.points)
    eng_j.has_map = True
    imu = mqn.from_rpy(np.array([0.03, -0.02, 0.4])).astype(np.float32)
    eng.imu_quat = eng_j.imu_quat = imu

    grid = p.global_localization_grid_lin
    pts = j_voxel_downsample(eng.map.points, grid)
    keep = standable_mask(pts, grid, p.dist_weight)
    np.testing.assert_array_equal(keep, j_standable_mask(pts, grid,
                                                         p.dist_weight))
    assert 0 < keep.sum() < len(keep)

    n = eng.global_localization()
    n_j = eng_j.global_localization()
    assert n == n_j == int(keep.sum()) * p.global_localization_div_yaw
    assert eng._n_active_host == n
    s, sj = eng.pstate, eng_j.pstate
    assert s.capacity == sj.capacity and int(s.n_active) == n
    for name in ("pos", "rot", "prob"):
        np.testing.assert_allclose(getattr(s, name).numpy(),
                                   _np(getattr(sj, name)), atol=1e-6,
                                   err_msg=name)
    for name in ("odom_err_lin", "odom_err_ang", "noise", "prob_bias"):
        np.testing.assert_array_equal(getattr(s, name).numpy(),
                                      _np(getattr(sj, name)), err_msg=name)


# ------------------------------------------------------ the port on its own

ORIGIN = np.array([0.0, 0.0, worlds.SENSOR_Z])
IDENT = np.array([0.0, 0.0, 0.0, 1.0])


def _step(eng, rng, t):
    eng.odometry(np.zeros(3), IDENT, t)
    return eng.push_cloud("lidar", worlds.scan(rng, 512), ORIGIN, t)


def test_global_localization_decays_to_num_particles():
    """The verify skill's probe: after ``global_localization()`` the count
    decays 0.75x a step (``max(floor(0.75 n), num_particles)``) with the
    status GLOBAL_LOCALIZATION; then the fix count (1 + 3 ceil(lpf_step))
    runs down, the status turns NORMAL, capacity is back at the base
    bucket and the pose is at the truth."""
    p = Params(num_particles=64, use_beam_model=True, lpf_step=1.0)
    eng = MCL3DL(p, device="cpu")
    eng.load_map(worlds.world_map())
    n = eng.global_localization()
    assert n > 10_000
    rng = np.random.default_rng(0)
    _step(eng, rng, 0.0)          # the first cloud only fills the round
    t, decays, fixes = 0.1, [], []
    while True:
        res = _step(eng, rng, t)
        t += 0.1
        assert res.particle_size == int(eng.pstate.n_active)
        want = max(int(np.float32(n) * np.float32(0.75)), 64)
        if n > 64:
            assert res.particle_size == want
            assert eng.last_aux["did_resize"]
            assert eng.last_aux["tier_beam"] == -1
            assert res.status.status == FilterStatus.GLOBAL_LOCALIZATION
            decays.append(res.particle_size)
            n = res.particle_size
            continue
        assert not eng.last_aux["did_resize"]
        fixes.append((eng.global_localization_fix_cnt, res.status.status))
        if eng.global_localization_fix_cnt == 0 and len(fixes) > 3:
            break
    assert len(decays) >= 8 and decays[-1] == 64
    gl, normal = FilterStatus.GLOBAL_LOCALIZATION, FilterStatus.NORMAL
    assert fixes == [(2, gl), (1, gl), (0, gl), (0, normal)]
    assert eng.pstate.capacity == 64
    assert np.linalg.norm(res.raw_pos[:2]) < 0.2


def test_initial_pose_shrinks_capacity():
    """Repair: ``initial_pose`` after ``global_localization`` cuts the
    capacity back to the base bucket, as the JAX engine does."""
    eng = MCL3DL(Params(num_particles=64), device="cpu")
    eng.load_map(worlds.world_map())
    eng.global_localization()
    assert eng.pstate.capacity > 64
    eng.initial_pose(np.zeros(3), IDENT, worlds.TRACKING_COV)
    assert eng.pstate.capacity == 64
    assert int(eng.pstate.n_active) == eng._n_active_host == 64


def test_particle_size_is_the_device_count():
    """Repair: after a decaying step, ``status.particle_size`` and the
    result's ``particle_size`` are the device's ``n_active``, and the host
    mirror follows it."""
    eng = MCL3DL(Params(num_particles=64), device="cpu")
    eng.load_map(worlds.world_map())
    eng.resize_particles(400)
    assert eng.pstate.capacity == 512 and eng._n_active_host == 400
    rng = np.random.default_rng(1)
    _step(eng, rng, 0.0)
    res = _step(eng, rng, 0.1)
    assert eng.last_aux["did_resize"]
    assert res.particle_size == eng.status.particle_size == 300
    assert int(eng.pstate.n_active) == eng._n_active_host == 300


def test_expansion_reset_moves_every_active_particle():
    eng = MCL3DL(Params(num_particles=64), device="cpu")
    before = eng.pstate.pos.clone()
    eng.expansion_reset()
    moved = (eng.pstate.pos != before).any(dim=1)
    assert bool(moved.all())
