"""Correlative global localization of the port (``map/correlative.py`` and
``MCL3DL.global_localization_correlative``) against the JAX package's on
the flagship room world and one of its scans.

Tolerances and why:
* ``build_planar_field``: ``w2`` and the origin equal (the same float32
  operations), the cached FFT to 1e-6 of its largest magnitude (pocketfft
  against XLA's FFT, float sums in another order);
* ``correlate_scan``: scores to 2e-6 of the largest score, ``SCORE_TOL``
  (two FFTs and a product of 199 x 199 float32 sums; measured 7e-7);
* ``top_candidates``: the scores equal to ``SCORE_TOL`` rank by rank; the
  candidate cells equal, except cells whose score lies within
  ``SCORE_TOL`` of the last kept score, where ties may fall either way;
* seeding: the same seeds, except where a seed's score lies within
  ``SCORE_TOL`` of the last kept score; shared seeds' ``pos`` and ``rot``
  to 1e-6 and weights relative to the best seed's to 3e-4: a weight is
  ``exp(-60 (1 - score / best))``, so a relative score error of 2 x 2e-6
  grows 60-fold (2.4e-4).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mcl_3dl_tpu.config import Params as JParams
from mcl_3dl_tpu.engine import MCL3DL as JMCL3DL
from mcl_3dl_tpu.map import correlative as jc

from mcl_3dl_tpu_torch import MCL3DL, Params, worlds
from mcl_3dl_tpu_torch.map import correlative as tc
from mcl_3dl_tpu_torch.models.likelihood import clip_mask
from mcl_3dl_tpu_torch.math import quat_np as mqn

torch.set_num_threads(2)   # several test workers share the CPU

NBINS = 36
SEEDS = 64


@pytest.fixture(scope="module")
def engines():
    eng = MCL3DL(Params(num_particles=64), device="cpu")
    eng.load_map(worlds.world_map())
    eng_j = JMCL3DL(JParams(num_particles=64))
    eng_j.load_map(worlds.world_map())
    imu = mqn.from_rpy(np.array([0.02, -0.01, 0.3])).astype(np.float32)
    eng.imu_quat = eng_j.imu_quat = imu
    scan = worlds.scan(np.random.default_rng(0), 512)
    return eng, eng_j, scan


def _fields(eng, eng_j):
    lp = eng.params.likelihood
    pad = int(np.ceil(lp.clip_far / eng.map.df.cell)) + 2
    args = (lp.match_dist_min, lp.match_dist_flat, lp.match_weight,
            -np.inf, np.inf, pad)
    return (tc.build_planar_field(eng.map.df, *args),
            jc.build_planar_field(eng_j.map.df, *args))


def _scores(ft, fj, scan):
    xy = scan[:, :2].astype(np.float32)
    yaws = (2.0 * np.pi * np.arange(NBINS) / NBINS).astype(np.float32)
    st = tc.correlate_scan(ft, torch.as_tensor(xy), torch.as_tensor(yaws))
    sj = jc.correlate_scan(fj, jnp.asarray(xy), jnp.asarray(yaws))
    return st, np.asarray(sj)


def test_planar_field_matches_jax(engines):
    eng, eng_j, _ = engines
    ft, fj = _fields(eng, eng_j)
    np.testing.assert_array_equal(ft.w2.numpy(), np.asarray(fj.w2))
    np.testing.assert_array_equal(ft.origin_xy.numpy(), np.asarray(fj.origin_xy))
    assert ft.shape_unpadded == tuple(fj.shape_unpadded)
    assert ft.cell == fj.cell
    want = np.asarray(fj.w2_fft)
    np.testing.assert_allclose(ft.w2_fft.numpy(), want,
                               atol=1e-6 * np.abs(want).max(), rtol=0)


def test_correlate_scan_matches_jax(engines):
    eng, eng_j, scan = engines
    ft, fj = _fields(eng, eng_j)
    st, sj = _scores(ft, fj, scan)
    assert st.shape == sj.shape == (NBINS, *ft.w2.shape)
    np.testing.assert_allclose(st.numpy(), sj, rtol=0,
                               atol=2e-6 * np.abs(sj).max())


def _cells(x, y, yaw_i, field):
    """Candidates as (cell x, cell y, yaw bin) keys."""
    o = field.origin_xy.numpy().astype(np.float64)
    return [(int(round((a - o[0]) / field.cell)),
             int(round((b - o[1]) / field.cell)), int(k))
            for a, b, k in zip(x, y, yaw_i)]


@pytest.mark.parametrize("n", [SEEDS, 512])
def test_top_candidates_match_jax(engines, n):
    eng, eng_j, scan = engines
    ft, fj = _fields(eng, eng_j)
    st, sj = _scores(ft, fj, scan)
    tol = 2e-6 * np.abs(sj).max()
    xt, yt, it, vt = (a.numpy() for a in tc.top_candidates(st, ft, n))
    xj, yj, ij, vj = (np.asarray(a) for a in jc.top_candidates(
        jnp.asarray(sj), fj, n))
    np.testing.assert_allclose(vt, vj, rtol=0, atol=tol)
    kt, kj = _cells(xt, yt, it, ft), _cells(xj, yj, ij, ft)
    ct, cj = set(kt), set(kj)
    assert len(ct) == len(cj) == n
    score = dict(zip(kj, vj))
    score.update(zip(kt, vt))
    for c in ct ^ cj:
        assert abs(score[c] - vj[-1]) <= tol, (c, score[c], vj[-1])
    assert len(ct ^ cj) <= 0.1 * n


def _seeds(eng, state, n):
    """The first ``n`` seeds keyed by (cell x, cell y, yaw bin): ``{key:
    (pos, rot, prob)}``."""
    pos = np.asarray(state.pos)[:n].astype(np.float64)
    rot = np.asarray(state.rot)[:n]
    prob = np.asarray(state.prob)[:n]
    o = eng.map.df.origin.numpy().astype(np.float64)
    cell = eng.map.df.cell
    yaw = mqn.to_rpy(rot.astype(np.float64))[:, 2]
    bins = np.round(yaw / (2.0 * np.pi / NBINS)).astype(int) % NBINS
    keys = [(int(round((x - o[0]) / cell)), int(round((y - o[1]) / cell)),
             int(b)) for (x, y, _), b in zip(pos, bins)]
    assert len(set(keys)) == n
    return {k: (p, r, w) for k, p, r, w in zip(keys, pos, rot, prob)}


@pytest.mark.parametrize("yaw_prior,seed_z", [((0.3, 0.4), 0.0),
                                               (None, None)],
                         ids=["priors", "no-prior"])
def test_correlative_seeding_matches_jax(engines, yaw_prior, seed_z):
    """The same seeds as JAX, up to ties at the last kept score; the
    weights of shared seeds equal relative to the best seed's."""
    eng, eng_j, scan = engines
    n = eng.global_localization_correlative(
        num_seeds=SEEDS, scan_points_base=scan, yaw_prior=yaw_prior,
        seed_z=seed_z)
    n_j = eng_j.global_localization_correlative(
        num_seeds=SEEDS, scan_points_base=scan, yaw_prior=yaw_prior,
        seed_z=seed_z)
    assert n == n_j == SEEDS == eng._n_active_host
    assert eng.pstate.capacity == eng_j.pstate.capacity == 64
    assert int(eng.pstate.n_active) == n
    st_t, st_j = _seeds(eng, eng.pstate, n), _seeds(eng, eng_j.pstate, n)
    np.testing.assert_allclose(
        sum(w for _, _, w in st_t.values()), 1.0, rtol=1e-5)

    # scores of the engine's correlation (the clipped scan, 36 bins)
    lp = eng.params.likelihood
    keep = clip_mask(torch.as_tensor(scan), lp.clip_near, lp.clip_far,
                     lp.clip_z_min, lp.clip_z_max).numpy()
    ft, fj = _fields(eng, eng_j)
    scores, sj = _scores(ft, fj, scan[keep])
    tol = 2e-6 * np.abs(sj).max()
    cut = min(float(scores[k[2], k[0], k[1]]) for k in st_j)
    for k in set(st_t) ^ set(st_j):
        assert abs(float(scores[k[2], k[0], k[1]]) - cut) <= tol, k
    shared = sorted(set(st_t) & set(st_j))
    assert len(shared) >= 0.9 * n
    best = max(shared, key=lambda k: st_j[k][2])
    for k in shared:
        (pt, rt, wt), (pj, rj, wj) = st_t[k], st_j[k]
        np.testing.assert_allclose(pt, pj, atol=1e-6)
        np.testing.assert_allclose(rt, rj, atol=1e-6)
        np.testing.assert_allclose(wt / st_t[best][2], wj / st_j[best][2],
                                   rtol=3e-4, atol=1e-9)
    if yaw_prior is not None:
        # every seed's map yaw within the prior's band, at the pinned z
        for k, (p, r, _) in st_t.items():
            yaw = mqn.to_rpy(r.astype(np.float64))[2]
            assert abs(np.arctan2(np.sin(yaw - 0.3), np.cos(yaw - 0.3))) <= 0.4 + 1e-3
            assert p[2] == 0.0
