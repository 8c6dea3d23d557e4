"""Trilinear sampling in the port against the JAX package on the CPU: the
corner pack, ``sample_trilinear`` (packed and unpacked), the trilinear
likelihood, and the engine's choice of sampling (trilinear in tracking,
nearest in global mode).

Tolerances and why:
* the corner pack: byte-equal to the JAX package's numpy build (its
  native builder switched off);
* ``sample_trilinear``: atol 2e-6 of ``trunc`` outside queries whose
  cell coordinate lies within 1e-4 cell of an integer (found in float64):
  XLA:CPU may contract ``out + w * v`` into an FMA, eager torch does not,
  and a query near a cell face may take the other corner cube;
* the trilinear likelihood: quality equal, and the likelihood within
  ``K * match_weight * 2e-6 * trunc`` (each of the K points adds
  ``match_weight`` times a distance that agrees to 2e-6 of ``trunc``), on
  particles without a query near a cell face and without a query whose
  distance lies within 1e-5 of ``match_dist_min`` (where ``d <=
  match_dist_min`` may flip);
* the engine's choice: tier ids equal one for one; nearest global-mode
  likelihoods rtol 1e-6 outside .5 rounding boundaries (as in
  ``test_torch_models.py``), trilinear tracking ones as above.
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
from mcl_3dl_tpu.map.distance_field import build_distance_field as j_build_df
from mcl_3dl_tpu.map.map_data import MapData as JMapData
from mcl_3dl_tpu.math import quat as jq
from mcl_3dl_tpu.models import likelihood as jlike

from worlds import make_room

from mcl_3dl_tpu_torch import MCL3DL, convert, worlds
from mcl_3dl_tpu_torch.config import Params
from mcl_3dl_tpu_torch.map.map_data import MapData
from mcl_3dl_tpu_torch.models import likelihood as tlike

from test_torch_models import _boundary

torch.set_num_threads(2)   # several test workers share the CPU

MDM, MDF, MW = 0.2, 0.05, 5.0
FACE = 1e-4


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(jnative, "build_distance_field_native",
                        lambda *a, **k: None)
    monkeypatch.setattr(jnative, "build_occupancy_rep_native",
                        lambda *a, **k: None)


def _near_face(df, q):
    """Queries [..., 3] whose cell coordinate is within FACE of an integer
    (float64)."""
    u = ((np.asarray(q, np.float64) * np.asarray(df.weights))
         - np.asarray(df.origin, np.float64)) / df.cell
    return (np.abs(u - np.round(u)) < FACE).any(axis=-1)


@pytest.mark.parametrize("world", ["flagship", "room_fine", "labelled"])
def test_corner_pack_bytes_equal(no_native, world):
    points, kw, labels = {
        "flagship": (worlds.world_map(), {}, None),
        "room_fine": (make_room(-2.0, 2.0, -2.0, 2.0, grid=0.1,
                                with_ceiling=True),
                      dict(dist_weight_z=2.0, df_cell_size=0.05), None),
        "labelled": (worlds.world_map(), dict(filter_label_max=0), "half"),
    }[world]
    if labels == "half":
        labels = (np.arange(len(points)) % 2).astype(np.uint32)
        beam_kw = {"filter_label_max": kw.pop("filter_label_max")}
        jp = JParams(**kw)
        jp = dataclasses.replace(jp, beam=dataclasses.replace(jp.beam,
                                                               **beam_kw))
        tp = Params(**kw)
        tp = dataclasses.replace(tp, beam=dataclasses.replace(tp.beam,
                                                               **beam_kw))
    else:
        jp, tp = JParams(**kw), Params(**kw)
    jm = JMapData.build(points, jp, labels)
    tm = MapData.build(points, tp, labels, device="cpu")
    assert tm.df.packed.dtype == torch.int32
    np.testing.assert_array_equal(tm.df.packed.numpy().view(np.uint32),
                                  np.asarray(jm.df.packed))
    # the label-filtered beam field samples nearest only: no pack
    assert (tm.df_beam.packed is None) == (jm.df_beam.packed is None)
    if labels is not None:
        assert tm.df_beam.packed is None and tm.df_beam is not tm.df


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "eight"])
def test_sample_trilinear_matches_jax(packed):
    rng = np.random.default_rng(3)
    pts = rng.uniform(-3.0, 3.0, (400, 3))
    jdf = j_build_df(pts, 0.1, 0.6, weights=(1.0, 1.0, 2.0),
                     pack_corners=packed)
    assert (jdf.packed is not None) == packed
    tdf = convert.distance_field(
        np.asarray(jdf.field), np.asarray(jdf.origin), jdf.cell, jdf.trunc,
        jdf.weights, np.asarray(jdf.field2d),
        packed=np.asarray(jdf.packed) if packed else None)
    assert (tdf.packed is not None) == packed
    # inside the map, and a margin outside it on every face
    q = rng.uniform(-4.5, 4.5, (8192, 3)).astype(np.float32)
    got = tdf.sample_trilinear(torch.as_tensor(q)).numpy()
    want = np.asarray(jdf.sample_trilinear(jnp.asarray(q)))
    face = _near_face(jdf, q)
    assert face.mean() < 2e-3
    np.testing.assert_allclose(got[~face], want[~face], rtol=0,
                               atol=2e-6 * jdf.trunc)
    assert np.mean(got[~face] == want[~face]) > 0.5
    # a weighted mean of field values: in [0, trunc] up to the rounding of
    # the eight weights; a query outside the map reads trunc
    assert got.min() >= 0.0 and got.max() <= jdf.trunc * (1.0 + 1e-6)
    far = (np.abs(q) > 4.4).any(axis=1)
    assert far.sum() > 100
    np.testing.assert_allclose(got[far], jdf.trunc, rtol=1e-6)


def _particles(rng, n, sxy=0.3, syaw=0.2):
    pos = np.stack([rng.normal(0, sxy, n), rng.normal(0, sxy, n),
                    rng.normal(0, 0.05, n)], axis=1).astype(np.float32)
    rpy = np.stack([rng.normal(0, 0.02, n), rng.normal(0, 0.02, n),
                    rng.normal(0, syaw, n)], axis=1).astype(np.float32)
    return pos, np.asarray(jq.from_rpy(jnp.asarray(rpy)), np.float32)


def _trilinear_excluded(jdf, pos, rot, pts):
    """Particles with a query near a cell face, or whose JAX distance lies
    within 1e-5 of MDM."""
    r = np.asarray(jq.rotation_matrix(jq.normalize(jnp.asarray(rot))))
    q = np.einsum("kj,nij->nki", pts, r) + pos[:, None, :]
    d = np.asarray(jdf.sample_trilinear(jnp.asarray(q, jnp.float32)))
    return (_near_face(jdf, q).any(axis=1)
            | (np.abs(d - MDM) < 1e-5).any(axis=1))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "eight"])
def test_likelihood_trilinear_matches_jax(packed):
    rng = np.random.default_rng(5)
    jdf = j_build_df(rng.uniform(-3.0, 3.0, (300, 3)), 0.1, 0.6,
                     weights=(1.0, 1.0, 2.0), pack_corners=packed)
    tdf = convert.distance_field(
        np.asarray(jdf.field), np.asarray(jdf.origin), jdf.cell, jdf.trunc,
        jdf.weights, packed=np.asarray(jdf.packed) if packed else None)
    n = 1024
    pos, rot = _particles(rng, n)
    pts = rng.uniform(-1.5, 1.5, (16, 3)).astype(np.float32)
    valid = rng.uniform(size=16) < 0.9
    tl, tq_, tier = tlike.likelihood_measure(
        tdf, torch.as_tensor(pos), torch.as_tensor(rot), torch.as_tensor(pts),
        torch.as_tensor(valid), MDM, MDF, MW, trilinear=True)
    jl, jq_ = jlike.likelihood_measure(
        jdf, jnp.asarray(pos), jnp.asarray(rot), jnp.asarray(pts),
        jnp.asarray(valid), MDM, MDF, MW, trilinear=True)
    assert tier == tlike.TIER_GATHER
    ok = ~_trilinear_excluded(jdf, pos, rot, pts)
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(tq_.numpy()[ok], np.asarray(jq_)[ok])
    np.testing.assert_allclose(tl.numpy()[ok], np.asarray(jl)[ok], rtol=0,
                               atol=_like_atol(jdf, len(pts)))
    assert float(tq_.sum()) > 0


def _like_atol(df, k):
    return k * MW * 2e-6 * df.trunc


def _engines():
    jp = JParams(num_particles=1024, use_beam_model=False,
                 likelihood=dataclasses.replace(JParams().likelihood,
                                                interp="trilinear",
                                                num_points=16))
    tp = convert.params(dataclasses.asdict(jp))
    eng_j = JMCL3DL(jp)
    eng_j.load_map(worlds.world_map())
    eng = MCL3DL(tp, device="cpu")
    eng.load_map(worlds.world_map())
    return eng_j, eng


@pytest.mark.parametrize("mode", ["tracking", "global"])
def test_engine_interp_choice_matches_jax(no_native, mode):
    """``interp="trilinear"``: a tracking step samples trilinear (tier 2);
    a global-mode step (2048 active above ``num_particles`` 1024) samples
    nearest, its grouped layout built inside the likelihood model (K1 at
    a capacity that is a tile multiple, for clustered particles)."""
    eng_j, eng = _engines()
    assert eng.params.likelihood.interp == "trilinear"
    rng = np.random.default_rng(11)
    n = 2048
    active = n if mode == "global" else 1024
    pos, rot = _particles(rng, n, sxy=0.04, syaw=0.05)
    pts = worlds.scan(rng, 16).astype(np.float32)
    valid = np.ones(16, bool)
    mask = np.arange(n) < active
    tl, tq_, _, ttl, ttb = eng._measure_models(
        torch.as_tensor(pos), torch.as_tensor(rot), torch.as_tensor(mask),
        eng.map.df, eng.map.df_beam, torch.as_tensor(pts),
        torch.as_tensor(valid), torch.as_tensor(pts[:1]),
        torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.bool),
        torch.zeros((1, 3)), global_mode=mode == "global")
    jm = eng_j.map
    jl, jq_, _, jtl, jtb = jax.jit(eng_j._measure_models)(
        jnp.asarray(pos), jnp.asarray(rot), jnp.asarray(mask),
        jnp.int32(active), jm.df, jm.df_beam, jm.occ, jnp.asarray(pts),
        jnp.asarray(valid), jnp.asarray(pts[:1]), jnp.zeros(1, jnp.int32),
        jnp.zeros(1, bool), jnp.zeros((1, 3), jnp.float32))
    assert (ttl, ttb) == (int(jtl), int(jtb))
    assert ttl == (0 if mode == "global" else 2) and ttb == -1
    if mode == "global":
        ok = ~_boundary(jm.df, pos, rot, pts)
        tol = dict(rtol=1e-6)
    else:
        ok = ~_trilinear_excluded(jm.df, pos, rot, pts)
        tol = dict(rtol=0, atol=_like_atol(jm.df, len(pts)))
    assert ok.mean() > 0.8
    np.testing.assert_array_equal(tq_.numpy()[ok], np.asarray(jq_)[ok])
    np.testing.assert_allclose(tl.numpy()[ok], np.asarray(jl)[ok], **tol)
