"""Parity of the port's pose-grouped orchestration and of the plain
versions of kernels K1, K2 and K3 with the JAX package on the CPU.

Inputs are ``test_kernel_emulation._setup`` (a converged particle cloud
over a random point map) and the same cloud with envelope outliers.  The
JAX side runs the CPU ``emulate`` tier, which the JAX tests pin
bit-equal to the Pallas programs.

Tolerances and why:
* ``group_stats``: the bins agree on >= 99.9% of particles (yaw/pitch/
  roll edges can move by an ulp of atan2/asin, and the per-bin sums are
  taken in another order); ``A`` to rtol 1e-6 / atol 1e-4 cells.
* Fed JAX's ``g``/``A`` and bounds, every integer output (layout, bands,
  boxes, table codes, block minima, skip words) is exactly equal.
* K1/K2 plain versions on JAX's layout: bit-equal on every ``dest``
  slot, except particles with a query within 1e-4 cell of a .5 rounding
  boundary.  XLA:CPU contracts the affine query ``a*b + c`` into FMA,
  eager torch (and the CUDA kernels, built with -fmad=false) do not, so
  such a query may round to the other cell.  Those particles are found
  by a float64 evaluation, excluded and counted; boundary queries must
  be at most 0.1% of all queries.
* K3 has no affine query: bit-equal everywhere.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mcl_3dl_tpu.models.beam import BeamVirtualPoints as JBeamVirtualPoints
from mcl_3dl_tpu.ops import grouped as jog
from mcl_3dl_tpu.ops.local_gather import local_score as j_local_score

from mcl_3dl_tpu_torch import convert
from mcl_3dl_tpu_torch.math import quat as tq
from mcl_3dl_tpu_torch.models.beam import BeamVirtualPoints
from mcl_3dl_tpu_torch.ops import grouped as og
from mcl_3dl_tpu_torch.ops.local_gather import local_score

from test_kernel_emulation import _setup

torch.set_num_threads(2)   # several test workers share the CPU

BOUNDARY_WINDOW = 1e-4      # cells from a .5 rounding boundary
MDM, MDF, MW = 0.2, 0.05, 5.0


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a, dtype=dtype))


def port_df(jdf):
    return convert.distance_field(
        np.asarray(jdf.field), np.asarray(jdf.origin), jdf.cell, jdf.trunc,
        jdf.weights, field2d=np.asarray(jdf.field2d))


def port_stats(js):
    return og.GroupStats(g=_t(js.g), A=_t(js.A), a_min=_t(js.a_min),
                         a_max=_t(js.a_max), any_active=_t(js.any_active),
                         n_over=_t(js.n_over))


def port_layout(jl):
    nt = jl.A.shape[0]
    return og.GroupedLayout(
        A=_t(jl.A).reshape(nt, 12, og.TILE).contiguous(),
        dest=_t(jl.dest, np.int64), tile_group=_t(jl.tile_group),
        over_idx=_t(jl.over_idx, np.int64))


def boundary_particles(A, pts):
    """Float64 ``A @ p + b`` of every (particle, point) in cell space with
    the kernels' dequantized points: ``(mask [N], n_queries)`` of queries
    within ``BOUNDARY_WINDOW`` of a .5 rounding boundary."""
    A = np.asarray(A, np.float64)
    p = (np.round(np.asarray(pts, np.float32) * 65536.0).astype(np.int32)
         .astype(np.float64) / 65536.0)
    u = np.einsum("nij,kj->nki", A[:, :9].reshape(-1, 3, 3), p) + A[:, None, 9:]
    near = np.abs(u - np.floor(u) - 0.5) < BOUNDARY_WINDOW      # [N, K, 3]
    return near.any(axis=(1, 2)), int(near.sum())


def _with_outliers(seed=5, K=8):
    """The ``_setup`` cloud with 24 particles kicked off their bins'
    envelopes (they must land in the overflow bin)."""
    rng, df, scan, N, pos, rot, _ = _setup(seed=seed, K=K)
    from mcl_3dl_tpu.math import quat as mq

    pos = np.array(pos)
    pos[::43] += np.array([0.4, -0.3, 0.2], np.float32)
    pos = jnp.asarray(pos)
    rmat = mq.rotation_matrix(mq.normalize(rot))
    stats = jog.group_stats(pos, rmat, rot, df.weights, float(df.cell),
                            df.origin, jnp.ones((N,), bool))
    return rng, df, scan, N, pos, rot, stats


CASES = {"converged": _setup, "outliers": _with_outliers}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """``(name, setup tuple)``; the rng is re-seeded per test."""
    return request.param, CASES[request.param]()


def _unpack(case):
    name, (_, df, scan, N, pos, rot, js) = case
    return np.random.default_rng(11), df, scan, N, pos, rot, js


def test_group_stats_matches_jax(case):
    rng, df, scan, N, pos, rot, js = _unpack(case)
    pos_t, rot_t = _t(pos), _t(rot)
    rmat = tq.rotation_matrix(tq.normalize(rot_t))
    ts = og.group_stats(pos_t, rmat, rot_t, df.weights, float(df.cell),
                        _t(df.origin), torch.ones(N, dtype=torch.bool))
    agree = np.mean(ts.g.numpy() == np.asarray(js.g))
    assert agree >= 0.999, agree
    np.testing.assert_allclose(ts.A.numpy(), np.asarray(js.A), rtol=1e-6,
                               atol=1e-4)
    if case[0] == "outliers":
        assert int(js.n_over) > 0 and int(ts.n_over) > 0


def test_layout_bands_boxes_tables_exact(case):
    rng, df, scan, N, pos, rot, js = _unpack(case)
    ts = port_stats(js)
    cap = jog.default_overflow_cap(N)
    assert og.default_overflow_cap(N) == cap
    jl = jog.build_layout(js, cap)
    tl = og.build_layout(ts, cap)
    np.testing.assert_array_equal(tl.dest.numpy(), np.asarray(jl.dest))
    np.testing.assert_array_equal(tl.tile_group.numpy(), np.asarray(jl.tile_group))
    np.testing.assert_array_equal(tl.over_idx.numpy(), np.asarray(jl.over_idx))
    np.testing.assert_array_equal(
        tl.A.numpy(), np.asarray(jl.A).reshape(tl.A.shape))

    scan_t = _t(scan)
    for (jlo, jhi), (tlo, thi) in zip(jog.query_bands(js, scan),
                                      og.query_bands(ts, scan_t)):
        np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    jlo, jfits = jog.group_boxes(js, scan, df.field.shape)
    tlo, tfits = og.group_boxes(ts, scan_t, df.field.shape)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(tfits.numpy(), np.asarray(jfits))

    valid = np.asarray(rng.uniform(size=scan.shape[0]) < 0.8)
    ny, nzp = df.field.shape[1], df.field2d.shape[1]
    jtab, jz = jog.extract_tables(df.field2d, ny, nzp, jlo, jnp.asarray(valid),
                                  float(df.trunc))
    tdf = port_df(df)
    ttab, tz = og.extract_tables(tdf.field2d, ny, nzp, tlo, _t(valid))
    assert ttab.dtype == torch.uint8
    np.testing.assert_array_equal(ttab.numpy(),
                                  np.asarray(jtab.astype(jnp.float32)))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    jmin = jog.block_min_dist(jtab, float(df.trunc), lo=jlo, z_used=jz,
                              bands=jog.query_bands(js, scan))
    tmin = og.block_min_dist(ttab, float(df.trunc), tlo, tz,
                             og.query_bands(ts, scan_t))
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
    jskip = jog.pack_block_skip(jmin > jnp.float32(MDM))
    tskip = og.pack_block_skip(tmin > MDM)
    np.testing.assert_array_equal(tskip.numpy(), np.asarray(jskip))
    np.testing.assert_array_equal(og.make_meta(tlo, tz).numpy(),
                                  np.asarray(jog.make_meta(jlo, jz)))
    np.testing.assert_array_equal(og.points_fp(scan_t).numpy(),
                                  np.asarray(jog.points_fp(scan)))


def _compare_dest(port_sorted, jax_sorted, dest, exclude):
    keep = ~exclude
    got = np.asarray(port_sorted)[dest][keep]
    want = np.asarray(jax_sorted)[dest][keep]
    np.testing.assert_array_equal(got, want)


def test_like_kernel_plain_matches_emulate(case):
    rng, df, scan, N, pos, rot, js = _unpack(case)
    K = scan.shape[0]
    valid = jnp.asarray(rng.uniform(size=K) < 0.9)
    cap = jog.default_overflow_cap(N)
    lo, fits_kg = jog.group_boxes(js, scan, df.field.shape)
    assert bool(jnp.all(fits_kg | ~valid[:, None]))
    jl = jog.build_layout(js, cap)
    ny, nzp, trunc = df.field.shape[1], df.field2d.shape[1], float(df.trunc)
    tables, z_used = jog.extract_tables(df.field2d, ny, nzp, lo, valid, trunc)
    min_d = jog.block_min_dist(tables, trunc, lo=lo, z_used=z_used,
                               bands=jog.query_bands(js, scan))
    skipw = jog.pack_block_skip(min_d > jnp.float32(MDM))
    meta, pfp = jog.make_meta(lo, z_used), jog.points_fp(scan)
    kw = dict(match_dist_min=MDM, match_dist_flat=MDF, match_weight=MW,
              trunc=trunc)
    js_, jm_ = jog.grouped_like_score(jl.A, jl.tile_group, meta, pfp, skipw,
                                      tables, impl="emulate", **kw)
    tl = port_layout(jl)
    ts_, tm_ = og.grouped_like_score(
        tl.A, tl.tile_group, _t(meta), _t(pfp), _t(skipw),
        _t(np.asarray(tables.astype(jnp.float32)), np.uint8), **kw)
    exclude, n_q = boundary_particles(js.A, scan)
    assert n_q <= 1e-3 * N * K, (n_q, int(exclude.sum()))
    dest = np.asarray(jl.dest)
    _compare_dest(ts_, js_, dest, exclude)
    _compare_dest(tm_, jm_, dest, exclude)
    assert float(np.asarray(jm_)[dest].sum()) > 0


def test_beam_kernel_plain_matches_emulate(case):
    rng, df, scan, N, pos, rot, js = _unpack(case)
    scan = scan[:3]
    B = 3
    valid = jnp.ones((B,), bool)
    labels = jnp.zeros((B,), jnp.int32)
    origins = jnp.zeros((1, 3), jnp.float32)
    grid_min, hit_range, num_steps = 0.1, 0.3, 20
    vp = JBeamVirtualPoints(scan, labels, valid, origins, grid_min,
                            hit_range, num_steps)
    tvp = BeamVirtualPoints(_t(scan), _t(labels, np.int64), _t(valid),
                            _t(origins), grid_min, hit_range, num_steps)
    np.testing.assert_allclose(tvp.vpf.numpy(), np.asarray(vp.vpf), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(tvp.chainf.numpy(), np.asarray(vp.chainf))
    cap = jog.default_overflow_cap(N)
    lo, fits_kg = jog.group_boxes(js, vp.vpf, df.field.shape)
    assert bool(jnp.all(fits_kg | ~vp.chainf[:, None]))
    jl = jog.build_layout(js, cap)
    trunc = float(df.trunc)
    tables, z_used = jog.extract_tables(
        df.field2d, df.field.shape[1], df.field2d.shape[1], lo, vp.chainf, trunc)
    radius = float(2.0 ** 0.5) * 0.1 / 2.0
    min_d = jog.block_min_dist(tables, trunc, lo=lo, z_used=z_used,
                               bands=jog.query_bands(js, vp.vpf))
    skip = jog.pack_block_skip((min_d >= jnp.float32(trunc * 0.99))
                               & (min_d > jnp.float32(radius)))
    aux = jnp.stack([jnp.round(vp.length * 65536.0).astype(jnp.int32),
                     valid.astype(jnp.int32)], axis=-1)
    kw = dict(nprobe=vp.nprobe, trunc=trunc, grid_min=grid_min, radius=radius,
              hit_range=hit_range, sin_total_ref=0.5, long_pen=True,
              tol=hit_range)
    tab5 = tables.reshape(B, vp.nprobe, jog.G_GROUPS, jog.R_ROWS, jog.ZW)
    meta, pfp = jog.make_meta(lo, z_used), jog.points_fp(vp.vpf)
    jn = jog.grouped_beam_pen(jl.A, jl.tile_group, meta, pfp, aux, skip, tab5,
                              impl="emulate", **kw)
    tl = port_layout(jl)
    tn = og.grouped_beam_pen(
        tl.A, tl.tile_group, _t(meta), _t(pfp), _t(aux), _t(skip),
        _t(np.asarray(tab5.astype(jnp.float32)), np.uint8), **kw)
    exclude, n_q = boundary_particles(js.A, vp.vpf)
    assert n_q <= 1e-3 * N * vp.vpf.shape[0], (n_q, int(exclude.sum()))
    _compare_dest(tn, jn, np.asarray(jl.dest), exclude)
    assert float(np.asarray(jn).sum()) > 0


def test_local_score_plain_matches_emulate():
    rng = np.random.default_rng(3)
    K, R, N = 6, 16, 256
    tables = rng.uniform(0.0, 0.6, (K, R, 128)).astype(np.float32)
    lidx = rng.integers(0, R * 128, (K, N)).astype(np.int32)
    kw = dict(match_dist_min=MDM, match_dist_flat=MDF, match_weight=MW)
    js_, jm_ = j_local_score(jnp.asarray(tables), jnp.asarray(lidx),
                             impl="emulate", trunc=0.6, **kw)
    ts_, tm_ = local_score(_t(tables), _t(lidx), **kw)
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    np.testing.assert_array_equal(tm_.numpy(), np.asarray(jm_))
    assert float(tm_.sum()) > 0


def test_overflow_lookup_and_scatter():
    rng, df, scan, N, pos, rot, js = _with_outliers()
    cap = jog.default_overflow_cap(N)
    jl = jog.build_layout(js, cap)
    q = jog.overflow_transform(js.A, jl.over_idx, scan)
    tq_ = og.overflow_transform(_t(js.A), _t(jl.over_idx, np.int64), _t(scan))
    real = np.asarray(jl.over_idx) < N
    np.testing.assert_allclose(tq_.numpy()[real], np.asarray(q)[real],
                               rtol=1e-6, atol=1e-4)
    codes = og.overflow_field_lookup(port_df(df).field, _t(np.asarray(q)))
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jog.overflow_field_lookup(df.field, q)))
    vals = torch.zeros(N)
    out = og.scatter_overflow(vals, _t(jl.over_idx, np.int64),
                              torch.ones(cap))
    want = np.asarray(jnp.zeros(N).at[jl.over_idx].set(1.0))
    np.testing.assert_array_equal(out.numpy(), want)
