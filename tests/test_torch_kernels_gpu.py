"""CUDA kernels K1, K2, K3 against their plain PyTorch versions on the
card: bit-equal on every slot whose value the caller keeps (the kernels are
built with -fmad=false and keep the plain versions' operation order).
The lookup kernels G1-G10 (``ops/gather_bench.py``), at small sizes with
ragged block edges and at the edges of their schedules, must equal their
plain versions everywhere.  The tier-2 kernels M2-M4 (``march_sphere``,
``march_dda``, ``sample_field``) equal their plain versions bit for bit
on the flagship world's maps, with and without the plain loops' early
exit; the tier-2 models run under ``torch.cuda.set_sync_debug_mode
("error")`` (no host read); under ``torch.func.vmap`` each launches once
and gives every robot's bits.

Skipped without a CUDA device.  On the card, with no JAX installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from mcl_3dl_tpu_torch import worlds
from mcl_3dl_tpu_torch.config import BeamParams, Params
from mcl_3dl_tpu_torch.engine import dda_num_steps, sphere_num_steps
from mcl_3dl_tpu_torch.map.distance_field import (build_distance_field,
                                                  sample_field)
from mcl_3dl_tpu_torch.map.map_data import MapData
from mcl_3dl_tpu_torch.math import cumsum
from mcl_3dl_tpu_torch.math import quat as mq
from mcl_3dl_tpu_torch.models.beam import (BeamVirtualPoints, beam_measure,
                                           grouped_beam_inputs, march_dda,
                                           march_sphere, raycast_df,
                                           raycast_occ)
from mcl_3dl_tpu_torch.models.likelihood import (box_queries, box_tables,
                                                 grouped_like_inputs,
                                                 likelihood_measure)
from mcl_3dl_tpu_torch.ops import build
from mcl_3dl_tpu_torch.ops import grouped as og
from mcl_3dl_tpu_torch.ops import gather_bench as ogb
from mcl_3dl_tpu_torch.ops import local_gather as olg
from mcl_3dl_tpu_torch.tools import (exp_gather, exp_gather2, exp_rowsel_shape,
                                     gather_pairs, to_device)

torch.set_num_threads(2)   # several test workers share the CPU

MDM, MDF, MW = 0.2, 0.05, 5.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cloud(dev, seed, n_tiles=4, K=8):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3.0, 3.0, (300, 3))
    df = build_distance_field(pts, 0.1, 0.6, weights=(1.0, 1.0, 2.0),
                              device=dev)
    scan = torch.tensor(rng.uniform(-1.5, 1.5, (K, 3)), dtype=torch.float32,
                        device=dev)
    n = n_tiles * og.TILE
    pos = torch.tensor(rng.normal(0, 0.04, (n, 3)), dtype=torch.float32,
                       device=dev)
    rpy = np.stack([rng.normal(0, 0.02, n), rng.normal(0, 0.02, n),
                    rng.uniform(-0.3, 0.3, n)], axis=1)
    rot = mq.from_rpy(torch.tensor(rpy, dtype=torch.float32, device=dev))
    active = torch.ones(n, dtype=torch.bool, device=dev)
    rmat = mq.rotation_matrix(mq.normalize(rot))
    stats = og.group_stats(pos, rmat, rot, df.weights, df.cell, df.origin,
                           active)
    return df, scan, stats, og.build_layout(stats, og.default_overflow_cap(n))


def _kept_slots(stats, layout):
    """Sorted slots of in-envelope particles: the overflow bin's slots
    are rescored exactly by the caller, and there the kernels' whole-point
    skip (which the plain versions do not take) is not a no-op."""
    return layout.dest[stats.g != og.G_GROUPS - 1]


def test_like_kernel_matches_plain(cuda):
    df, scan, stats, layout = _cloud(cuda, 5)
    valid = torch.ones(scan.shape[0], dtype=torch.bool, device=cuda)
    lo, fits = og.group_boxes(stats, scan, df.shape)
    assert bool(fits.all())
    args = (layout.A, layout.tile_group,
            *grouped_like_inputs(df, stats, lo, scan, valid, MDM))
    kw = dict(match_dist_min=MDM, match_dist_flat=MDF, match_weight=MW,
              trunc=df.trunc)
    n0 = og.grouped_like_score.launches
    got = og.grouped_like_score(*args, **kw)
    assert og.grouped_like_score.launches == n0 + 1
    want = og.like_score_plain(*args, **kw)
    torch.cuda.synchronize()
    keep = _kept_slots(stats, layout)
    for a, b in zip(got, want):
        assert torch.equal(a[keep], b[keep])
    assert float(got[1][keep].sum()) > 0


@pytest.mark.parametrize("slots", [8, 16, 32, 64, 96])
def test_like_kernel_global_slots_match_plain(cuda, slots):
    """K1 at the slot buckets of a global-mode step (the point ramp masks
    the last quarter of the slots) over 16 tiles."""
    df, scan, stats, layout = _cloud(cuda, 20 + slots, n_tiles=16, K=slots)
    valid = torch.arange(slots, device=cuda) < slots - slots // 4
    lo, fits = og.group_boxes(stats, scan, df.shape)
    assert bool(fits.all())
    args = (layout.A, layout.tile_group,
            *grouped_like_inputs(df, stats, lo, scan, valid, MDM))
    kw = dict(match_dist_min=MDM, match_dist_flat=MDF, match_weight=MW,
              trunc=df.trunc)
    got = og.grouped_like_score(*args, **kw)
    want = og.like_score_plain(*args, **kw)
    torch.cuda.synchronize()
    keep = _kept_slots(stats, layout)
    for a, b in zip(got, want):
        assert torch.equal(a[keep], b[keep])
    assert float(got[1][keep].sum()) > 0


def test_beam_kernel_matches_plain(cuda):
    df, scan, stats, layout = _cloud(cuda, 9, K=3)
    valid = torch.ones(3, dtype=torch.bool, device=cuda)
    labels = torch.zeros(3, dtype=torch.int64, device=cuda)
    origins = torch.zeros((1, 3), device=cuda)
    vp = BeamVirtualPoints(scan, labels, valid, origins, 0.1, 0.3, 20)
    lo, fits = og.group_boxes(stats, vp.vpf, df.shape)
    assert bool((fits | ~vp.chainf[:, None]).all())
    args = (layout.A, layout.tile_group,
            *grouped_beam_inputs(df, stats, lo, vp, valid, 0.1))
    kw = dict(nprobe=vp.nprobe, trunc=df.trunc, grid_min=0.1,
              radius=2.0 ** 0.5 * 0.1 / 2.0, hit_range=0.3,
              sin_total_ref=math.sin(math.pi / 6.0), long_pen=True, tol=0.3)
    got = og.grouped_beam_pen(*args, **kw)
    want = og.beam_pen_plain(*args, **kw)
    torch.cuda.synchronize()
    keep = _kept_slots(stats, layout)
    assert torch.equal(got[keep], want[keep])
    assert float(got[keep].sum()) > 0


# Edge cases of K1/K2's block schedule on inputs built directly: bins of
# the given tile counts (so blocks of several tiles cross bin changes),
# then trailing padding tiles of zero coefficients in the last bin, whose
# slots the caller never keeps (the kept slots are those of the other
# bins).  The skip words are random and every 16-row block they mark holds
# codes 253-255 only, so the skip certificate (no match, entry or hit
# there) holds for every query.
_LAYOUTS = {"bins_1_2_3_5": ((1, 2, 3, 5), 0),
            "bins_5_3_2_1": ((5, 3, 2, 1), 0),
            "padding_tiles": ((2, 3), 3)}
_TRUNC = 1.0
_KW2 = dict(trunc=_TRUNC, grid_min=0.05, radius=2.0 ** 0.5 * 0.1 / 2.0,
            hit_range=0.3, sin_total_ref=math.sin(math.pi / 6.0),
            long_pen=True, tol=0.3)


def _edge_inputs(dev, layout, kk, seed, all_skip_every=3):
    """``(A, tile_group, meta, pts_fp, skip, tables)`` for ``kk`` virtual
    points, and the kept slots; every ``all_skip_every``-th point is
    SKIP_ALL."""
    tiles, pad = _LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    gg = len(tiles) + 1
    tile_group = np.repeat(np.arange(gg), list(tiles) + [pad])
    nt = tile_group.size
    centre = rng.uniform(20.0, 40.0, (gg, 3))
    centre[:, 2] += 70.0
    # queries u = 4 p + centre +- noise: a few cells beyond the window in
    # x and y, inside it in z
    a = np.zeros((nt, 1024, 12))
    a[..., [0, 4, 8]] = 4.0
    a[..., :9] += rng.normal(0.0, 0.3, (nt, 1024, 9))
    a[..., 9:] = centre[tile_group][:, None, :] + rng.normal(0, 1.5, (nt, 1024, 3))
    a[tile_group == gg - 1] = 0.0
    pts = rng.uniform(-1.0, 1.0, (kk, 3))
    lo = np.floor(centre)[None, :, :] - np.array([6, 6, 64])
    lo = np.broadcast_to(lo, (kk, gg, 3)).astype(np.int32)
    meta = np.concatenate([lo, np.zeros((kk, gg, 1), np.int32)], axis=-1)
    skip = rng.integers(0, og.SKIP_ALL + 1, (kk, gg)).astype(np.int32)
    skip[::all_skip_every] = og.SKIP_ALL
    tables = rng.integers(0, 256, (kk, gg, og.NHALF, og.SKIP_GRAN * og.ZW))
    high = rng.integers(253, 256, tables.shape)
    bits = (skip[..., None] >> np.arange(og.NHALF)) & 1
    tables = np.where(bits[..., None] == 1, high, tables)
    t = to_device(dev)
    kept = np.flatnonzero(np.repeat(tile_group != gg - 1, og.TILE))
    return (t(a.transpose(0, 2, 1).astype(np.float32)),
            t(tile_group.astype(np.int32)), t(meta.astype(np.int32)),
            og.points_fp(t(pts.astype(np.float32))), t(skip),
            t(tables.reshape(kk, gg, og.R_ROWS, og.ZW).astype(np.uint8)),
            t(kept))


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_like_kernel_edges_match_plain(cuda, layout):
    A, tg, meta, pfp, skipw, tables, keep = _edge_inputs(cuda, layout, 96, 11)
    kw = dict(match_dist_min=MDM, match_dist_flat=MDF, match_weight=MW,
              trunc=_TRUNC)
    n0 = og.grouped_like_score.launches
    got = og.grouped_like_score(A, tg, meta, pfp, skipw, tables, **kw)
    assert og.grouped_like_score.launches == n0 + 1
    want = og.like_score_plain(A, tg, meta, pfp, skipw, tables, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a[keep], b[keep])
    assert 0 < float(got[1][keep].sum()) < 96 * keep.numel()


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_beam_kernel_edges_match_plain(cuda, layout):
    """61 probes a beam; beam 0 marches all of them, beam 1 stops at
    l_b = 20, beam 2 is invalid; in bin 1 every probe of beam 0 is a hit,
    so all its slots find at the first eligible probe."""
    bb, nprobe = 3, 61
    A, tg, meta, pfp, skip, tables, keep = _edge_inputs(
        cuda, layout, bb * nprobe, 13, all_skip_every=4)
    gg = meta.shape[1]
    tables = tables.reshape(bb, nprobe, gg, og.R_ROWS, og.ZW)
    tables[0, :, 1] = 0
    skip.view(bb, nprobe, gg)[0, :, 1] = 0
    aux = torch.tensor([[4 << 16, 1], [int(0.7 * 65536), 1], [2 << 16, 0]],
                       dtype=torch.int32, device=cuda)
    args = (A, tg, meta, pfp, aux, skip, tables)
    n0 = og.grouped_beam_pen.launches
    got = og.grouped_beam_pen(*args, nprobe=nprobe, **_KW2)
    assert og.grouped_beam_pen.launches == n0 + 1
    want = og.beam_pen_plain(*args, nprobe=nprobe, **_KW2)
    torch.cuda.synchronize()
    assert torch.equal(got[keep], want[keep])
    assert 0 < float(got[keep].sum()) < 2 * keep.numel()


def test_local_kernel_matches_plain(cuda):
    rng = np.random.default_rng(3)
    K, R, N = 6, 16, 4096
    tables = torch.tensor(rng.uniform(0.0, 0.6, (K, R, 128)),
                          dtype=torch.float32, device=cuda)
    lidx = torch.tensor(rng.integers(0, R * 128, (K, N)), dtype=torch.int32,
                        device=cuda)
    kw = dict(match_dist_min=MDM, match_dist_flat=MDF, match_weight=MW)
    got = olg.local_score(tables, lidx, **kw)
    want = olg.local_score_plain(tables, lidx, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [16, 96])
def test_local_kernel_box_tables_match_plain(cuda, k):
    """K3 on the box tables of a 512-slot state (the capacity of a global
    step below 1024), ``k`` points with the last quarter masked."""
    rng = np.random.default_rng(k)
    pts = rng.uniform(-3.0, 3.0, (300, 3))
    df = build_distance_field(pts, 0.1, 0.6, weights=(1.0, 1.0, 2.0),
                              device=cuda)
    n = 512
    pos = torch.tensor(rng.normal(0, 0.1, (n, 3)), dtype=torch.float32,
                       device=cuda)
    rpy = np.stack([rng.normal(0, 0.002, n), rng.normal(0, 0.002, n),
                    rng.normal(0, 0.05, n)], axis=1)
    rmat = mq.rotation_matrix(mq.from_rpy(
        torch.tensor(rpy, dtype=torch.float32, device=cuda)))
    scan = torch.tensor(rng.uniform(-1.5, 1.5, (k, 3)), dtype=torch.float32,
                        device=cuda)
    valid = torch.arange(k, device=cuda) < k - k // 4
    iq, lo, ext = box_queries(df, pos, rmat, scan)
    assert bool(torch.all(ext < torch.tensor([32, 32, 16], device=cuda)))
    tables, lidx = box_tables(df, iq, lo, valid)
    kw = dict(match_dist_min=MDM, match_dist_flat=MDF, match_weight=MW)
    got = olg.local_score(tables, lidx, **kw)
    want = olg.local_score_plain(tables, lidx, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float(got[1].sum()) > 0


# (N, K, lidx offset in elements): K3's forms at their edges.  Below
# SMALL_N the tiled form (K above its 128-point tile takes two rounds);
# from SMALL_N the 4-particle vector form with a ragged last block and K
# not a multiple of the unroll, and the scalar form for a lidx view that
# is not 16-byte aligned or an N that is not a multiple of 4
_SMALL_N = 1 << 17
_LOCAL_EDGES = {"tiled_n128_k1": (128, 1, 0), "tiled_n384_k96": (384, 96, 0),
                "tiled_n384_k130": (384, 130, 0),
                "vec4_ragged": (_SMALL_N + 384, 13, 0),
                "scalar_unaligned": (_SMALL_N + 384, 13, 1),
                "scalar_n_odd": (_SMALL_N + 3, 9, 0)}


@pytest.mark.parametrize("case", list(_LOCAL_EDGES))
def test_local_kernel_edges_match_plain(cuda, case):
    n, k, off = _LOCAL_EDGES[case]
    rng = np.random.default_rng(n + k)
    R = 128
    tables = torch.tensor(rng.uniform(0.0, 0.6, (k, R, 128)),
                          dtype=torch.float32, device=cuda)
    flat = torch.tensor(rng.integers(0, R * 128, k * n + off),
                        dtype=torch.int32, device=cuda)
    lidx = flat[off:].view(k, n)
    assert (lidx.data_ptr() % 16 == 0) == (off == 0)
    kw = dict(match_dist_min=MDM, match_dist_flat=MDF, match_weight=MW)
    got = olg.local_score(tables, lidx, **kw)
    want = olg.local_score_plain(tables, lidx, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == (n,) and torch.equal(a, b)
    assert float(got[1].min()) >= 0 and float(got[1].max()) > 0


def test_wrapper_refuses_wrong_dtype(cuda):
    tables = torch.zeros((2, 1, 128), device=cuda)
    lidx = torch.zeros((2, 128), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        olg.local_score(tables, lidx, match_dist_min=MDM,
                        match_dist_flat=MDF, match_weight=MW)


# small sizes whose row counts leave partial blocks and partial grids
_LOOKUPS = {"exp_gather": lambda d: exp_gather.lookups(d, q=128 * 37,
                                                       risky=True),
            "exp_gather2": lambda d: exp_gather2.lookups(d, q=3 << 14, bq=128),
            "exp_rowsel_shape": lambda d: exp_rowsel_shape.lookups(
                d, nq=128 * 77, tiles=(8, 64))}
_TOOL_OF = dict({t: "exp_gather" for t in ("G1", "G2", "G3", "G4", "G5")},
                G6="exp_gather2", G7="exp_gather2", G8="exp_gather2",
                G9="exp_gather2", G10="exp_rowsel_shape")


@pytest.mark.parametrize("tag", list(_TOOL_OF))
def test_lookup_kernel_matches_plain(cuda, tag):
    for e in _LOOKUPS[_TOOL_OF[tag]](cuda):
        if e.tag != tag:
            continue
        n0 = e.wrapper.launches
        got = e.run()
        assert e.wrapper.launches == n0 + 1
        want = e.plain()
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want), e.name


# G5, G7 and G8 at edge sizes, in query rows of 128 lanes: one row (a
# single warp of int4 groups in a block of eight), ragged last blocks, and
# a million lookups.  G8 takes chunks of 128 rows.
_COL_ROWS = {"one_row": 1, "rows_37": 37, "rows_515": 515, "rows_8195": 8195}


def _col_inputs(dev, rows, seed):
    """A [128, 128] f32 table and [rows, 128] i32 queries in [0, 16384),
    the first four at 0, 127, 16383 and 128."""
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((128, 128)).astype(np.float32)
    idx = rng.integers(0, 128 * 128, (rows, 128), dtype=np.int32)
    idx.flat[:4] = [0, 127, 16383, 128]
    t = to_device(dev)
    return t(tab), t(idx)


@pytest.mark.parametrize("size", sorted(_COL_ROWS))
@pytest.mark.parametrize("off", [1, -5, 2 ** 31 - 3])
def test_sub_gather_edges_match_plain(cuda, size, off):
    """G5; ``off`` -5 wraps negative, 2^31 - 3 overflows int32."""
    tab, idx = _col_inputs(cuda, _COL_ROWS[size], 21)
    n0 = ogb.sub_gather.launches
    got = ogb.sub_gather(tab, idx, off)
    assert ogb.sub_gather.launches == n0 + 1
    want = ogb.sub_gather_plain(tab, idx, off)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("size", sorted(_COL_ROWS))
def test_sublane_gather_edges_match_plain(cuda, size):
    rows = _COL_ROWS[size]
    tab, idx = _col_inputs(cuda, rows, 22)
    idx = idx.view(1, rows, 128)
    n0 = ogb.sublane_gather.launches
    got = ogb.sublane_gather(tab, idx)
    assert ogb.sublane_gather.launches == n0 + 1
    want = ogb.sublane_gather_plain(tab, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("chunks", [1, 3, 33])
def test_transpose_gather_edges_match_plain(cuda, chunks):
    tab, idx = _col_inputs(cuda, 128 * chunks, 23)
    idx = idx.view(chunks, 128, 128)
    got = ogb.transpose_gather(tab, idx)
    want = ogb.transpose_gather_plain(tab, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# G10 at the edges of its tile walk and of its vector path: (queries,
# tile_rows, passes, skew).  With skew 1 the queries start 4 bytes into
# their buffers, so the kernel takes its scalar path.  Tile 1 gives 701
# tiles (more than the blocks resident on the card) or 77 (fewer); tile 64
# is taller than all 1000 queries.
_ROWSEL = {"nq_4099": (4099, 8, 16, 0), "misaligned": (128 * 40 + 3, 8, 16, 1),
           "passes_0": (1000, 8, 0, 0), "passes_1": (1000, 2, 1, 0),
           "tiles_701": (128 * 700 + 5, 1, 16, 0), "tiles_77": (128 * 77, 1, 16, 0),
           "tile_over_nq": (1000, 64, 16, 0)}


@pytest.mark.parametrize("case", sorted(_ROWSEL))
def test_rowsel_edges_match_plain(cuda, case):
    """Rows outside the table (negative ones, the int32 extremes) read 0.0."""
    nq, tile_rows, passes, skew = _ROWSEL[case]
    rng = np.random.default_rng(31)
    tab = rng.uniform(-1.0, 1.0, (144, 128)).astype(np.float32)
    rows = rng.integers(-3, 147, nq + skew).astype(np.int32)
    rows[skew:skew + 6] = [-1, -2 ** 31, 144, 2 ** 31 - 1, 143, 0]
    lanes = rng.integers(-300, 300, nq + skew).astype(np.int32)
    t = to_device(cuda)
    tab, rows, lanes = t(tab), t(rows)[skew:], t(lanes)[skew:]
    assert (rows.data_ptr() % 16 != 0) == bool(skew)
    n0 = ogb.rowsel_accumulate.launches
    got = ogb.rowsel_accumulate(tab, rows, lanes, passes, tile_rows=tile_rows)
    assert ogb.rowsel_accumulate.launches == n0 + 1
    want = ogb.rowsel_plain(tab, rows, lanes, passes)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert passes == 0 or float(got.abs().sum()) > 0


# G3, G6 and G9 (one kernel) in query rows of 128: one row (fewer int4
# groups than one block's share), and counts that do not divide evenly
# among the blocks (37 rows: 2 blocks; 1037: 33; 8195: all resident ones).
# Indices span all of int32, so every one wraps into the table.
_FLAT_ROWS = {"one_row": 1, "rows_37": 37, "rows_1037": 1037, "rows_8195": 8195}


@pytest.mark.parametrize("size", sorted(_FLAT_ROWS))
@pytest.mark.parametrize("tag", ["G3", "G6", "G9"])
def test_flat_gather_edges_match_plain(cuda, tag, size):
    rows = _FLAT_ROWS[size]
    rng = np.random.default_rng(32)
    n_tab = 1024 if tag == "G3" else 128 * 128
    t = to_device(cuda)
    tab = t(rng.standard_normal((n_tab // 128, 128)).astype(np.float32))
    idx = t(rng.integers(-2 ** 31, 2 ** 31, (rows, 128)).astype(np.int32))
    if tag == "G3":
        calls = [(ogb.twostage_gather, (tab, idx, off))
                 for off in (5, -5, 2 ** 31 - 3)]
    else:
        wrapper = ogb.fancy_gather if tag == "G6" else ogb.rowloop_gather
        calls = [(wrapper, (tab, idx.view(1, rows, 128)))]
    for wrapper, args in calls:
        n0 = wrapper.launches
        got = wrapper(*args)
        assert wrapper.launches == n0 + 1
        want = wrapper.plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), args[2:]


def test_launch_follows_current_stream(cuda):
    """The operator launches on torch's current stream: inside
    ``torch.cuda.stream(s)`` on ``s``, and inside a CUDA graph's capture
    on the capturing stream (a launch on any other stream would not be
    captured, and one on the legacy default stream would fail the
    capture); its output, allocated inside the capture, is written by
    the replay."""
    tab, idx = _col_inputs(cuda, 4, 24)
    want = ogb.sub_gather_plain(tab, idx)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        on_s = ogb.sub_gather(tab, idx)
    torch.cuda.current_stream().wait_stream(s)
    on_default = ogb.sub_gather(tab, idx)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ogb.sub_gather(tab, idx)
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(on_s, want) and torch.equal(on_default, want)
    assert torch.equal(captured, want)


def test_refused_lookup_launch_raises(cuda):
    """A table beyond the 227 KB of shared memory a block may have: the
    launch is refused and the wrapper raises; the refusal leaves no error
    behind for the next launch."""
    tab = torch.zeros((1 << 16,), device=cuda)
    idx = torch.zeros((4, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        ogb.fancy_gather(tab, idx)
    small = torch.arange(1 << 14, dtype=torch.float32, device=cuda)
    got = ogb.fancy_gather(small, idx + 3)
    torch.cuda.synchronize()
    assert torch.equal(got, ogb.flat_gather_plain(small, idx + 3))


def test_cumsum_is_reproducible_on_the_card(cuda):
    """The scan of resampling at the main path's 2^20 particles: the same
    bits on every call (``torch.cumsum`` of a whole 1-D tensor is not),
    within f32 rounding of the float64 scan."""
    x = torch.rand(1 << 20, generator=torch.Generator().manual_seed(0))
    xc = x.to(cuda)
    first = cumsum(xc)
    for _ in range(4):
        assert torch.equal(cumsum(xc), first)
    np.testing.assert_allclose(first.cpu().numpy(),
                               np.cumsum(x.numpy().astype(np.float64)),
                               rtol=1e-6)


# G3 at the edges of its direct form: blocks of 256 threads, 2 int4 groups
# a thread (16 rows of 128 a block), a grid sized to the work.  Under one
# block's share, one whole block, a block and a row, and many blocks with
# a ragged last one; tables from 1 entry (shorter than one 16-byte copy)
# to the largest the form takes.
_G3_ROWS = {"one_row": 1, "rows_9": 9, "one_block": 16,
            "block_and_row": 17, "blocks": 16 * 132 * 9 + 37}


@pytest.mark.parametrize("n_tab", [1, 4, 1024, 4096])
@pytest.mark.parametrize("size", sorted(_G3_ROWS))
def test_twostage_gather_edges_match_plain(cuda, size, n_tab):
    rows = _G3_ROWS[size]
    rng = np.random.default_rng(33)
    t = to_device(cuda)
    tab = t(rng.standard_normal(n_tab).astype(np.float32))
    idx = t(rng.integers(-2 ** 31, 2 ** 31, (rows, 128)).astype(np.int32))
    for off in (5, -5, 2 ** 31 - 3):
        n0 = ogb.twostage_gather.launches
        got = ogb.twostage_gather(tab, idx, off)
        assert ogb.twostage_gather.launches == n0 + 1
        want = ogb.flat_gather_plain(tab, idx, off)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (size, n_tab, off)


# G4 at row counts that are not a multiple of its 32 rows a block, every
# u8 value in the table and offsets that wrap
@pytest.mark.parametrize("rows", [1, 37, 64, 65, 1000, 131072 + 5])
def test_lane_gather_u8_edges_match_plain(cuda, rows):
    rng = np.random.default_rng(34)
    tab = np.stack([rng.permutation(256)[:128] for _ in range(rows)])
    tab[0, :] = np.arange(128) * 2 + 1
    t = to_device(cuda)
    tab = t(tab.astype(np.uint8))
    idx = t(rng.integers(-2 ** 31, 2 ** 31, (rows, 128)).astype(np.int32))
    seen = set()
    for off in (0, 7, -3, 2 ** 31 - 1):
        got = ogb.lane_gather_u8(tab, idx, off)
        want = ogb.row_gather_plain(tab, idx, off)
        torch.cuda.synchronize()
        assert got.dtype == torch.uint8 and torch.equal(got, want), off
        seen |= set(got.unique().tolist())
    if rows >= 1000:
        assert seen == set(range(256))


# G3 through the ring variant (MCL_G3_RING): tiles of 64 rows of 128 lanes,
# one block an SM, 4 stages.  Under one tile, one tile, a tile and a row,
# and tiles that go round each block's ring more than twice with a short
# last tile; tables from 1 entry to the largest G3 takes.
_RING_ROWS = {"rows_9": 9, "one_tile": 64, "tile_and_row": 65,
              "rounds": 64 * 132 * 9 + 37}


@pytest.mark.parametrize("store", ["g3_ring", "g3_ring_bulk"])
def test_g3_ring_variant_matches_plain(cuda, store):
    other = gather_pairs.variant(store, gather_pairs.VARIANTS[store])
    rng = np.random.default_rng(36)
    t = to_device(cuda)
    for n_tab in (1, 4, 1024, 4096):
        tab = t(rng.standard_normal(n_tab).astype(np.float32))
        for size, rows in _RING_ROWS.items():
            idx = t(rng.integers(-2 ** 31, 2 ** 31, (rows, 128)).astype(np.int32))
            for off in (5, -5, 2 ** 31 - 3):
                got = other.gather_bench.twostage_gather(tab, idx, off)
                want = ogb.flat_gather_plain(tab, idx, off)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (store, size, n_tab, off)


def _misaligned(t):
    """``t``'s values in a view 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() * t.element_size() + 4, dtype=torch.uint8,
                       device=t.device)
    view = flat[4:].view(t.dtype).view(t.shape)
    view.copy_(t)
    return view


def _bad_calls(dev):
    """Every operator through its wrapper with one argument at fault:
    ``{case: (call, exception, message)}``."""
    f32, i32 = torch.float32, torch.int32
    tab = torch.zeros((128, 128), device=dev)
    idx = torch.zeros((4, 128), dtype=i32, device=dev)
    u8 = torch.zeros((4, 128), dtype=torch.uint8, device=dev)
    small = torch.zeros((8, 128), device=dev)
    tabs = torch.zeros((2, 3, 128), device=dev)
    lidx = torch.zeros((2, 5), dtype=i32, device=dev)
    kw = dict(match_dist_min=MDM, match_dist_flat=MDF, match_weight=MW)
    df, scan, stats, layout = _cloud(dev, 7, n_tiles=1, K=2)
    lo, _ = og.group_boxes(stats, scan, df.shape)
    like = grouped_like_inputs(df, stats, lo, scan,
                               torch.ones(2, dtype=torch.bool, device=dev), MDM)
    kl = dict(match_dist_min=MDM, match_dist_flat=MDF, match_weight=MW,
              trunc=float(df.trunc))
    cpu = torch.device("cpu")
    return {
        "flat_idx_on_cpu": (lambda: ogb.twostage_gather(small, idx.to(cpu)),
                            ValueError, "idx must be a CUDA tensor"),
        "flat_idx_dtype": (lambda: ogb.twostage_gather(small, idx.long()),
                           ValueError, "idx has dtype torch.int64, expected "
                           "torch.int32"),
        "flat_idx_lanes": (lambda: ogb.twostage_gather(small, idx[:, :64]),
                           ValueError, r"idx must end in 128 lanes, got \(4, 64\)"),
        "flat_idx_aligned": (lambda: ogb.twostage_gather(small, _misaligned(idx)),
                             ValueError, "idx must be 16-byte aligned"),
        "flat_tab_pow2": (lambda: ogb.twostage_gather(small[:3], idx),
                          ValueError, "tab.numel\\(\\) must be a power of two"),
        "flat_off_int32": (lambda: ogb.twostage_gather(small, idx, 2 ** 31),
                           ValueError, "off=2147483648 does not fit int32"),
        "row_tab_dtype": (lambda: ogb.lane_gather_u8(tab, idx), ValueError,
                          "tab has dtype torch.float32, expected torch.uint8"),
        "row_idx_shape": (lambda: ogb.lane_gather_u8(u8, idx[:3]), ValueError,
                          r"idx has shape \(3, 128\), expected \(4, 128\)"),
        "row_tab_aligned": (lambda: ogb.lane_gather(_misaligned(tab[:4]), idx),
                            ValueError, "tab must be 16-byte aligned"),
        "row_tab_contiguous": (lambda: ogb.lane_gather(
            torch.zeros((128, 4), device=dev).t(), idx),
                               ValueError, "tab must be contiguous"),
        "col_tab_shape": (lambda: ogb.sub_gather(tabs, idx), ValueError,
                          r"tab must be \[R, 128\], got \(2, 3, 128\)"),
        "col_idx_on_cpu": (lambda: ogb.sub_gather(tab, idx.to(cpu)),
                           ValueError, "idx must be a CUDA tensor"),
        "rowsel_lanes_shape": (lambda: ogb.rowsel_accumulate(
            tab, idx, idx[:3]), ValueError,
            r"lanes has shape \(3, 128\), expected \(4, 128\)"),
        "rowsel_rows_dtype": (lambda: ogb.rowsel_accumulate(
            tab, idx.float(), idx), ValueError,
            "rows has dtype torch.float32, expected torch.int32"),
        "local_lidx_dtype": (lambda: olg.local_score(tabs, lidx.long(), **kw),
                             ValueError, "lidx has dtype torch.int64"),
        "local_lidx_shape": (lambda: olg.local_score(tabs, lidx[:1], **kw),
                             ValueError, r"lidx has shape \(1, 5\), expected "
                             r"\(2, 5\)"),
        "like_meta_dtype": (lambda: og.grouped_like_score(
            layout.A, layout.tile_group, like[0].long(), *like[1:], **kl),
            ValueError, "meta has dtype torch.int64, expected torch.int32"),
        "like_tables_on_cpu": (lambda: og.grouped_like_score(
            layout.A, layout.tile_group, *like[:3], like[3].to(cpu), **kl),
            ValueError, "tables must be a CUDA tensor"),
        "like_tile_group_shape": (lambda: og.grouped_like_score(
            layout.A, layout.tile_group[:-1], *like, **kl), ValueError,
            "tile_group has shape"),
    }


_BAD = ("flat_idx_on_cpu flat_idx_dtype flat_idx_lanes flat_idx_aligned "
        "flat_tab_pow2 flat_off_int32 row_tab_dtype row_idx_shape "
        "row_tab_aligned row_tab_contiguous col_tab_shape col_idx_on_cpu "
        "rowsel_lanes_shape rowsel_rows_dtype local_lidx_dtype "
        "local_lidx_shape like_meta_dtype like_tables_on_cpu "
        "like_tile_group_shape").split()


@pytest.mark.parametrize("case", _BAD)
def test_op_refuses_bad_tensors(cuda, case):
    """Each operator refuses a tensor on the wrong device, of the wrong
    dtype or shape, not contiguous or not 16-byte aligned, with the
    message the Python checks gave, and launches nothing."""
    call, exc, msg = _bad_calls(cuda)[case]
    counts = [w.launches for w in ogb.WRAPPERS]
    with pytest.raises(exc, match=msg):
        call()
    assert [w.launches for w in ogb.WRAPPERS] == counts


def test_two_builds_in_one_process(cuda):
    """Another build of the package (a block-shape variant of G4) loads
    beside this one: its operators live in their own namespace, and each
    build's wrappers launch its own kernels."""
    other = gather_pairs.variant("g4_64rows", gather_pairs.VARIANTS["g4_64rows"])
    assert other.build.namespace() != build.namespace()
    other_ns, ns = other.build.library(), build.library()
    assert other_ns is not ns
    rng = np.random.default_rng(35)
    t = to_device(cuda)
    tab = t(rng.integers(0, 256, (77, 128)).astype(np.uint8))
    idx = t(rng.integers(0, 128, (77, 128)).astype(np.int32))
    want = ogb.row_gather_plain(tab, idx, 3)
    n0, m0 = ogb.lane_gather_u8.launches, other.gather_bench.lane_gather_u8.launches
    mine = ogb.lane_gather_u8(tab, idx, 3)
    theirs = other.gather_bench.lane_gather_u8(tab, idx, 3)
    torch.cuda.synchronize()
    assert torch.equal(mine, want) and torch.equal(theirs, want)
    assert ogb.lane_gather_u8.launches == n0 + 1
    assert other.gather_bench.lane_gather_u8.launches == m0 + 1


# ---- M2-M4 (csrc/tier2.cu)

_ORIGIN = np.array([0.0, 0.0, worlds.SENSOR_Z])


@pytest.fixture(scope="module")
def flagship():
    """The flagship world's maps on the card, labels 0-2 with
    ``filter_label_max`` 1 (a label-filtered beam field and grid)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pts = worlds.world_map()
    labels = np.random.default_rng(7).integers(0, 3, len(pts)).astype(
        np.uint32)
    params = Params(beam=BeamParams(filter_label_max=1))
    return params, MapData.build(pts, params, labels, device="cuda")


def _t2_rays(seed, n, spread):
    """``(begins, ends)`` [n // 3, 3, 3] on the card: from about the sensor
    origin to scan points, poses spread by ``spread`` m (and 0.2 * spread
    rad of yaw); 7 zero-length rays and 7 that begin outside the map."""
    rng = np.random.default_rng(seed)
    pts = worlds.scan(rng, n)
    yaw = rng.normal(0.0, 0.2 * spread, n)
    c, s = np.cos(yaw), np.sin(yaw)
    shift = np.stack([rng.normal(0, spread, n), rng.normal(0, spread, n),
                      rng.normal(0, 0.05, n)], axis=1)
    ends = np.stack([c * pts[:, 0] - s * pts[:, 1],
                     s * pts[:, 0] + c * pts[:, 1], pts[:, 2]], axis=1) + shift
    begins = _ORIGIN[None] + shift
    ends[:7] = begins[:7]
    begins[7:14] += np.array([40.0, -30.0, 5.0])
    t = to_device(torch.device("cuda"))
    return (t(begins.astype(np.float32)).reshape(-1, 3, 3),
            t(ends.astype(np.float32)).reshape(-1, 3, 3))


def _equal(got, want):
    for a, w in zip(got, want, strict=True):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert torch.equal(a, w)


@pytest.mark.parametrize("early_exit", [True, False], ids=["early", "fixed"])
@pytest.mark.parametrize("spread", [0.05, 1.0, 30.0])
def test_march_sphere_matches_plain(flagship, spread, early_exit):
    p, m = flagship
    b, e = _t2_rays(21, 3 * 8192, spread)
    args = (m.df_beam, b, e, p.map_grid_min, p.map_grid_max,
            p.beam.hit_range, sphere_num_steps(p))
    before = march_sphere.launches
    got = march_sphere(*args, early_exit=early_exit)
    want = raycast_df(*args, early_exit=early_exit)
    torch.cuda.synchronize()
    assert march_sphere.launches == before + 1
    _equal(got, want)
    if spread < 1.0:
        assert 0.05 < float(got[0].float().mean()) < 1.0


@pytest.mark.parametrize("early_exit", [True, False], ids=["early", "fixed"])
@pytest.mark.parametrize("refine", [True, False], ids=["perp", "voxel"])
@pytest.mark.parametrize("spread", [0.05, 30.0])
def test_march_dda_matches_plain(flagship, spread, refine, early_exit):
    p, m = flagship
    rah, mdts = ((p.beam.ray_angle_half, p.min_dist_thr_sq) if refine
                 else (0.0, 0.0))
    b, e = _t2_rays(22, 3 * 8192, spread)
    args = (m.occ, b, e, p.beam.hit_range, 1, dda_num_steps(p), rah, mdts)
    before = march_dda.launches
    got = march_dda(*args, early_exit=early_exit)
    want = raycast_occ(*args, early_exit=early_exit)
    torch.cuda.synchronize()
    assert march_dda.launches == before + 1
    _equal(got, want)
    if spread < 1.0:
        assert 0.05 < float(got[0].float().mean()) < 1.0


@pytest.mark.parametrize("mode", ["nearest", "trilinear", "eight_corners"])
def test_sample_field_matches_plain(flagship, mode):
    _, m = flagship
    df = m.df
    if mode == "eight_corners":
        df = dataclasses.replace(df, packed=None)
    rng = np.random.default_rng(23)
    q = rng.uniform([-7.0, -7.0, -1.0], [7.0, 7.0, 3.5], (4096, 96, 3))
    q[:64] = np.round(q[:64] * 20.0) / 20.0      # on the 0.05 m grid
    q = to_device(torch.device("cuda"))(q.astype(np.float32))
    tri = mode != "nearest"
    before = sample_field.launches
    got = sample_field(df, q, tri)
    want = df.sample_trilinear(q) if tri else df.sample_nearest(q)
    torch.cuda.synchronize()
    assert sample_field.launches == before + 1
    _equal((got,), (want,))
    assert 0.05 < float((got < df.trunc).float().mean()) < 1.0


def _tier2_inputs(n):
    """``n`` poses about the origin, 96 scan points and the sensor origin
    on the card."""
    rng = np.random.default_rng(24)
    t = to_device(torch.device("cuda"))
    pos = t(rng.normal(0, 0.1, (n, 3)).astype(np.float32))
    rot = mq.from_rpy(t(rng.normal(0, 0.05, (n, 3)).astype(np.float32)))
    pts = t(worlds.scan(rng, 96).astype(np.float32))
    return (pos, rot, pts, torch.ones(96, dtype=torch.bool, device="cuda"),
            torch.zeros(3, dtype=torch.int64, device="cuda"),
            t(_ORIGIN[None].astype(np.float32)))


def _tier2_models(p, m, inputs):
    """The tier-2 models on ``inputs`` (``_tier2_inputs``): the beam
    through M2 and M3, the likelihood nearest (no box path below 128
    particles) and trilinear through M4."""
    pos, rot, pts, valid, idx, origins = inputs
    bp = p.beam
    kw = dict(map_grid_min=p.map_grid_min, map_grid_max=p.map_grid_max,
              hit_range=bp.hit_range, beam_likelihood_min=bp.beam_likelihood,
              num_points_default=3, sin_total_ref=0.5,
              add_penalty_short_only_mode=False, occ=m.occ,
              filter_label_max=bp.filter_label_max,
              ray_angle_half=bp.ray_angle_half,
              min_dist_thr_sq=p.min_dist_thr_sq)
    lp = p.likelihood
    like = (m.df, pos, rot, pts, valid, lp.match_dist_min,
            lp.match_dist_flat, lp.match_weight)
    return (beam_measure(m.df_beam, pos, rot, pts[:3], idx, valid[:3],
                         origins, num_steps=sphere_num_steps(p), **kw),
            beam_measure(m.df_beam, pos, rot, pts[:3], idx, valid[:3],
                         origins, num_steps=dda_num_steps(p), use_dda=True,
                         **kw),
            likelihood_measure(*like),
            likelihood_measure(*like, trilinear=True))


def test_tier2_models_read_nothing_on_the_host(flagship):
    """Beam (DF and DDA) and tier-2 likelihood (nearest and trilinear)
    make no synchronizing call once warm (kernels built, constants
    made)."""
    p, m = flagship
    inputs = _tier2_inputs(64)
    want = _tier2_models(p, m, inputs)
    counts = [k.launches for k in (march_sphere, march_dda, sample_field)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = _tier2_models(p, m, inputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert [k.launches for k in (march_sphere, march_dda, sample_field)] == [
        counts[0] + 1, counts[1] + 1, counts[2] + 2]
    for g, w in zip(got, want):
        assert [x for x in g if not torch.is_tensor(x)] == [
            x for x in w if not torch.is_tensor(x)]
        _equal([x for x in g if torch.is_tensor(x)],
               [x for x in w if torch.is_tensor(x)])
    assert got[2][2] == got[3][2] == 2                  # tier 2


def test_vmap_launches_once_with_every_robots_bits(flagship):
    """Under ``torch.func.vmap`` each tier-2 kernel folds the robots into
    its rays or queries (``build.fold_rule``): one launch for the batch
    through the wrapper, and each robot's outputs equal to the operator
    called on that robot alone (the marches on per-robot set-ups, one
    argument also unbatched)."""
    from mcl_3dl_tpu_torch.models import beam as mb

    p, m = flagship
    rays = [_t2_rays(30 + i, 3 * 512, 0.5) for i in range(4)]
    b = torch.stack([r[0] for r in rays])
    e = torch.stack([r[1] for r in rays])
    q = torch.cat([b, e], dim=2)                      # [4, 512, 6, 3]
    sphere = (p.map_grid_min, p.map_grid_max, p.beam.hit_range,
              sphere_num_steps(p))
    dda = (p.beam.hit_range, 1, dda_num_steps(p), p.beam.ray_angle_half,
           p.min_dist_thr_sq)
    wrapped = ((sample_field, lambda x: sample_field(m.df, x, True), (q,)),
               (march_sphere, lambda x, y: march_sphere(m.df_beam, x, y,
                                                        *sphere), (b, e)),
               (march_dda, lambda x, y: march_dda(m.occ, x, y, *dda), (b, e)))
    for wrapper, fn, args in wrapped:
        before = wrapper.launches
        got = torch.func.vmap(fn)(*args)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1, wrapper.__name__
        got = got if isinstance(got, tuple) else (got,)
        assert all(g.shape[0] == 4 for g in got)
        if wrapper is sample_field:       # no set-up around the kernel
            for i in range(4):
                _equal((got[0][i],), (fn(q[i]),))

    df, occ = m.df_beam, m.occ
    trunc = float(df.trunc)
    w = [float(np.float32(x)) for x in df.weights]
    f32 = lambda x: float(np.float32(x))        # noqa: E731
    op_s = build.op("march_sphere")
    op_d = build.op("march_dda")

    def sphere_op(bb, d, mt, wu):
        return op_s(bb, d, mt, wu, df.field, df.origin, sphere[3], *w,
                    f32(df.cell), f32(trunc / 255.0), f32(trunc),
                    f32(p.map_grid_min), f32(2.0 ** 0.5 * p.map_grid_max / 2),
                    f32(trunc * 0.99))

    def dda_op(bb, d, mt, inside, bv):
        return op_d(bb, d, mt, inside, bv, occ.occupied, occ.min_label,
                    occ.rep_point, occ.origin, dda[2], f32(occ.cell * 0.5),
                    f32(occ.cell), 1, f32(dda[3]), f32(dda[4]), True)

    flat_b = b.reshape(4, -1, 3)
    flat_e = e.reshape(4, -1, 3)
    s_set = [mb._sphere_setup(df, flat_b[i], flat_e[i], p.map_grid_min,
                              p.beam.hit_range) for i in range(4)]
    d_set = [mb._dda_setup(occ, flat_b[i], flat_e[i], p.beam.hit_range)
             for i in range(4)]
    s_args = [flat_b] + [torch.stack(x) for x in zip(*s_set)]
    d_args = [flat_b] + [torch.stack(x) for x in zip(*d_set)]
    for op, args, dims in ((sphere_op, s_args, (0, 0, 0, 0)),
                           (dda_op, d_args, (0, 0, 0, 0, 0)),
                           (sphere_op, [flat_b[0]] + s_args[1:],
                            (None, 0, 0, 0))):
        got = torch.func.vmap(op, in_dims=dims)(*args)
        for i in range(4):
            want = op(*(a if d is None else a[i] for a, d in zip(args, dims)))
            _equal([g[i] for g in got], want)
