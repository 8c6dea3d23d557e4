"""CUDA kernels K1, K2, K3 against their plain PyTorch versions on the
card: bit-equal on every slot whose value the caller keeps (the kernels are
built with -fmad=false and keep the plain versions' operation order).
The lookup kernels G1-G10 (``ops/gather_bench.py``), at small sizes with
ragged block edges and at the edges of their schedules, must equal their
plain versions everywhere.

Skipped without a CUDA device.  On the card, with no JAX installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""

import math

import numpy as np
import pytest
import torch

from mcl_3dl_tpu_torch.map.distance_field import build_distance_field
from mcl_3dl_tpu_torch.math import cumsum
from mcl_3dl_tpu_torch.math import quat as mq
from mcl_3dl_tpu_torch.models.beam import (BeamVirtualPoints,
                                           grouped_beam_inputs)
from mcl_3dl_tpu_torch.models.likelihood import (box_queries, box_tables,
                                                 grouped_like_inputs)
from mcl_3dl_tpu_torch.ops import build
from mcl_3dl_tpu_torch.ops import grouped as og
from mcl_3dl_tpu_torch.ops import gather_bench as ogb
from mcl_3dl_tpu_torch.ops import local_gather as olg
from mcl_3dl_tpu_torch.tools import (exp_gather, exp_gather2, exp_rowsel_shape,
                                     to_device)

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


def test_launch_follows_current_stream(cuda, monkeypatch):
    """``build.launch`` passes the current stream's raw handle: inside
    ``torch.cuda.stream(s)`` it is ``s``'s, outside it the default one."""
    build.library()
    real = build._fns["mcl_col_gather"]
    seen = []

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    monkeypatch.setitem(build._fns, "mcl_col_gather", spy)
    tab, idx = _col_inputs(cuda, 4, 24)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        on_s = ogb.sub_gather(tab, idx)
    torch.cuda.current_stream().wait_stream(s)
    on_default = ogb.sub_gather(tab, idx)
    torch.cuda.synchronize()
    assert seen == [s.cuda_stream, torch.cuda.default_stream().cuda_stream]
    assert torch.equal(on_s, on_default)


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
