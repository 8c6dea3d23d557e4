"""Kernels K1 (``grouped_like_score``), K2 (``grouped_beam_pen``) and K3
(``local_score``) of this package against other builds of them, timed in
turns at the main path's final state on the card.

    python -m mcl_3dl_tpu_torch.tools.grouped_pairs [--pairs 5] [NAME=DIR ...]

Each ``DIR`` is another copy of the ``mcl_3dl_tpu_torch`` package (an
older commit's, or one with an edited ``csrc/grouped.cu``).  Its kernels
are built from its own sources by its own ``ops/build.py`` and launched
through its own wrappers (``load_copy``), so each build's whole launch
path is timed: an older copy's ctypes calls, this one's torch
operators.  The state is the one ``chip_smoke.py`` measures at (``engine`` and
``drive``, which it shares): 1,048,576 particles on the flagship room
world, a coarse initial pose measured once, then the tracking spread and
ten scans to tiers 0/0.

K1, K2 and then K3 (``local_case``: 96 points x 1M particles on this
state's tier-1 box tables) are timed, and K3 once more at the global
shape (``global_local_case``: the 512-capacity, 16-point step of the
global-recovery episodes that ``chip_smoke.py`` phase 7 drives, with the
device floor of one launch beside it).  In each of ``--pairs`` rounds
every build is timed once (``time_ms``, the median of 25 launches, and
``tools.device_ms``, a captured graph of 25), in list order in even
rounds and reversed in odd ones.  Printed per kernel and build: the
median and quartiles over the rounds, the ratio to the byte/operation
bound, in how many rounds this package's kernel was faster, the median
device time of a call and the host time of a call (``tools.host_ms``,
once), and whether the build's output equals the plain version on the
slots the caller keeps (a build that skips its lookups does not).  Every line carries the card's ``nvidia-smi`` name and
power limit.

``stats_agreement`` holds kernel M5's grouping statistics to their plain
version's (``chip_smoke.py`` phase 4 and the card tests).
"""

from __future__ import annotations

import argparse
import importlib.util
import statistics
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from mcl_3dl_tpu_torch import MCL3DL, Params, worlds
from mcl_3dl_tpu_torch.models.beam import grouped_beam_inputs
from mcl_3dl_tpu_torch.models.likelihood import (box_queries, box_tables,
                                                 grouped_like_inputs)
from mcl_3dl_tpu_torch.ops import build
from mcl_3dl_tpu_torch.ops import grouped as og
from mcl_3dl_tpu_torch.ops import local_gather as olg
from mcl_3dl_tpu_torch.tools import (bound, card, device_ms, host_ms,
                                     time_ms)

NUM_PARTICLES = 1 << 20
CLOUD_POINTS = 4096
# initial pose wide in x/y, tight in attitude (the likelihood model's box
# tier scores the first scan), then the tracking spread
COARSE_COV = np.diag([0.2 ** 2, 0.2 ** 2, 0.002 ** 2, 0.002 ** 2,
                      0.002 ** 2, 0.005 ** 2])
N_SCANS = 10


def engine(device="cuda"):
    """The main path's engine: ``MCL3DL`` at 1,048,576 particles with the
    beam model, on the flagship room world's map."""
    eng = MCL3DL(Params(num_particles=NUM_PARTICLES, use_beam_model=True),
                 device=device)
    eng.load_map(worlds.world_map())
    return eng


def drive(eng, rng, on_step=None):
    """The main path's drive, the robot standing at the origin: a coarse
    initial pose and two scans, then the tracking spread and ``N_SCANS``
    scans.  ``on_step(seconds, result)`` sees each measurement's
    ``push_cloud`` time (synchronised) and result.  Returns the time
    stamp of the next scan."""
    ident = np.array([0.0, 0.0, 0.0, 1.0])
    origin = np.array([0.0, 0.0, worlds.SENSOR_Z])
    eng.initial_pose(np.zeros(3), ident, COARSE_COV)
    t = 0.0
    for i in range(2 + N_SCANS):
        if i == 2:
            eng.initial_pose(np.zeros(3), ident, worlds.TRACKING_COV)
        eng.odometry(np.zeros(3), ident, t)
        cloud = worlds.scan(rng, CLOUD_POINTS)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = eng.push_cloud("lidar", cloud, origin, t)
        torch.cuda.synchronize()
        if res is not None and on_step is not None:
            on_step(time.perf_counter() - t1, res)
        t += 0.1
    return t


def kernel_inputs(eng, scan):
    """K1's and K2's arguments at the engine's state for ``scan``, with
    everything they are made from, their byte and operation counts and
    the slots the caller keeps (``kept``): a namespace."""
    p = eng.params
    lp, bp = p.likelihood, p.beam
    origin = np.array([0.0, 0.0, worlds.SENSOR_Z])
    _, cloud_t = eng.prepare_cloud(scan, np.zeros(len(scan), np.int64),
                                   origin[None].astype(np.float32))
    st = eng.pstate
    mask = st.active_mask()
    (like_pts, like_valid, beam_pts, beam_labels, beam_valid, _,
     _) = eng.sample_points(*cloud_t[:3])
    df, df_beam = eng.map.df, eng.map.df_beam
    group_args = (st.pos, st.rot, mask, df, df_beam, like_pts, like_valid,
                  beam_pts, beam_labels, beam_valid, cloud_t[3])
    rmat, g_like, g_beam = eng.group(*group_args)
    assert g_like[3] and g_beam[3], "kernel inputs need fitting boxes"
    stats, layout, lo_l, _ = g_like
    _, _, lo_b, _, vp = g_beam
    like, like_kw, like_bound, kept = like_case(df, lp, stats, layout, lo_l,
                                                like_pts, like_valid)
    beam = grouped_beam_inputs(df_beam, stats, lo_b, vp, beam_valid,
                               p.map_grid_max)
    beam_kw = dict(nprobe=vp.nprobe, trunc=float(df_beam.trunc),
                   grid_min=p.map_grid_min,
                   radius=2.0 ** 0.5 * p.map_grid_max / 2.0,
                   hit_range=bp.hit_range,
                   sin_total_ref=float(np.sin(bp.ang_total_ref)),
                   long_pen=not bp.add_penalty_short_only_mode,
                   tol=bp.hit_range)
    nt, coef, live = _bound_parts(layout)
    bmeta, bpfp, baux, bskip, _ = beam
    b_tab, b_look = live(bskip)
    beam_bytes = (coef + (bmeta.numel() + bpfp.numel() + baux.numel()
                          + bskip.numel()) * 4 + b_tab * og.R_ROWS * og.ZW
                  + nt * og.TILE * 4)
    return types.SimpleNamespace(
        like=like, like_kw=like_kw,
        beam=(layout.A, layout.tile_group, *beam), beam_kw=beam_kw,
        like_bound=like_bound, beam_bound=(beam_bytes, b_look * 30),
        kept=kept,
        stats=stats, layout=layout, lo_l=lo_l, lo_b=lo_b, vp=vp,
        cloud=cloud_t, rmat=rmat, group_args=group_args,
        like_pts=like_pts, like_valid=like_valid, beam_pts=beam_pts,
        beam_labels=beam_labels, beam_valid=beam_valid)


def _bound_parts(layout):
    """``(tiles, bytes of the tile inputs, live)`` of a layout for the
    kernels' bounds: each input read once, each output written once;
    ``live(skip)`` counts the tables and lookups of the live (point, bin)
    pairs of bins that have tiles."""
    nt = layout.A.shape[0]
    tiles_per_bin = torch.bincount(layout.tile_group.long(),
                                   minlength=og.G_GROUPS)

    def live(skip):
        m = (skip != og.SKIP_ALL) & (tiles_per_bin > 0)[None, :]
        return (int(m.sum()),
                int((m.long() * tiles_per_bin[None, :]).sum()) * og.TILE)

    return nt, nt * 12 * og.TILE * 4 + nt * 4, live


def like_case(df, lp, stats, layout, lo, points, valid):
    """K1 at a grouped state: ``(args, kw, (bytes, ops), kept)``, ``kept``
    the slots of in-envelope particles (the overflow bin's slots are
    rescored exactly by the caller, and there the kernel's skips, which
    the plain version does not take, are not no-ops)."""
    like = grouped_like_inputs(df, stats, lo, points, valid,
                               lp.match_dist_min)
    kw = dict(match_dist_min=lp.match_dist_min,
              match_dist_flat=lp.match_dist_flat,
              match_weight=lp.match_weight, trunc=float(df.trunc))
    nt, coef, live = _bound_parts(layout)
    meta, pfp, skipw, _ = like
    n_tab, n_look = live(skipw)
    nbytes = (coef + (meta.numel() + pfp.numel() + skipw.numel()) * 4
              + n_tab * og.R_ROWS * og.ZW + 2 * nt * og.TILE * 4)
    return ((layout.A, layout.tile_group, *like), kw, (nbytes, n_look * 25),
            layout.dest[stats.g != og.G_GROUPS - 1])


def local_case(df, lp, pos, rmat, points, valid):
    """K3 at a state: its box tables and queries, ``(args, kw, (bytes,
    ops), kept)`` with every slot kept."""
    iq, lo, _ = box_queries(df, pos, rmat, points)
    tables, lidx = box_tables(df, iq, lo, valid)
    kw = dict(match_dist_min=lp.match_dist_min,
              match_dist_flat=lp.match_dist_flat, match_weight=lp.match_weight)
    n = lidx.shape[1]
    nbytes = tables.numel() * 4 + lidx.numel() * 4 + 2 * n * 4
    return ((tables, lidx), kw, (nbytes, lidx.numel() * 8),
            torch.arange(n, device=lidx.device))


def stats_agreement(got, want, n):
    """M5's ``GroupStats`` (``got``) against its plain version's
    (``want``) on the same ``n`` particles: ``(share of g equal, largest
    gap of the bounds)``.  Raises ``AssertionError`` unless shapes and
    dtypes match, ``A`` is bit-equal, ``g`` is equal on >= 99.9% of
    particles (sums in another order, libm ulps at bin edges), the bounds
    are within rtol 1e-5 (atol 1e-5 cells, for a bound near 0),
    ``any_active`` is equal and ``n_over`` within 0.1% of ``n``."""
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    assert torch.equal(got.A, want.A), "group_stats: A != plain"
    agree = float((got.g == want.g).float().mean())
    assert agree >= 0.999, agree
    bounds = ((got.a_min, want.a_min), (got.a_max, want.a_max))
    for a, b in bounds:
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert torch.equal(got.any_active, want.any_active)
    assert abs(int(got.n_over) - int(want.n_over)) <= 0.001 * n, (
        int(got.n_over), int(want.n_over))
    return agree, max(float((a - b).abs().max()) for a, b in bounds)


def march_case(eng, inp):
    """M1 (``march_fixed``) at the main path's overflow rescore: the rays
    ``_overflow_beam_pen`` marches for the layout of ``inp``
    (``kernel_inputs``), ``[cap, B]`` from each overflow slot's sensor
    origin to its beam points.  ``(args, (bytes, ops), kept)``: each ray's
    begin and end read and its three outputs written once, the field once;
    ~22 f32 operations a probe over the probes these rays take (to the
    first hit or the limit, from the plain version's outputs); every row
    kept."""
    from mcl_3dl_tpu_torch.engine import beam_num_steps
    from mcl_3dl_tpu_torch.math import quat as mq
    from mcl_3dl_tpu_torch.models.beam import _ray, raycast_fixed

    p = eng.params
    st = eng.pstate
    idx = torch.clamp(inp.layout.over_idx, max=st.capacity - 1)
    rmatc = mq.rotation_matrix(mq.normalize(st.rot[idx]))
    posc = st.pos[idx]
    org = inp.cloud[3][inp.beam_labels]
    begins = torch.einsum("bj,cij->cbi", org, rmatc) + posc[:, None, :]
    ends = torch.einsum("bj,cij->cbi", inp.beam_pts, rmatc) + posc[:, None, :]
    df = eng.map.df_beam
    steps = beam_num_steps(p)
    args = (df, begins, ends, p.map_grid_min, p.map_grid_max,
            p.beam.hit_range, steps)
    found, cpos, _ = raycast_fixed(*args)
    # the probes each ray takes: i = 1 .. to its hit, or while i < l_b
    length, _ = _ray(begins, ends)
    l_b = torch.floor((length + p.beam.hit_range) / p.map_grid_min)
    last = torch.clamp(l_b - 1.0, 0.0, float(steps - 1))
    i_hit = torch.round(torch.linalg.vector_norm(cpos - begins, dim=-1)
                        / p.map_grid_min)
    probes = float(torch.where(found, i_hit, last).sum())
    rays = begins.shape[0] * begins.shape[1]
    nbytes = rays * (12 + 12 + 1 + 12 + 4) + df.field.numel() + 12
    return args, (nbytes, probes * 22), torch.arange(begins.shape[0],
                                                    device=begins.device)


def tier2_cases(eng, inp):
    """M2-M4 at the main path's state: the tier-2 likelihood's queries
    (each particle's sampled points, ``[N, K, 3]``, as
    ``likelihood_measure`` forms them) and the tier-2 beam's rays (``[N,
    B]`` from each particle's sensor origin to its beam points, as
    ``beam_measure`` forms them) for ``inp`` (``kernel_inputs``).
    ``{name: (kernel, plain, (bytes, ops), kept, library)}``: each
    callable returns a tuple of outputs; bytes count each query or ray's
    inputs read and outputs written once and the table (the field, its
    corner pack, the occupancy grid) once; operations ~58 f32 a trilinear
    query, ~10 a nearest one, ~24 a sphere-trace probe and ~16 a DDA probe
    over the probes these rays take (the plain loops' count of live rays
    a probe); every particle kept; ``library`` times
    ``torch.nn.functional.grid_sample`` for the sampler (``None`` for the
    marches)."""
    from mcl_3dl_tpu_torch.engine import dda_num_steps, sphere_num_steps
    from mcl_3dl_tpu_torch.map.distance_field import sample_field
    from mcl_3dl_tpu_torch.models import beam as mb

    p = eng.params
    bp = p.beam
    st = eng.pstate
    df, df_beam, occ = eng.map.df, eng.map.df_beam, eng.map.occ
    q = torch.einsum("kj,nij->nki", inp.like_pts, inp.rmat) + st.pos[:, None]
    n, k = q.shape[:2]
    kept = torch.arange(n, device=q.device)
    cases = {}
    grid = _grid_sample(df, q)
    for tri, name, ops in ((True, "sample_field", 58),
                           (False, "sample_field_nearest", 10)):
        table = (df.packed.numel() * 4 if tri and df.packed is not None
                 else df.field.numel())
        plain = df.sample_trilinear if tri else df.sample_nearest
        cases[name] = (lambda tri=tri: (sample_field(df, q, tri),),
                       lambda plain=plain: (plain(q),),
                       (q.numel() * 4 + n * k * 4 + table + 12, n * k * ops),
                       kept, grid(tri))
    org = inp.cloud[3][inp.beam_labels]
    begins = torch.einsum("bj,nij->nbi", org, inp.rmat) + st.pos[:, None]
    ends = torch.einsum("bj,nij->nbi", inp.beam_pts, inp.rmat) + st.pos[:, None]
    rays = begins.shape[0] * begins.shape[1]
    s_args = (df_beam, begins, ends, p.map_grid_min, p.map_grid_max,
              bp.hit_range, sphere_num_steps(p))
    setup = mb._sphere_setup(df_beam, begins, ends, p.map_grid_min,
                             bp.hit_range)
    _, probes = mb._sphere_loop(df_beam, begins, *setup, p.map_grid_min,
                                p.map_grid_max, s_args[-1], True)
    cases["march_sphere"] = (
        lambda: mb.march_sphere(*s_args), lambda: mb.raycast_df(*s_args),
        (rays * 57 + df_beam.field.numel() + 12, probes * 24), kept, None)
    d_args = (occ, begins, ends, bp.hit_range, bp.filter_label_max,
              dda_num_steps(p), bp.ray_angle_half, p.min_dist_thr_sq)
    setup = mb._dda_setup(occ, begins, ends, bp.hit_range)
    _, probes = mb._dda_loop(occ, begins, *setup, *d_args[4:], True)
    cells = occ.occupied.numel() * 9 + occ.rep_point.numel() + 12
    cases["march_dda"] = (
        lambda: mb.march_dda(*d_args), lambda: mb.raycast_occ(*d_args),
        (rays * 54 + cells, probes * 16), kept, None)
    return cases


def _grid_sample(df, q):
    """``tri -> callable``: ``torch.nn.functional.grid_sample`` (trilinear
    with ``tri``, else nearest) at the queries ``q`` over a float copy of
    the field padded by one ``trunc`` cell on every side
    (``align_corners=True``, border padding), the one PyTorch call that
    samples a volume; not bit-equal to the field's samplers (its own
    coordinates and rounding), a yardstick of speed only."""
    import torch.nn.functional as F

    trunc = float(df.trunc)
    vol = F.pad(df.field.float() * (trunc / 255.0), (1, 1, 1, 1, 1, 1),
                value=trunc)[None, None]
    w = torch.tensor(df.weights, dtype=torch.float32, device=q.device)
    u = (q * w - df.origin) / df.cell + 1.0
    size = torch.tensor(vol.shape[2:], dtype=torch.float32, device=q.device)
    grid = (2.0 * u / (size - 1.0) - 1.0).flip(-1).reshape(1, -1, 1, 1, 3)

    def call(tri):
        mode = "bilinear" if tri else "nearest"
        return lambda: (F.grid_sample(vol, grid, mode=mode,
                                      padding_mode="border",
                                      align_corners=True),)
    return call


def recovery_cloud(eng):
    """The fresh scan that phase 7 of ``chip_smoke.py`` scores a recovery
    step's state with, prepared by ``eng`` (``default_rng(2)``)."""
    from mcl_3dl_tpu_torch.tools import recovery

    origin = np.array([0.0, 0.0, worlds.SENSOR_Z])
    scan = worlds.scan(np.random.default_rng(2), recovery.CLOUD_POINTS)
    _, cloud = eng.prepare_cloud(scan, np.zeros(len(scan), np.int64),
                                 origin[None].astype(np.float32))
    return cloud


def recovery_step_inputs(eng, row, cloud):
    """The likelihood's inputs at a recovery step (a row of
    ``recovery.decay`` run with ``before_step=lambda e: e.pstate``) on the
    prepared ``cloud``: ``(state, points, valid, rmat, grouped)``."""
    st = row["before"]
    (pts, valid, bpts, blab, bvalid, _, _) = eng.sample_points(
        *cloud[:3], global_mode=True, global_slots=row["slots"],
        n_active=st.n_active)
    rmat, g_like, _ = eng.group(st.pos, st.rot, st.active_mask(), eng.map.df,
                                eng.map.df_beam, pts, valid, bpts, blab,
                                bvalid, cloud[3], use_beam=False)
    return st, pts, valid, rmat, g_like


def global_local_case(eng, rows, cloud):
    """K3 at the 512-capacity step that K3 scored among the recovery
    ``rows``: ``(local_case, row)``."""
    row = next(r for r in rows if r["tier_like"] == 1 and r["capacity"] == 512)
    st, pts, valid, rmat, _ = recovery_step_inputs(eng, row, cloud)
    return local_case(eng.map.df, eng.params.likelihood, st.pos, rmat, pts,
                      valid), row


COPY_MODULES = ("grouped", "local_gather", "gather_bench")


def _exec_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_copy(pkg_dir):
    """Another copy of the package's kernel modules: its ``ops/build.py``
    and its wrappers (``COPY_MODULES``), each loaded as a module of its
    own and bound to that copy's ``build``, so a call goes through the
    copy's whole launch path (its checks, its binding, its kernels).
    Returns a namespace with ``build`` and one attribute a module."""
    ops_dir = Path(pkg_dir).resolve() / "ops"
    if not (ops_dir / "build.py").exists():
        raise FileNotFoundError(f"{ops_dir / 'build.py'}: not a copy of the "
                                "package")
    tag = f"_pairs_copy_{abs(hash(str(ops_dir)))}"
    copy = types.SimpleNamespace(
        build=_exec_module(ops_dir / "build.py", f"{tag}.build"))
    # the copy's wrappers import ``build`` from this package's ``ops``:
    # hand them the copy's while they load
    ops_pkg = importlib.import_module("mcl_3dl_tpu_torch.ops")
    saved = ops_pkg.build
    ops_pkg.build = copy.build
    try:
        for name in COPY_MODULES:
            setattr(copy, name, _exec_module(ops_dir / f"{name}.py",
                                             f"{tag}.{name}"))
    finally:
        ops_pkg.build = saved
    return copy


def this_copy():
    """This package's kernel modules, as ``load_copy`` returns a copy's."""
    from mcl_3dl_tpu_torch.ops import gather_bench

    return types.SimpleNamespace(build=build, grouped=og, local_gather=olg,
                                 gather_bench=gather_bench)


def round_order(versions, r):
    """The builds of round ``r``: in list order in even rounds, reversed
    in odd ones."""
    return versions if r % 2 == 0 else versions[::-1]


def _quartiles(xs):
    if len(xs) < 2:
        return xs[0], xs[0]
    q = statistics.quantiles(xs, n=4, method="inclusive")
    return q[0], q[2]


def rows_touched(A, tile_group, meta, pts_fp, skip, every=8):
    """Distinct table rows that the 32 queries of one warp (32 neighbouring
    slots) touch for one live point, over every ``every``-th tile: each row
    is one 128-byte line of the table, so this is what one table read costs
    in L1 wavefronts.  Queries outside the window touch none.  Returns the
    mean and the 90th percentile."""
    tiles = torch.arange(0, A.shape[0], every, device=A.device)
    a = A[tiles]                                           # [m, 12, TILE]
    g = tile_group[tiles].long()
    p = pts_fp[:, :3].to(torch.float32) * (1.0 / 65536.0)  # [K, 3]
    rot = a[:, :9].reshape(-1, 3, 3, og.TILE)
    u = torch.einsum("kj,mijs->mkis", p, rot) + a[:, None, 9:]
    lo = meta[:, g, :3].permute(1, 0, 2).to(torch.float32)  # [m, K, 3]
    cell = torch.round(u) - lo[..., None]                  # [m, K, 3, TILE]
    inside = ((cell >= 0) & (cell < torch.tensor(
        [og.BX, og.BY, og.ZW], device=A.device)[:, None])).all(dim=2)
    row = torch.where(inside, cell[:, :, 0] * og.BY + cell[:, :, 1], -1.0)
    row = torch.sort(row.reshape(*row.shape[:2], -1, 32), dim=-1).values
    n = ((row[..., 1:] != row[..., :-1]) & (row[..., 1:] >= 0)).sum(-1) \
        + (row[..., 0] >= 0)
    live = (skip[:, g].T != og.SKIP_ALL)[..., None].expand_as(n)
    n = n[live].to(torch.float32)
    return float(n.mean()), float(torch.quantile(n, 0.9))


def kernel_cases(inp, k3=None, k3_global=None):
    """K1 and K2 at ``inp`` (``kernel_inputs``), and K3 at ``k3`` and at
    ``k3_global`` (each a ``local_case``) where given: ``{name: (run(copy),
    plain(), (bytes, ops), kept)}``, ``run`` through a copy's modules
    (``load_copy``)."""
    cases = {
        "like_score": (
            lambda c: c.grouped.grouped_like_score(*inp.like, **inp.like_kw),
            lambda: og.like_score_plain(*inp.like, **inp.like_kw),
            inp.like_bound, inp.kept),
        "beam_pen": (
            lambda c: (c.grouped.grouped_beam_pen(*inp.beam, **inp.beam_kw),),
            lambda: (og.beam_pen_plain(*inp.beam, **inp.beam_kw),),
            inp.beam_bound, inp.kept),
    }
    for name, case in (("local_score", k3), ("local_score_global", k3_global)):
        if case is not None:
            args, kw, k3_bound, kept = case
            cases[name] = (
                lambda c, a=args, k=kw: c.local_gather.local_score(*a, **k),
                lambda a=args, k=kw: olg.local_score_plain(*a, **k),
                k3_bound, kept)
    return cases


def compare(cases, others, pairs, where):
    """Time each kernel of each build in ``pairs`` rounds (``time_ms``, the
    median of 25 launches, and ``device_ms``, a captured graph of 25),
    with each build's host time a call (``host_ms``, once); print and
    return ``{kernel: {build: [ms, ...]}}``."""
    versions = [("this", this_copy())] + list(others.items())
    out = {}
    for kname, (run, plain, (nbytes, ops), kept) in cases.items():
        want = [w[kept] for w in plain()]
        equal, host = {}, {}
        call = {name: (lambda c=copy: run(c)) for name, copy in versions}
        for name, _ in versions:
            got = call[name]()
            torch.cuda.synchronize()
            equal[name] = all(torch.equal(g[kept], w)
                              for g, w in zip(got, want))
            host[name] = host_ms(call[name])
        times = {name: [] for name, _ in versions}
        dev = {name: [] for name, _ in versions}
        for r in range(pairs):
            for name, _ in round_order(versions, r):
                times[name].append(time_ms(call[name], 25))
                dev[name].append(device_ms(call[name]))
        bound_ms, by = bound(nbytes, ops)
        for name, _ in versions:
            xs, ds = times[name], dev[name]
            q1, q3 = _quartiles(xs)
            med = statistics.median(xs)
            wins = sum(a < b for a, b in zip(times["this"], xs))
            dwins = sum(a < b for a, b in zip(dev["this"], ds))
            vs = "" if name == "this" else f", this faster in {wins} of {pairs}"
            dvs = "" if name == "this" else f", this shorter in {dwins} of {pairs}"
            print(f"{kname} {name}: median {med:.4f} ms [q1 {q1:.4f}, q3 "
                  f"{q3:.4f}] over {pairs} rounds, {med / bound_ms:.2f}x the "
                  f"bound {bound_ms:.4f} ms by {by}{vs}, device "
                  f"{statistics.median(ds):.4f} ms a call{dvs}, host "
                  f"{host[name]:.4f} ms a call, equal to plain on kept "
                  f"slots: {equal[name]} [{where}]", flush=True)
        out[kname] = times
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("others", nargs="*", metavar="NAME=DIR")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("grouped_pairs: needs a CUDA device")
    others = {}
    for spec in a.others:
        name, _, path = spec.partition("=")
        others[name] = load_copy(path)
    # every build compiles its own sources; the compilers run in subprocesses
    with ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(lambda m: m.build(), [build, *(c.build for c in
                                                   others.values())]))
    where = card(torch.device("cuda"))
    rng = np.random.default_rng(0)
    eng = engine()
    drive(eng, rng)
    tiers = (eng.last_aux["tier_like"], eng.last_aux["tier_beam"])
    assert tiers == (0, 0), f"not at tiers 0/0: {tiers}"
    inp = kernel_inputs(eng, worlds.scan(rng, CLOUD_POINTS))
    for kname, args in (("like_score", inp.like), ("beam_pen", inp.beam)):
        mean, p90 = rows_touched(*args[:4], args[-2])
        print(f"{kname}: a warp's 32 queries of one live point touch "
              f"{mean:.2f} table rows on average, {p90:.0f} at the 90th "
              f"percentile (every 8th tile)", flush=True)
    # K3 at 96 points x 1M particles, on this state's tier-1 box tables
    k3 = local_case(eng.map.df, eng.params.likelihood, eng.pstate.pos,
                    inp.rmat, inp.like_pts, inp.like_valid)
    # K3 at the global shape, 512 particles x 16 points: the recovery
    # episodes seeded as phase 7 seeds them
    from mcl_3dl_tpu_torch.tools import recovery

    geng = recovery.engine("cuda")
    out = recovery.run(geng, np.random.default_rng(1),
                       before_step=lambda e: e.pstate, log=lambda s: None)
    rows = [r for ep in out.values() for r in ep["rows"]]
    k3_global, row = global_local_case(geng, rows, recovery_cloud(geng))
    one = torch.empty(1, device="cuda")
    print(f"local_score_global: capacity {row['capacity']}, {row['slots']} "
          f"slots, lidx {tuple(k3_global[0][1].shape)}; the device floor of a"
          f" launch by the same graph timing (a one-element fill_): "
          f"{device_ms(lambda: one.fill_(0.0)):.4f} ms a call [{where}]",
          flush=True)
    return compare(kernel_cases(inp, k3, k3_global), others, a.pairs, where)


if __name__ == "__main__":
    main()
