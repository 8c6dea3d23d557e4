"""Kernels K1 (``grouped_like_score``) and K2 (``grouped_beam_pen``) of
this package against other builds of them, timed in turns at the main
path's final state on the card.

    python -m mcl_3dl_tpu_torch.tools.grouped_pairs [--pairs 5] [NAME=DIR ...]

Each ``DIR`` is another copy of the ``mcl_3dl_tpu_torch`` package (an
older commit's, or one with an edited ``csrc/grouped.cu``).  Its kernels
are built from its own sources by its own ``ops/build.py`` and launched
through this package's wrappers, which pass every build the same C
arguments.  The state is the one ``chip_smoke.py`` measures at (``engine`` and
``drive``, which it shares): 1,048,576 particles on the flagship room
world, a coarse initial pose measured once, then the tracking spread and
ten scans to tiers 0/0.

In each of ``--pairs`` rounds every build is timed once (``time_ms``, the
median of 25 launches), in list order in even rounds and reversed in odd
ones.  Printed per kernel and build: the median and quartiles over the
rounds, the ratio to the byte/operation bound, in how many rounds this
package's kernel was faster, and whether the build's output equals the
plain version on the slots the caller keeps (a build that skips its
lookups does not).  Every line carries the card's ``nvidia-smi`` name and
power limit.
"""

from __future__ import annotations

import argparse
import contextlib
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
from mcl_3dl_tpu_torch.models.likelihood import grouped_like_inputs
from mcl_3dl_tpu_torch.ops import build
from mcl_3dl_tpu_torch.ops import grouped as og
from mcl_3dl_tpu_torch.tools import bound, card, time_ms

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
    like = grouped_like_inputs(df, stats, lo_l, like_pts, like_valid,
                               lp.match_dist_min)
    like_kw = dict(match_dist_min=lp.match_dist_min,
                   match_dist_flat=lp.match_dist_flat,
                   match_weight=lp.match_weight, trunc=float(df.trunc))
    beam = grouped_beam_inputs(df_beam, stats, lo_b, vp, beam_valid,
                               p.map_grid_max)
    beam_kw = dict(nprobe=vp.nprobe, trunc=float(df_beam.trunc),
                   grid_min=p.map_grid_min,
                   radius=2.0 ** 0.5 * p.map_grid_max / 2.0,
                   hit_range=bp.hit_range,
                   sin_total_ref=float(np.sin(bp.ang_total_ref)),
                   long_pen=not bp.add_penalty_short_only_mode,
                   tol=bp.hit_range)

    # bounds: each input read once, each output written once; lookups of
    # the live (point, bin) pairs of bins that have tiles
    nt = layout.A.shape[0]
    tiles_per_bin = torch.bincount(layout.tile_group.long(),
                                   minlength=og.G_GROUPS)
    table = og.R_ROWS * og.ZW
    coef = nt * 12 * og.TILE * 4 + nt * 4

    def live(skip):
        m = (skip != og.SKIP_ALL) & (tiles_per_bin > 0)[None, :]
        return (int(m.sum()),
                int((m.long() * tiles_per_bin[None, :]).sum()) * og.TILE)

    meta, pfp, skipw, _ = like
    n_tab, n_look = live(skipw)
    like_bytes = (coef + (meta.numel() + pfp.numel() + skipw.numel()) * 4
                  + n_tab * table + 2 * nt * og.TILE * 4)
    bmeta, bpfp, baux, bskip, _ = beam
    b_tab, b_look = live(bskip)
    beam_bytes = (coef + (bmeta.numel() + bpfp.numel() + baux.numel()
                          + bskip.numel()) * 4 + b_tab * table
                  + nt * og.TILE * 4)
    return types.SimpleNamespace(
        like=(layout.A, layout.tile_group, *like), like_kw=like_kw,
        beam=(layout.A, layout.tile_group, *beam), beam_kw=beam_kw,
        like_bound=(like_bytes, n_look * 25), beam_bound=(beam_bytes, b_look * 30),
        # slots of in-envelope particles: the overflow bin's slots are
        # rescored exactly by the caller, and there the kernels' skips
        # (which the plain versions do not take) are not no-ops
        kept=layout.dest[stats.g != og.G_GROUPS - 1],
        stats=stats, layout=layout, lo_l=lo_l, lo_b=lo_b, vp=vp,
        cloud=cloud_t, rmat=rmat, group_args=group_args,
        like_pts=like_pts, like_valid=like_valid, beam_pts=beam_pts,
        beam_labels=beam_labels, beam_valid=beam_valid)


def load_build(pkg_dir):
    """The ``ops/build.py`` of another package copy, as its own module."""
    path = Path(pkg_dir).resolve() / "ops" / "build.py"
    if not path.exists():
        raise FileNotFoundError(f"{path}: not a copy of the package")
    spec = importlib.util.spec_from_file_location(
        f"_grouped_pairs_build_{abs(hash(str(path)))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def launching(other):
    """This package's wrappers launch ``other``'s kernels (None: ours)."""
    if other is None:
        yield
        return
    saved = og.build
    og.build = types.SimpleNamespace(check=saved.check, launch=other.launch)
    try:
        yield
    finally:
        og.build = saved


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


def compare(inp, others, pairs, where):
    """Time each kernel of each build in ``pairs`` rounds; print and
    return ``{kernel: {build: [ms, ...]}}``."""
    versions = [("this", None)] + list(others.items())
    kernels = {
        "like_score": (lambda: og.grouped_like_score(*inp.like, **inp.like_kw),
                       lambda: og.like_score_plain(*inp.like, **inp.like_kw),
                       inp.like_bound),
        "beam_pen": (lambda: (og.grouped_beam_pen(*inp.beam, **inp.beam_kw),),
                     lambda: (og.beam_pen_plain(*inp.beam, **inp.beam_kw),),
                     inp.beam_bound),
    }
    out = {}
    for kname, (run, plain, (nbytes, ops)) in kernels.items():
        want = [w[inp.kept] for w in plain()]
        equal = {}
        for name, lib in versions:
            with launching(lib):
                got = run()
            torch.cuda.synchronize()
            equal[name] = all(torch.equal(g[inp.kept], w)
                              for g, w in zip(got, want))
        times = {name: [] for name, _ in versions}
        for r in range(pairs):
            for name, lib in (versions if r % 2 == 0 else versions[::-1]):
                with launching(lib):
                    times[name].append(time_ms(run, 25))
        bound_ms, by = bound(nbytes, ops)
        for name, _ in versions:
            xs = times[name]
            q1, q3 = _quartiles(xs)
            med = statistics.median(xs)
            wins = sum(a < b for a, b in zip(times["this"], xs))
            vs = "" if name == "this" else f", this faster in {wins} of {pairs}"
            print(f"{kname} {name}: median {med:.4f} ms [q1 {q1:.4f}, q3 "
                  f"{q3:.4f}] over {pairs} rounds, {med / bound_ms:.2f}x the "
                  f"bound {bound_ms:.4f} ms by {by}{vs}, equal to plain on kept "
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
        others[name] = load_build(path)
    # every build compiles its own sources; nvcc runs in subprocesses
    with ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(lambda m: m.build(), [build, *others.values()]))
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
    return compare(inp, others, a.pairs, where)


if __name__ == "__main__":
    main()
