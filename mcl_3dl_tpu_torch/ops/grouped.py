"""Pose-grouped, z-lane local-table scoring: the fast path of both
measurement models, kernels K1 and K2 (``csrc/grouped.cu``), and kernel
M5 (``csrc/group_stats.cu``), the grouping statistics.

Particles are counting-sorted into ``G_YAW x G_PITCH x G_ROLL`` pose bins
plus one outlier/inactive bin, in 1024-slot tiles.  Within a bin every
query ``q = A_n p + b_n`` of one virtual point ``p`` (a scan point, or a
fixed ray-march probe) lands in a small box, so a 12 x 12-row x 128-lane
local table cut from the z-major field serves the whole bin.  Per-bin
boxes are interval arithmetic over a trimmed mean +/- sigma envelope of
the bin's coefficients; particles outside their envelope go to the last
bin and are rescored exactly by the ``overflow_*`` path, so every
particle's result equals the plain nearest-cell lookup.

This module is the torch restatement of mcl_3dl_tpu/ops/grouped.py.  The
bin grid is read once, at import, from ``MCL_G_YAW``, ``MCL_G_PITCH`` and
``MCL_G_ROLL`` (defaults 24, 2, 2: sized for the 1M flagship; a fleet at
~10k particles a robot runs 6x1x1, since the per-(point, bin) table
extraction and the per-bin tile padding do not shrink with the particle
count), with that package's names, defaults and validation; the skip
granularity is a module constant.  The caller reads the ``fits`` flags on the host and only then
builds the layout, so the main path never needs ``empty_layout`` (the JAX
package's untaken ``lax.cond`` branch); it is kept for the shapes.

Kernel wrappers take the kernel for CUDA tensors, through its operator
(``csrc/ops.cpp``, which checks the tensors), and the plain version
(a vectorized restatement with the same f32 op sequence and the same
sequential accumulation order) for CPU tensors.  ``count_live_tables``
adds a K1 launch's live (point, bin) tables to a device counter,
``grouped_like_score.live_tables``; the likelihood path calls it beside
its K1 launch while the tracer is on, so the wrapper times K1 alone.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from mcl_3dl_tpu_torch.math import device_constant, f32
from mcl_3dl_tpu_torch.ops import build

G_YAW = int(os.environ.get("MCL_G_YAW", "24"))
G_PITCH = int(os.environ.get("MCL_G_PITCH", "2"))
G_ROLL = int(os.environ.get("MCL_G_ROLL", "2"))
if G_YAW < 1 or G_PITCH not in (1, 2) or G_ROLL not in (1, 2):
    # pitch/roll binning is a binary above/below-mean split
    raise ValueError(
        f"MCL_G_YAW must be >= 1 and MCL_G_PITCH/MCL_G_ROLL in (1, 2); "
        f"got {G_YAW}x{G_PITCH}x{G_ROLL}")
G_SPLIT = G_YAW * G_PITCH * G_ROLL
G_GROUPS = G_SPLIT + 1         # last bin: envelope outliers + inactive slots
TILE = 1024
BX = 12
BY = 12
R_ROWS = BX * BY
ZW = 128
ENV_SIGMA_TRIM = 3.5           # pass-1 gross-outlier trim, in per-bin stds
ENV_SIGMA = 3.0                # pass-2 envelope half-width over inliers
ENV_FLOOR_ANG = 0.01           # absolute envelope floor, rotation entries
ENV_FLOOR_POS = 0.5            # absolute envelope floor, position (cells)
_ENV_EPS = 1e-3                # absolute slack against float jitter
SKIP_GRAN = 16                 # table rows per skip bit
NHALF = R_ROWS // SKIP_GRAN    # skip bits per window
SKIP_ALL = (1 << NHALF) - 1    # every block skippable
_PT_SCALE = 1.0 / 65536.0      # fixed-point scale of the virtual points


class GroupStats(NamedTuple):
    g: torch.Tensor           # [N] i32 final bin (outliers/inactive: last)
    A: torch.Tensor           # [N, 12] f32: W@R/cell (9), (pos*w - origin)/cell (3)
    a_min: torch.Tensor       # [G, 12] f32 per-bin envelope bounds
    a_max: torch.Tensor       # [G, 12] f32
    any_active: torch.Tensor  # [G] bool content bins with members
    n_over: torch.Tensor      # [] i32 active particles routed to overflow


class GroupedLayout(NamedTuple):
    A: torch.Tensor           # [nt, 12, TILE] f32 coefficient tiles
    dest: torch.Tensor        # [N] i64 sorted slot of particle i
    tile_group: torch.Tensor  # [nt] i32
    over_idx: torch.Tensor    # [cap] i64 original indices of the overflow
    #                           bin's leading slots; padding slots hold N


def _ypr_from_quat(rot):
    x, y, z, w = rot.unbind(-1)
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    return yaw, pitch, roll


def _bin_moments(onehot, x, g0):
    """Per-bin mean and std of ``x`` [N, 12] over the rows marked in
    ``onehot`` [N, G] (full-f32 matmuls; each row lies in one bin)."""
    cnt = torch.clamp(onehot.sum(0), min=1.0)[:, None]
    mean = onehot.T @ x / cnt
    var = onehot.T @ (x - mean[g0]) ** 2 / cnt
    return mean, torch.sqrt(var)


def _nanmedian_rows(x, empty):
    """Column-wise median over the non-empty rows of ``x``, the two middle
    values averaged (``jnp.nanmedian``; ``torch.nanmedian`` would return
    the lower one); 0 where every row is empty."""
    srt = torch.sort(torch.where(empty[:, None], torch.inf, x), dim=0).values
    n = torch.sum(~empty)
    lo = torch.clamp((n - 1) // 2, min=0).reshape(1)
    hi = torch.clamp(n // 2, min=0).reshape(1)
    med = 0.5 * srt.index_select(0, lo)[0] + 0.5 * srt.index_select(0, hi)[0]
    return torch.where(n > 0, med, torch.zeros_like(med))


def group_stats(pos, rot_mat, rot, weights3, cell, origin3, active) -> GroupStats:
    """M5: bin particles on (yaw, pitch, roll) and bound each bin's
    coefficients (``group_stats_plain`` says how).

    ``pos [N, 3]``, ``rot_mat [N, 3, 3]``, ``rot [N, 4]`` f32, ``active
    [N]`` bool, ``origin3 [3]`` f32 on the particles' device; the bin grid
    is this module's ``G_YAW x G_PITCH x G_ROLL``.  A CUDA tensor launches
    the kernel (``csrc/group_stats.cu``) through its operator, with no
    host read, and counts one launch; a CPU tensor takes the plain
    version."""
    if not pos.is_cuda:
        return group_stats_plain(pos, rot_mat, rot, weights3, cell, origin3,
                                 active)
    w = [f32(float(x)) for x in weights3]
    out = build.op("group_stats")(
        pos.contiguous(), rot_mat.contiguous(), rot.contiguous(),
        active.contiguous(), origin3.contiguous(), G_YAW, G_PITCH, G_ROLL,
        *w, f32(1.0 / cell), f32(ENV_FLOOR_ANG), ENV_FLOOR_POS,
        ENV_SIGMA_TRIM, ENV_SIGMA, f32(_ENV_EPS))
    group_stats.launches += 1
    return GroupStats(*out)


group_stats.launches = 0


def group_stats_plain(pos, rot_mat, rot, weights3, cell, origin3,
                      active) -> GroupStats:
    """Plain version of M5: bin particles on (yaw, pitch, roll) and bound
    each bin's coefficients.

    Envelope: per-bin ``mean +/- max(ENV_SIGMA * std, floor)`` clipped to
    the wider of the inliers' true min/max and the floor band, in two
    passes: pass 1 trims gross outliers with a scale of
    ``max(sigma_med, min(sigma_bin, 3 sigma_med))`` (``sigma_med``, the
    median std over non-empty bins, resists masking by one contaminated
    bin); pass 2 recomputes the moments over the pass-1 inliers.  Active
    particles with any coefficient outside the final envelope go to the
    last bin.
    """
    n = pos.shape[0]
    dev = pos.device
    w = device_constant(tuple(float(x) for x in weights3), torch.float32, dev)
    inv_cell = f32(1.0 / cell)
    af = active.to(torch.float32)

    yaw, pitch, roll = _ypr_from_quat(rot)
    big = 1e9
    ylo = torch.min(torch.where(active, yaw, big))
    yhi = torch.max(torch.where(active, yaw, -big))
    yspan = torch.clamp(yhi - ylo, min=1e-6)
    yb = torch.clamp(((yaw - ylo) / yspan * G_YAW).to(torch.int32), 0, G_YAW - 1)
    nact = torch.clamp(torch.sum(af), min=1.0)
    pb = rb = torch.zeros_like(yb)
    if G_PITCH > 1:
        pmid = torch.sum(torch.where(active, pitch, 0.0)) / nact
        pb = (pitch > pmid).to(torch.int32)
    if G_ROLL > 1:
        rmid = torch.sum(torch.where(active, roll, 0.0)) / nact
        rb = (roll > rmid).to(torch.int32)
    g0 = ((yb * G_PITCH + pb) * G_ROLL + rb).to(torch.int64)    # [N]

    a9 = (rot_mat * w[:, None]).reshape(n, 9) * inv_cell
    b3 = (pos * w - origin3) * inv_cell
    A = torch.cat([a9, b3], dim=-1)                             # [N, 12]
    # centre before the variance pass: b3 is O(map extent / cell)
    a_ctr = torch.sum(torch.where(active[:, None], A, 0.0), dim=0) / nact
    Ac = A - a_ctr
    floors = torch.cat([
        torch.repeat_interleave(w * inv_cell, 3) * f32(ENV_FLOOR_ANG),
        torch.full((3,), ENV_FLOOR_POS, dtype=torch.float32, device=dev),
    ])

    bins = torch.arange(G_SPLIT, device=dev)
    member = (g0[:, None] == bins) & active[:, None]            # [N, G]
    onehot = member.to(torch.float32)
    mean1, sd1 = _bin_moments(onehot, Ac, g0)
    empty = ~member.any(0)
    sig_med = _nanmedian_rows(sd1, empty)

    s1 = torch.maximum(sig_med, torch.minimum(sd1, 3.0 * sig_med))
    h1 = torch.maximum(ENV_SIGMA_TRIM * s1, floors) + f32(_ENV_EPS)
    inl = active & torch.all(torch.abs(Ac - mean1[g0]) <= h1[g0], dim=-1)
    mean2, sd2 = _bin_moments(onehot * inl[:, None], Ac, g0)
    half = torch.maximum(ENV_SIGMA * sd2, floors) + f32(_ENV_EPS)
    idx = g0[:, None].expand(n, 12)
    gmin = torch.full((G_SPLIT, 12), big, dtype=torch.float32, device=dev)
    gmin = gmin.scatter_reduce(0, idx, torch.where(inl[:, None], Ac, big), "amin")
    gmax = torch.full((G_SPLIT, 12), -big, dtype=torch.float32, device=dev)
    gmax = gmax.scatter_reduce(0, idx, torch.where(inl[:, None], Ac, -big), "amax")
    env_lo = torch.maximum(mean2 - half, torch.minimum(gmin, mean2 - floors))
    env_hi = torch.minimum(mean2 + half, torch.maximum(gmax, mean2 + floors))
    outlier = active & torch.any((Ac < env_lo[g0]) | (Ac > env_hi[g0]), dim=-1)

    # outlier/inactive bin: zero bounds, never used (any_active False)
    zero = torch.zeros((1, 12), dtype=torch.float32, device=dev)
    g = torch.where(active & ~outlier, g0, G_GROUPS - 1).to(torch.int32)
    return GroupStats(
        g=g, A=A,
        a_min=torch.cat([env_lo + a_ctr, zero]),
        a_max=torch.cat([env_hi + a_ctr, zero]),
        any_active=torch.cat([~empty, torch.zeros(1, dtype=torch.bool, device=dev)]),
        n_over=torch.sum(outlier).to(torch.int32),
    )


def query_bands(stats: GroupStats, pts):
    """Conservative per-(point, bin) query intervals in cell indices,
    ``[(x_lo, x_hi), (y_lo, y_hi), (z_lo, z_hi)]`` of [K, G] i32, from the
    kernels' dequantized fixed-point points (so a query within the
    quantization error of a band edge cannot fall outside it)."""
    p = (torch.round(pts.to(torch.float32) * 65536.0).to(torch.int32)
         .to(torch.float32) * f32(_PT_SCALE))
    out = []
    for i in range(3):
        lo_i = stats.a_min[:, 9 + i][None, :]
        hi_i = stats.a_max[:, 9 + i][None, :]
        for j in range(3):
            amin = stats.a_min[:, 3 * i + j][None, :]
            amax = stats.a_max[:, 3 * i + j][None, :]
            pj = p[:, j][:, None]
            lo_i = lo_i + torch.minimum(amin * pj, amax * pj)
            hi_i = hi_i + torch.maximum(amin * pj, amax * pj)
        out.append((torch.floor(lo_i).to(torch.int32),
                    torch.ceil(hi_i).to(torch.int32)))
    return out


def group_boxes(stats: GroupStats, pts, dims3):
    """``lo [K, G, 3] i32`` (table window origin, clipped to
    [0, dim - box]) and ``fits [K, G]``: whether the in-map part of each
    query interval fits (BX, BY, ZW).  Out-of-map queries read trunc in
    the kernel, so only the in-map extent counts; empty bins fit."""
    box = (BX, BY, ZW)
    bands = query_bands(stats, pts)
    lo_cols = []
    fits = torch.ones((pts.shape[0], G_GROUPS), dtype=torch.bool,
                      device=pts.device)
    for i in range(3):
        lo_q, hi_q = bands[i]
        lo_in = torch.clamp(lo_q, min=0)
        hi_in = torch.clamp(hi_q, max=dims3[i] - 1)
        fits &= (hi_in - lo_in + 1) <= box[i]
        lo_cols.append(torch.clamp(lo_in, 0, max(dims3[i] - box[i], 0)))
    lo = torch.stack(lo_cols, dim=-1)
    return lo, fits | ~stats.any_active[None, :]


def build_layout(stats: GroupStats, cap: int) -> GroupedLayout:
    """Counting sort into the kernel tile layout.

    Within a bin, rank order is original index order; in the last bin the
    active outliers (a prefix of the state arrays) take the leading slots,
    then inactive slots, then ``N`` sentinels.  ``over_idx`` is the
    ``cap``-long window from the last bin's start, the start clamped so the
    window stays inside the padded slots (as ``lax.dynamic_slice`` does).
    """
    g = stats.g.to(torch.int64)
    n = g.shape[0]
    dev = g.device
    counts = torch.zeros((G_GROUPS,), dtype=torch.int64, device=dev)
    counts.index_add_(0, g, torch.ones_like(g))
    counts_p = (counts + TILE - 1) // TILE * TILE
    ends_p = torch.cumsum(counts_p, dim=0)
    starts_p = ends_p - counts_p
    order = torch.argsort(g, stable=True)
    first = torch.cumsum(counts, dim=0) - counts                 # sorted start
    rank_sorted = torch.arange(n, device=dev) - first[g[order]]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    dest = starts_p[g] + rank                                    # [N]

    n_pad = n + G_GROUPS * TILE
    nt = n_pad // TILE
    a_sorted = torch.zeros((n_pad, 12), dtype=torch.float32, device=dev)
    a_sorted[dest] = stats.A
    a_tiles = a_sorted.reshape(nt, TILE, 12).transpose(1, 2).contiguous()

    tile_starts = torch.arange(nt, device=dev) * TILE
    tile_group = torch.clamp(
        torch.searchsorted(ends_p, tile_starts, right=True), 0, G_GROUPS - 1
    ).to(torch.int32)

    src = torch.full((n_pad,), n, dtype=torch.int64, device=dev)
    src[dest] = torch.arange(n, device=dev)
    start = torch.clamp(starts_p[G_GROUPS - 1], 0, n_pad - cap)
    over_idx = src[start + torch.arange(cap, device=dev)]
    return GroupedLayout(A=a_tiles, dest=dest, tile_group=tile_group,
                         over_idx=over_idx)


def empty_layout(n: int, cap: int, device=None) -> GroupedLayout:
    """A zero layout of ``build_layout``'s shapes and dtypes for ``n``
    particles and an overflow capacity ``cap``; every ``over_idx`` slot is
    the sentinel ``n``, which drops every overflow scatter."""
    nt = (n + G_GROUPS * TILE) // TILE
    return GroupedLayout(
        A=torch.zeros((nt, 12, TILE), dtype=torch.float32, device=device),
        dest=torch.zeros((n,), dtype=torch.int64, device=device),
        tile_group=torch.zeros((nt,), dtype=torch.int32, device=device),
        over_idx=torch.full((cap,), n, dtype=torch.int64, device=device))


def overflow_transform(A, over_idx, pts):
    """Exact cell-space queries ``A @ p + b`` -> [cap, K, 3] for the
    overflow particles (sentinel rows read row N-1; dropped on scatter)."""
    rows = A[torch.clamp(over_idx, max=A.shape[0] - 1)]          # [C, 12]
    rm = rows[:, :9].reshape(-1, 3, 3)
    return (torch.einsum("kj,cij->cki", pts.to(torch.float32), rm)
            + rows[:, None, 9:])


def overflow_field_lookup(field, q):
    """Nearest-cell u8 codes at cell-space queries ``q`` [..., 3];
    out-of-map reads 255 (= trunc)."""
    from mcl_3dl_tpu_torch.map.distance_field import gather_codes

    code, oob = gather_codes(field, torch.round(q).to(torch.int32))
    return torch.where(oob, torch.full_like(code, 255), code)


def scatter_overflow(values, over_idx, new):
    """``values[over_idx] = new`` where the sentinel index ``N`` lands in
    a scratch slot that is cut off (a plain index_put would fault on it)."""
    ext = torch.cat([values, values.new_zeros(1)])
    ext[over_idx] = new
    return ext[:-1]


def extract_tables(field2d, ny, nzp, lo, point_valid):
    """Per-(virtual point, bin) local tables cut from the z-major field:
    ``(codes [K, G, R, ZW] u8, z_used [K, G] i32)``; distance = code *
    trunc/255.  Rows outside the map and invalid points read 255."""
    kk, gg = lo.shape[0], lo.shape[1]
    nxy = field2d.shape[0]
    nx = nxy // ny
    dev = lo.device
    dx = torch.arange(BX, dtype=torch.int32, device=dev)
    dy = torch.arange(BY, dtype=torch.int32, device=dev)
    ix = lo[..., 0, None, None] + dx[:, None]                    # [K, G, BX, 1]
    iy = lo[..., 1, None, None] + dy[None, :]                    # [K, G, 1, BY]
    row_ok = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)      # [K, G, BX, BY]
    xyrow = torch.clamp(ix * ny + iy, 0, nxy - 1).reshape(kk, gg, R_ROWS)
    z_used = torch.clamp(lo[..., 2], 0, nzp - ZW)                # [K, G]
    windows = field2d.unfold(1, ZW, 1)                           # [nxy, nzp-ZW+1, ZW]
    codes = windows[xyrow.to(torch.int64), z_used[..., None].to(torch.int64)]
    keep = row_ok.reshape(kk, gg, R_ROWS, 1) & point_valid[:, None, None, None]
    codes = torch.where(keep, codes, torch.full_like(codes, 255))
    return codes, z_used.to(torch.int32)


def block_min_dist(tables, trunc, lo, z_used, bands):
    """Per-16-row-block minimum distance [K, G, NHALF] of the u8 tables,
    over the cells an in-envelope query can select (``bands``), scaled
    exactly as the kernels scale codes."""
    lead = tables.shape[:-2]
    dev = tables.device
    xb, yb, zb = bands
    ax = lo[..., 0, None] + torch.arange(BX, dtype=torch.int32, device=dev)
    ay = lo[..., 1, None] + torch.arange(BY, dtype=torch.int32, device=dev)
    mx = (ax >= xb[0][..., None]) & (ax <= xb[1][..., None])
    my = (ay >= yb[0][..., None]) & (ay <= yb[1][..., None])
    rowm = (mx[..., :, None] & my[..., None, :]).reshape(lead + (R_ROWS,))
    z_abs = z_used[..., None] + torch.arange(ZW, dtype=torch.int32, device=dev)
    mz = (z_abs >= zb[0][..., None]) & (z_abs <= zb[1][..., None])
    keep = rowm[..., None] & mz[..., None, :]
    masked = torch.where(keep, tables, torch.full_like(tables, 255))
    m = masked.reshape(lead + (NHALF, SKIP_GRAN * ZW)).amin(dim=-1)
    return m.to(torch.float32) * f32(trunc / 255.0)


def pack_block_skip(skip_bool):
    """Pack a [..., NHALF] bool block-skip mask into i32 words."""
    shifts = torch.arange(NHALF, dtype=torch.int32, device=skip_bool.device)
    return torch.sum(skip_bool.to(torch.int32) << shifts, dim=-1).to(torch.int32)


def default_overflow_cap(n: int) -> int:
    """Overflow slots: 1/16 of N (steady-state outliers are a few per
    cent of N), at least one tile."""
    return max(TILE, n >> 4)


def make_meta(lo, z_used):
    """Window origins per (point, bin): (lo_x, lo_y, z_used, 0) i32."""
    return torch.cat([lo[..., :2], z_used[..., None],
                      torch.zeros_like(z_used[..., None])], dim=-1
                     ).to(torch.int32).contiguous()


def points_fp(pts):
    """Virtual points in the kernels' 2^16 fixed-point encoding [K, 4]."""
    fp = torch.round(pts.to(torch.float32) * 65536.0).to(torch.int32)
    return torch.cat([fp, torch.zeros_like(fp[:, :1])], dim=-1).contiguous()


# ------------------------------------------------------------------ kernels


def _table_dist(a, pts_flat, meta_flat, tab_flat, gsel, kg, kp, gg,
                code_scale, trunc):
    """Plain version of the kernels' lookup for virtual point ``kp`` in
    table row ``kg`` (= kp): [nt, TILE] distances."""
    mbase = (kg * gg + gsel) * 4
    lox = meta_flat[mbase + 0][:, None]
    loy = meta_flat[mbase + 1][:, None]
    zlo = meta_flat[mbase + 2][:, None]
    px = pts_flat[kp * 4 + 0].to(torch.float32) * f32(_PT_SCALE)
    py = pts_flat[kp * 4 + 1].to(torch.float32) * f32(_PT_SCALE)
    pz = pts_flat[kp * 4 + 2].to(torch.float32) * f32(_PT_SCALE)
    ux = a[:, 0] * px + a[:, 1] * py + a[:, 2] * pz + a[:, 9]
    uy = a[:, 3] * px + a[:, 4] * py + a[:, 5] * pz + a[:, 10]
    uz = a[:, 6] * px + a[:, 7] * py + a[:, 8] * pz + a[:, 11]
    ix = torch.round(ux).to(torch.int32) - lox
    iy = torch.round(uy).to(torch.int32) - loy
    iz = torch.round(uz).to(torch.int32) - zlo
    inbox = (ix >= 0) & (ix < BX) & (iy >= 0) & (iy < BY) & (iz >= 0) & (iz < ZW)
    row = torch.clamp(ix * BY + iy, 0, R_ROWS - 1)
    lane = torch.clamp(iz, 0, ZW - 1)
    flat = (((kg * gg + gsel)[:, None].to(torch.int64) * R_ROWS + row) * ZW
            + lane)
    code = tab_flat[flat].to(torch.float32)
    return torch.where(inbox, code * code_scale, trunc)


def like_score_plain(gp_A, tile_group, meta, pts_fp, skipw, tables, *,
                     match_dist_min, match_dist_flat, match_weight, trunc):
    """Plain version of K1 (the JAX package's ``_emulate_like_score``)."""
    del skipw   # a skip is an exact no-op on every slot read back
    kk, gg = tables.shape[0], tables.shape[1]
    gsel = tile_group.to(torch.int64)
    meta_flat, pts_flat = meta.reshape(-1), pts_fp.reshape(-1)
    tab_flat = tables.reshape(-1)
    mdm, mdf, mw = f32(match_dist_min), f32(match_dist_flat), f32(match_weight)
    acc = torch.zeros(gp_A[:, 0].shape, dtype=torch.float32, device=gp_A.device)
    mac = torch.zeros_like(acc)
    for k in range(kk):
        d = _table_dist(gp_A, pts_flat, meta_flat, tab_flat, gsel, k, k, gg,
                        f32(trunc / 255.0), f32(trunc))
        matched = d <= mdm
        contrib = torch.clamp(mw * (mdm - torch.clamp(d, min=mdf)), min=0.0)
        acc = acc + torch.where(matched, contrib, 0.0)
        mac = mac + matched.to(torch.float32)
    return acc.reshape(-1), mac.reshape(-1)


def grouped_like_score(gp_A, tile_group, meta, pts_fp, skipw, tables, *,
                       match_dist_min, match_dist_flat, match_weight, trunc):
    """K1: likelihood-field score over the sorted layout.

    ``gp_A [nt, 12, TILE]`` f32, ``tile_group [nt]`` i32, ``meta [K, G, 4]``
    i32, ``pts_fp [K, 4]`` i32, ``skipw [K, G]`` i32, ``tables
    [K, G, R, ZW]`` u8.  Returns ``(score, match_count)`` [nt*TILE] in
    sorted slot order (lidar_measurement_model_likelihood.cpp:124-135)."""
    kw = dict(match_dist_min=match_dist_min, match_dist_flat=match_dist_flat,
              match_weight=match_weight, trunc=trunc)
    if not gp_A.is_cuda:
        return like_score_plain(gp_A, tile_group, meta, pts_fp, skipw, tables,
                                **kw)
    score, match = build.op("like_score")(
        gp_A, tile_group, meta, pts_fp, skipw, tables, SKIP_ALL,
        f32(trunc / 255.0), f32(_PT_SCALE), f32(trunc), f32(match_dist_min),
        f32(match_dist_flat), f32(match_weight))
    grouped_like_score.launches += 1
    return score, match


grouped_like_score.launches = 0
grouped_like_score.live_tables = None


def live_tables(tile_group, skipw):
    """The (point, bin) tables K1 does not skip, as a 0-dim i64 device
    tensor: the bin holds tiles (``tile_group``) and the point's skip word
    there (``skipw [K, G]``) is not ``SKIP_ALL``, the kernel's own rule."""
    held = torch.zeros(skipw.shape[1], dtype=torch.bool,
                       device=skipw.device).index_fill_(
                           0, tile_group.to(torch.int64), True)
    return ((skipw != SKIP_ALL) & held).sum()


def count_live_tables(tile_group, skipw):
    """Add a K1 launch's ``live_tables`` to ``grouped_like_score.
    live_tables``, a 0-dim i64 tensor on the launch's device: on the
    device, with no host read, inside a captured graph too (each replay
    adds).  The counter is made by the device's first count outside a
    capture; a graph captured before that counts nothing."""
    count = grouped_like_score.live_tables
    if count is None or count.device != skipw.device:
        if skipw.is_cuda and torch.cuda.is_current_stream_capturing():
            return
        count = grouped_like_score.live_tables = torch.zeros(
            (), dtype=torch.int64, device=skipw.device)
    count.add_(live_tables(tile_group, skipw))


def beam_pen_plain(gp_A, tile_group, meta, pts_fp, aux, skip, tables, *,
                   nprobe, trunc, grid_min, radius, hit_range, sin_total_ref,
                   long_pen, tol):
    """Plain version of K2 (the JAX package's ``_emulate_beam_pen``):
    the same march carry (entry bookkeeping before the hit update in each
    probe), accumulated over beams in kernel order."""
    del skip    # a skipped probe is an exact identity on the carry
    bb, gg = tables.shape[0], tables.shape[2]
    dev = gp_A.device
    gsel = tile_group.to(torch.int64)
    meta_flat, pts_flat = meta.reshape(-1), pts_fp.reshape(-1)
    tab_flat = tables.reshape(-1)
    aux_flat = aux.reshape(-1)
    code_scale, trunc32 = f32(trunc / 255.0), f32(trunc)
    grid = torch.full((), f32(grid_min), device=dev)   # true division below
    d_entry_thr, rad, hr2 = f32(trunc * 0.99), f32(radius), f32(hit_range * hit_range)
    shape = gp_A[:, 0].shape
    npen = torch.zeros(shape, dtype=torch.float32, device=dev)
    for b in range(bb):
        len_b = aux_flat[b * 2].to(torch.float32) * f32(_PT_SCALE)
        bvalid = aux_flat[b * 2 + 1] > 0
        l_b = torch.floor((len_b + f32(tol)) / grid)
        found = torch.zeros(shape, dtype=torch.bool, device=dev)
        t_hit = torch.zeros(shape, dtype=torch.float32, device=dev)
        d_hit = torch.zeros_like(t_hit)
        t_entry = torch.full_like(t_hit, -1.0)
        d_entry = torch.full_like(t_hit, trunc32)
        for s in range(nprobe):
            kp = b * nprobe + s
            d = _table_dist(gp_A, pts_flat, meta_flat, tab_flat, gsel, kp, kp,
                            gg, code_scale, trunc32)
            i = torch.full((), float(s - 1), device=dev)
            elig = (i >= 1.0) & (i < l_b) & bvalid & ~found
            enter = elig & (d < d_entry_thr) & (t_entry < 0.0)
            t_entry = torch.where(enter, i * grid, t_entry)
            d_entry = torch.where(enter, d, d_entry)
            hit_now = elig & (d <= rad)
            t_hit = torch.where(hit_now, i * grid, t_hit)
            d_hit = torch.where(hit_now, d, d_hit)
            found = found | hit_now
        span = t_hit - t_entry
        sin = torch.where(
            found & (t_entry >= 0.0) & (span > f32(grid_min)),
            torch.clamp((d_entry - d_hit) / torch.clamp(span, min=f32(1e-6)),
                        0.0, 1.0),
            1.0)
        graze = found & (sin <= f32(sin_total_ref))
        dist = len_b - t_hit
        short = found & ~graze & (dist * dist >= hr2)
        long_p = ~found & bool(long_pen)
        npen = npen + ((short | long_p) & bvalid).to(torch.float32)
    return npen.reshape(-1)


def grouped_beam_pen(gp_A, tile_group, meta, pts_fp, aux, skip, tables, *,
                     nprobe, trunc, grid_min, radius, hit_range, sin_total_ref,
                     long_pen, tol):
    """K2: penalized-beam count per sorted slot [nt*TILE].

    ``meta [B*nprobe, G, 4]``, ``pts_fp [B*nprobe, 4]``, ``aux [B, 2]``
    i32 (ray length * 2^16, valid), ``skip [B*nprobe, G]`` i32, ``tables
    [B, nprobe, G, R, ZW]`` u8.  Classification semantics of
    lidar_measurement_model_beam.cpp:157-192 over the fixed kd-tree march
    (raycast_using_kdtree.h:58-109)."""
    kw = dict(nprobe=nprobe, trunc=trunc, grid_min=grid_min, radius=radius,
              hit_range=hit_range, sin_total_ref=sin_total_ref,
              long_pen=long_pen, tol=tol)
    if not gp_A.is_cuda:
        return beam_pen_plain(gp_A, tile_group, meta, pts_fp, aux, skip,
                              tables, **kw)
    # the entry point zeroes npen, then the kernel adds each penalty
    npen = build.op("beam_pen")(
        gp_A, tile_group, meta, pts_fp, aux, skip, tables, nprobe, SKIP_ALL,
        int(bool(long_pen)), f32(trunc / 255.0), f32(_PT_SCALE), f32(trunc),
        f32(grid_min), f32(radius), f32(hit_range * hit_range),
        f32(sin_total_ref), f32(trunc * 0.99), f32(tol))
    grouped_beam_pen.launches += 1
    return npen


grouped_beam_pen.launches = 0
