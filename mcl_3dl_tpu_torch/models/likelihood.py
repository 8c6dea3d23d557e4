"""Likelihood-field LIDAR measurement model
(src/lidar_measurement_model_likelihood.cpp:105-139).

Score per particle (lidar_measurement_model_likelihood.cpp:124-135):

    for each matched point (weighted nearest dist d <= match_dist_min):
        score += match_weight * (match_dist_min - max(d, match_dist_flat))
    quality = matched / num_points

Three tiers of nearest-cell sampling, fastest first; the tier is decided
on the host from device flags, and its id is reported as the JAX
package reports it:

0. pose-grouped local tables, kernel K1 (ops/grouped.py) + the exact
   overflow rescore;
1. per-point 32x32x16 box tables, kernel K3 (ops/local_gather.py);
2. the plain gather.

Trilinear sampling (``trilinear=True``) always samples at tier 2.  The
tier-2 branch that needs no box check (``box_path`` false: trilinear
sampling, a capacity that is no multiple of 128, the batched fleet)
samples the field through kernel M4 (``sample_field``) on the card and
reads nothing on the host; the box check (tiers 1 and 2 after a grouping
that does not fit) reads its flags on the host, each read a ``read.box``
span (``profiling.spans``).
"""

from __future__ import annotations

import torch

from mcl_3dl_tpu_torch.map.distance_field import (DistanceField, gather_codes,
                                                  sample_field)
from mcl_3dl_tpu_torch.math import f32
from mcl_3dl_tpu_torch.math import quat as mq
from mcl_3dl_tpu_torch.ops import grouped as og
from mcl_3dl_tpu_torch.ops.local_gather import local_score
from mcl_3dl_tpu_torch.profiling import spans

_BOX = (32, 32, 16)      # tier-1 box in (weighted-space) field cells

TIER_GROUPED = 0
TIER_BOX = 1
TIER_GATHER = 2


def clip_mask(points, clip_near, clip_far, clip_z_min, clip_z_max):
    """Annulus + z-band clip in the sensor/base frame
    (lidar_measurement_model_likelihood.cpp:84-93)."""
    r2 = points[..., 0] ** 2 + points[..., 1] ** 2
    keep = (r2 <= f32(clip_far ** 2)) & (r2 >= f32(clip_near ** 2))
    keep &= (points[..., 2] >= f32(clip_z_min)) & (points[..., 2] <= f32(clip_z_max))
    return keep


def _finalize(score, mcount, valid):
    """Empty-cloud guard (lidar_measurement_model_likelihood.cpp:111-114):
    an all-invalid cloud gives (1, 0) per particle."""
    num = torch.sum(valid)
    has_points = num > 0
    quality = mcount / torch.clamp(num, min=1)
    likelihood = torch.where(has_points, score, 1.0)
    quality = torch.where(has_points, quality, 0.0)
    return likelihood, quality


def _score_from_dist(d, valid_k, match_dist_min, match_dist_flat,
                     match_weight, dim):
    """The reference's clamp + sum reduction over the points axis."""
    mdm = f32(match_dist_min)
    matched = (d <= mdm) & valid_k
    contrib = f32(match_weight) * (mdm - torch.clamp(d, min=f32(match_dist_flat)))
    contrib = torch.clamp(contrib, min=0.0)
    score = torch.sum(torch.where(matched, contrib, 0.0), dim=dim)
    return score, torch.sum(matched, dim=dim).to(torch.float32)


def grouped_like_inputs(df: DistanceField, stats, lo, points, valid,
                        match_dist_min):
    """K1's inputs besides the layout: ``(meta, pts_fp, skipw, tables)``."""
    trunc = float(df.trunc)
    tables, z_used = og.extract_tables(df.field2d, df.shape[1],
                                       df.field2d.shape[1], lo, valid)
    # a 16-row block whose minimum reachable distance exceeds
    # match_dist_min can only give unmatched rows; a point whose blocks
    # all qualify is skipped whole
    min_d = og.block_min_dist(tables, trunc, lo, z_used,
                              og.query_bands(stats, points))
    skipw = og.pack_block_skip(min_d > f32(match_dist_min))
    return og.make_meta(lo, z_used), og.points_fp(points), skipw, tables


def grouped_like_apply(df: DistanceField, stats, layout, lo, points, valid, *,
                       match_dist_min, match_dist_flat, match_weight):
    """Tier 0: kernel K1 over the sorted layout, then the exact rescore of
    the envelope outliers scattered over it.  While the tracer is on
    (``spans.enabled``, as it stands when a graph is captured), K1's live
    tables are counted beside the launch (``og.count_live_tables``)."""
    trunc = float(df.trunc)
    meta, pfp, skipw, tables = grouped_like_inputs(df, stats, lo, points,
                                                   valid, match_dist_min)
    s_sorted, m_sorted = og.grouped_like_score(
        layout.A, layout.tile_group, meta, pfp, skipw, tables,
        match_dist_min=match_dist_min, match_dist_flat=match_dist_flat,
        match_weight=match_weight, trunc=trunc)
    if spans.enabled:
        og.count_live_tables(layout.tile_group, skipw)
    score = s_sorted[layout.dest]
    mcount = m_sorted[layout.dest]

    q_of = og.overflow_transform(stats.A, layout.over_idx, points)
    code = og.overflow_field_lookup(df.field, q_of)               # [C, K]
    d_of = code.to(torch.float32) * f32(trunc / 255.0)
    s_of, m_of = _score_from_dist(d_of, valid[None, :], match_dist_min,
                                  match_dist_flat, match_weight, dim=1)
    return (og.scatter_overflow(score, layout.over_idx, s_of),
            og.scatter_overflow(mcount, layout.over_idx, m_of))


def box_queries(df: DistanceField, pos, rmat, points):
    """Shared set-up of tiers 1 and 2: ``(iq [K, N, 3] i32 cells, lo [K, 3]
    per-point box origin, ext [K, 3] per-point extent)``."""
    transformed = (torch.einsum("kj,nij->kni", points, rmat)
                   + pos[None, :, :])                            # [K, N, 3]
    w = torch.tensor(df.weights, dtype=torch.float32, device=pos.device)
    cell = torch.full((), f32(df.cell), device=pos.device)
    u = (transformed * w - df.origin) / cell
    iq = torch.round(u).to(torch.int32)
    lo = torch.amin(iq, dim=1)
    return iq, lo, torch.amax(iq, dim=1) - lo


def box_tables(df: DistanceField, iq, lo, valid):
    """Tier-1 inputs: ``(tables [K, R, 128] f32, lidx [K, N] i32)``, the
    32x32x16-cell distance box of each point (invalid points and cells
    out of the map read trunc) and each query's flat index in it."""
    bx, by, bz = _BOX
    kk = lo.shape[0]
    dev = lo.device
    trunc = f32(df.trunc)
    offs = torch.stack(torch.meshgrid(
        torch.arange(bx, device=dev), torch.arange(by, device=dev),
        torch.arange(bz, device=dev), indexing="ij"), dim=-1
    ).reshape(-1, 3).to(torch.int32)                             # [BOX, 3]
    code, oob = gather_codes(df.field, lo[:, None, :] + offs[None])
    vals = code.to(torch.float32) * f32(df.trunc / 255.0)
    vals = torch.where(oob | ~valid[:, None], trunc, vals)
    tables = vals.reshape(kk, bx * by * bz // 128, 128)
    dl = iq - lo[:, None, :]
    lidx = (dl[..., 0] * by + dl[..., 1]) * bz + dl[..., 2]
    lidx = torch.clamp(lidx, 0, bx * by * bz - 1).to(torch.int32)
    return tables, lidx


def _gather_score(df, iq, valid, match_dist_min, match_dist_flat,
                  match_weight):
    """Tier 2: nearest-cell gather from the shared ``iq``."""
    code, oob = gather_codes(df.field, iq)
    d = torch.where(oob, f32(df.trunc),
                    code.to(torch.float32) * f32(df.trunc / 255.0))  # [K, N]
    return _score_from_dist(d, valid[:, None], match_dist_min,
                            match_dist_flat, match_weight, dim=0)


def box_path(n: int, trunc: float, match_dist_min: float, *,
             trilinear: bool = False, local_kernel: bool = True) -> bool:
    """Whether ``likelihood_measure`` at capacity ``n`` may take the box
    path (tiers 0 and 1 and their fallback), whose choice reads flags on
    the host: nearest sampling with the local kernel on, ``n`` a whole
    number of 128-slot rows, and a truncation past ``match_dist_min``.
    Otherwise the step samples the whole field at tier 2 with no host
    read (``step_graph`` decides its graphs by the same rule)."""
    return (local_kernel and not trilinear and n % 128 == 0 and n >= 128
            and float(trunc) > float(match_dist_min))


def likelihood_measure(df: DistanceField, pos, rot, points, valid,
                       match_dist_min: float, match_dist_flat: float,
                       match_weight: float, *, active=None, rmat=None,
                       grouped=None, trilinear=False, local_kernel=True):
    """``(likelihood [N], quality [N], tier)`` with nearest-cell sampling,
    or with ``trilinear`` the interpolated field (tier 2, kernel M4 on the
    card).

    ``grouped``: ``(stats, layout, lo, fits)`` prepared by the engine, which
    shares one sorted layout with the beam model; ``fits`` is a host bool
    and ``layout`` is ``None`` when it is False.  Built here when omitted
    and eligible (N a tile multiple).  ``active`` masks inactive capacity
    slots out of the bin envelopes.  ``local_kernel=False`` samples the
    whole field with no host read (tier 2; the batched fleet).
    """
    n = pos.shape[0]
    kw = dict(match_dist_min=match_dist_min, match_dist_flat=match_dist_flat,
              match_weight=match_weight)
    use_local = box_path(n, df.trunc, match_dist_min, trilinear=trilinear,
                         local_kernel=local_kernel)
    if rmat is None:
        rmat = mq.rotation_matrix(mq.normalize(rot))

    if not use_local:
        transformed = torch.einsum("kj,nij->nki", points, rmat) + pos[:, None, :]
        d = sample_field(df, transformed, trilinear)              # [N, K]
        score, mcount = _score_from_dist(d, valid[None, :], dim=-1, **kw)
        return (*_finalize(score, mcount, valid), TIER_GATHER)

    if grouped is None and n % og.TILE == 0:
        act = torch.ones((n,), dtype=torch.bool, device=pos.device) \
            if active is None else active
        cap = og.default_overflow_cap(n)
        stats = og.group_stats(pos, rmat, rot, df.weights, float(df.cell),
                               df.origin, act)
        lo, fits_kg = og.group_boxes(stats, points, df.shape)
        with spans.span("read.box"):
            fits = bool(torch.all(fits_kg | ~valid[:, None])
                        & (stats.n_over <= cap))
        grouped = (stats, og.build_layout(stats, cap) if fits else None,
                   lo, fits)

    if grouped is not None and grouped[3]:
        stats, layout, lo, _ = grouped
        score, mcount = grouped_like_apply(df, stats, layout, lo, points,
                                           valid, **kw)
        tier = TIER_GROUPED
    else:
        iq, lo, ext = box_queries(df, pos, rmat, points)
        box = torch.tensor(_BOX, dtype=torch.int32, device=pos.device)
        with spans.span("read.box"):
            in_box = bool(torch.all((ext < box) | ~valid[:, None]))
        if in_box:
            tables, lidx = box_tables(df, iq, lo, valid)
            score, mcount = local_score(tables, lidx, **kw)
            tier = TIER_BOX
        else:
            score, mcount = _gather_score(df, iq, valid, **kw)
            tier = TIER_GATHER
    return (*_finalize(score, mcount, valid), tier)
