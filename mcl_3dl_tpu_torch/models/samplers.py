"""Scan-point random samplers (reference layer L3), on a fixed-capacity
padded point buffer with a validity mask.

``sample_uniform`` is ``PointCloudUniformSampler``
(point_cloud_random_samplers/point_cloud_uniform_sampler.h:44-75):
``num_points`` draws with replacement, uniform over the clipped cloud.
Its draw is an input: ``draw_uniform_indices`` makes the indices from a
``torch.Generator`` the way ``jax.random.choice(..., p=valid / n_valid)``
does (inverse CDF of one uniform per slot).

``sampler_with_normal_weights`` and ``sample_weighted_without_replacement``
are ``PointCloudSamplerWithNormal``
(point_cloud_random_samplers/point_cloud_sampler_with_normal.h:54-186):
points whose surface normal lines up with the particle cloud's dominant
position uncertainty are up-weighted, and the draw has no duplicates (the
Gumbel top-k trick; the Gumbel draws are an input,
``draw_gumbel``).  Normals come from ``estimate_normals_host``, a PCA
of each point's neighbours on the host (scipy's ``cKDTree``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mcl_3dl_tpu_torch.math import cumsum, f32
from mcl_3dl_tpu_torch.math import quat as mq


def draw_uniform_indices(valid, num_points: int, generator) -> torch.Tensor:
    """``num_points`` indices drawn uniformly over the valid entries."""
    p = valid / torch.clamp(torch.sum(valid), min=1)
    p_cuml = cumsum(p)
    u = torch.rand((num_points,), generator=generator, device=valid.device)
    r = p_cuml[-1] * (1.0 - u)
    idx = torch.searchsorted(p_cuml, r)
    return torch.clamp(idx, max=valid.shape[0] - 1)


def sample_uniform(points, valid, idx):
    """``(sampled [num_points, C], sampled_valid [num_points], idx)``; if no
    point is valid every slot is invalid (the engine then raises the
    reference's ERROR_POINTS_NOT_FOUND, src/mcl_3dl.cpp:385-391)."""
    sampled = points[idx]
    ok = (torch.sum(valid) > 0).expand(idx.shape[0])
    return sampled, ok, idx


def estimate_normals_host(points, search_range: float) -> np.ndarray:
    """Per-point surface normals [M, 3] f32 by neighbourhood PCA on the
    host: the eigenvector of the smallest eigenvalue of the covariance of
    the neighbours within ``search_range`` (PCL ``NormalEstimation`` with
    a radius search, point_cloud_sampler_with_normal.h:95-109).  Points
    with fewer than 3 neighbours get a zero normal."""
    from scipy.spatial import cKDTree

    points = np.asarray(points, np.float64).reshape(-1, 3)
    m = points.shape[0]
    normals = np.zeros((m, 3), np.float32)
    if m == 0:
        return normals
    tree = cKDTree(points)
    neigh = tree.query_ball_point(points, search_range, workers=-1)
    counts = np.fromiter((len(n) for n in neigh), np.int64, m)
    idx = np.concatenate([np.asarray(n, np.int64) for n in neigh]) \
        if counts.sum() else np.zeros((0,), np.int64)
    starts = np.zeros((m,), np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    q = points[idx]
    # scatter matrix from segment moments, sum(q q^T) - n mean mean^T: the
    # eigenvectors of the centered covariance
    s1 = np.add.reduceat(q, starts, axis=0)
    outer = q[:, :, None] * q[:, None, :]
    s2 = np.add.reduceat(outer.reshape(-1, 9), starts, axis=0)
    # a zero-length segment of reduceat reads the element at its start:
    # masked out by the count
    ok = counts >= 3
    n = np.maximum(counts, 1).astype(np.float64)[:, None]
    mean = s1 / n
    cov = s2.reshape(-1, 3, 3) - (n[..., None] * mean[:, :, None]
                                  * mean[:, None, :])
    cov_ok = cov[ok]
    if cov_ok.shape[0]:
        _, v = np.linalg.eigh(cov_ok)
        normals[ok] = v[:, :, 0].astype(np.float32)
    return normals


def normal_weight_direction(pos_cov, mean_rot, perform_weighting_ratio: float,
                            max_weight_ratio: float, max_weight: float):
    """``(direction [3], amp [])`` of the weighting
    (point_cloud_sampler_with_normal.h:83, 110-129): the dominant
    eigenvector of the elementwise-abs position covariance, rotated into
    the mean pose's frame (where the scan normals live), and the
    amplification, ramped with the sqrt ratio of the two largest
    eigenvalues between ``perform_weighting_ratio`` and
    ``max_weight_ratio``.  One ``eigh`` of a 3x3 matrix (a library call;
    on CUDA it waits for the device)."""
    w, v = torch.linalg.eigh(torch.abs(pos_cov))       # ascending
    ratio = torch.sqrt(torch.clamp(w[2], min=0.0) / torch.clamp(w[1], min=1e-12))
    direction = mq.rotate(mq.inv(mean_rot), v[:, 2])
    t = (ratio - perform_weighting_ratio) / f32(
        max_weight_ratio - perform_weighting_ratio)
    amp = 1.0 + torch.clamp(t, 0.0, 1.0) * f32(max_weight - 1.0)
    return direction, amp


def weights_along(normals, valid, direction, amp):
    """Per-point weights [P] (point_cloud_sampler_with_normal.h:144-158):
    ``1 + (amp - 1)(pi/2 - angle)/(pi/2)`` in the angle between a point's
    normal and ``direction``; a zero normal keeps weight 1, an invalid
    point gets 0."""
    cos = torch.clamp(torch.abs(torch.sum(normals * direction, dim=-1)),
                      0.0, 1.0)
    half_pi = f32(math.pi / 2)
    weights = 1.0 + (amp - 1.0) * ((half_pi - torch.arccos(cos)) / half_pi)
    no_normal = torch.sum(normals * normals, dim=-1) < f32(1e-12)
    weights = torch.where(no_normal, 1.0, weights)
    return torch.where(valid, weights, 0.0)


def sampler_with_normal_weights(normals, valid, pos_cov, mean_rot,
                                perform_weighting_ratio: float,
                                max_weight_ratio: float, max_weight: float):
    """Per-point importance weights [P] from the particle position
    covariance ``pos_cov`` [3, 3] and mean rotation ``mean_rot`` [4]:
    ``weights_along`` of ``normal_weight_direction``."""
    direction, amp = normal_weight_direction(
        pos_cov, mean_rot, perform_weighting_ratio, max_weight_ratio,
        max_weight)
    return weights_along(normals, valid, direction, amp)


def draw_gumbel(n: int, generator, device) -> torch.Tensor:
    """``n`` standard Gumbel draws, ``-log(E)`` of exponential draws."""
    e = torch.empty((n,), device=device).exponential_(generator=generator)
    return -torch.log(e)


def sample_weighted_without_replacement(points, weights, num_points: int,
                                        gumbel):
    """Weighted draw without duplicates
    (point_cloud_sampler_with_normal.h:159-172) by the Gumbel top-k trick
    on the given Gumbel draws [P]: ``(sampled [k, C], ok [k], idx [k])``
    with ``k = min(num_points, P)``, ``ok`` where the drawn weight is
    positive."""
    scores = torch.where(weights > 0,
                         torch.log(torch.clamp(weights, min=1e-30)) + gumbel,
                         -torch.inf)
    k = min(num_points, points.shape[0])
    idx = torch.topk(scores, k, sorted=True).indices
    return points[idx], weights[idx] > 0, idx
