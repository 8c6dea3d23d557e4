"""Scan-point uniform sampler (``PointCloudUniformSampler``,
point_cloud_random_samplers/point_cloud_uniform_sampler.h:44-75):
``num_points`` draws with replacement, uniform over the clipped cloud,
on a fixed-capacity padded point buffer with a validity mask.

The draw itself is an input: ``sample_uniform`` takes the drawn indices,
and ``draw_uniform_indices`` makes them from a ``torch.Generator`` the way
``jax.random.choice(..., p=valid / n_valid)`` does (inverse CDF of one
uniform per slot).  The normal-weighted sampler is not ported.
"""

from __future__ import annotations

import torch

from mcl_3dl_tpu_torch.math import cumsum


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
