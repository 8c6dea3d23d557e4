"""The distance field, built from the map points alone.

Every cell centre of a grid in weighted space (coordinates scaled by the
distance weights) gets the weighted distance to its nearest map point
(a SciPy k-d tree), truncated at ``trunc`` and coded in a byte
(distance = code * trunc / 255).  The map is first voxel-downsampled
as the node does at map load (PCL ``VoxelGrid``: the centroid of each
occupied voxel, in voxel-index order).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from scipy.spatial import cKDTree


def f32(x) -> float:
    """``x`` rounded once to float32."""
    return float(np.float32(x))


def voxel_downsample(points, leaf, labels=None):
    """Centroids [M, 3] f32: one per occupied voxel of size ``leaf``,
    ordered by the voxel's flat index; with ``labels`` [N] (each point's
    sensor) also each voxel's label [M]: the mean of its points' labels,
    rounded half to even."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    leaf = np.broadcast_to(np.asarray(leaf, np.float64), (3,))
    ijk = np.floor(pts / leaf).astype(np.int64)
    ijk -= ijk.min(axis=0)
    dims = ijk.max(axis=0) + 1
    flat = (ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]
    keys, inv, counts = np.unique(flat, return_inverse=True,
                                  return_counts=True)
    sums = np.zeros((keys.size, 3))
    np.add.at(sums, inv, pts)
    centroids = (sums / counts[:, None]).astype(np.float32)
    if labels is None:
        return centroids
    label_sums = np.zeros(keys.size)
    np.add.at(label_sums, inv, np.asarray(labels, np.float64))
    return centroids, np.round(label_sums / counts).astype(np.int64)


def truncation(cfg) -> float:
    """The field's truncation: past every radius query of the node (the
    likelihood's match distance, the unmatched-point distance and the
    raycast's collision radius plus two probe steps), plus two cells."""
    return max(cfg["match_dist_min"], cfg["unmatch_output_dist"],
               math.sqrt(2.0) * cfg["map_grid_max"] / 2.0
               + 2.0 * cfg["map_grid_min"]) + 2.0 * cfg["cell"]


def grid(points_w, cell, trunc):
    """``(origin [3] f64, dims (nx, ny, nz))`` of the grid around weighted
    points, padded by ``trunc + cell``."""
    pad = trunc + cell
    origin = points_w.min(axis=0) - pad
    dims = np.ceil((points_w.max(axis=0) + pad - origin) / cell).astype(
        np.int64) + 1
    return origin, tuple(int(d) for d in dims)


@dataclass
class Field:
    codes: torch.Tensor      # [nx, ny, nz] uint8
    origin: torch.Tensor     # [3] f32
    cell: float
    trunc: float
    weights: tuple

    @property
    def dims(self):
        return tuple(self.codes.shape)

    def nearest(self, q, dtype=torch.float32):
        """Distance at the nearest cell centre of each query ``q`` [..., 3];
        a query outside the grid reads ``trunc``.  ``dtype`` is the
        precision of the arithmetic (the control computes in bfloat16)."""
        dev = q.device
        w = torch.tensor(self.weights, dtype=dtype).to(dev, non_blocking=True)
        u = (q.to(dtype) * w - self.origin.to(dtype)) / torch.full(
            (), f32(self.cell), dtype=dtype, device=dev)
        iq = torch.round(u.float()).to(torch.int64)
        nx, ny, nz = self.dims
        oob = ((iq < 0).any(dim=-1) | (iq[..., 0] >= nx)
               | (iq[..., 1] >= ny) | (iq[..., 2] >= nz))
        ix = iq[..., 0].clamp(0, nx - 1)
        iy = iq[..., 1].clamp(0, ny - 1)
        iz = iq[..., 2].clamp(0, nz - 1)
        code = self.codes.reshape(-1)[(ix * ny + iy) * nz + iz]
        d = code.to(dtype) * f32(self.trunc / 255.0)
        return torch.where(oob, torch.full((), f32(self.trunc), dtype=dtype,
                                           device=dev), d)


def build(map_points, cfg, device) -> Field:
    """The field of ``map_points`` [M, 3] under the configuration's grid
    (``cfg``: ``map_leaf``, ``cell``, ``weights`` and the radii of
    ``truncation``)."""
    pts = voxel_downsample(map_points, cfg["map_leaf"])
    w = np.asarray(cfg["weights"], np.float64)
    pw = pts.astype(np.float64) * w
    cell = cfg["cell"]
    trunc = truncation(cfg)
    origin, (nx, ny, nz) = grid(pw, cell, trunc)
    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    centres = origin + np.stack([ii, jj, kk], -1).reshape(-1, 3) * cell
    dist, _ = cKDTree(pw).query(centres, distance_upper_bound=trunc,
                                workers=4)
    d32 = np.where(dist < trunc, dist, trunc).astype(np.float32)
    codes = np.clip(np.round(d32 / np.float32(trunc) * np.float32(255.0)),
                    0, 255).astype(np.uint8).reshape(nx, ny, nz)
    return Field(torch.as_tensor(codes, device=device),
                 torch.as_tensor(origin.astype(np.float32), device=device),
                 float(cell), float(trunc), tuple(float(x) for x in w))
