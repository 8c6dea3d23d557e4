"""Voxel-grid downsampling (host side, numpy).

Matches the semantics of ``pcl::VoxelGrid`` as used throughout the
reference node (map load src/mcl_3dl.cpp:1155-1158, scan downsample
:363-367, map update :148-152, global localization :1050-1056): points
are bucketed into cells of the leaf size and each non-empty cell emits
the centroid of its points.  Extra per-point attributes (intensity,
label) are averaged too, which is PCL's ``downsample_all_data`` default —
a quirk the beam model's label-transparency feature inherits.
"""

from __future__ import annotations

import numpy as np


def voxel_downsample(
    points: np.ndarray,
    leaf,
    attrs: np.ndarray | None = None,
):
    """Downsample ``points`` [M, 3] to voxel centroids.

    Args:
        points: float array [M, 3].
        leaf: scalar or per-axis (3,) leaf size.
        attrs: optional [M, A] extra columns, averaged per cell.

    Returns ``centroids [K, 3]`` (or ``(centroids, attrs_out)`` when
    ``attrs`` is given), ordered by voxel index like PCL.
    """
    points = np.asarray(points, dtype=np.float64)
    if points.size == 0:
        if attrs is None:
            return points.astype(np.float32).reshape(0, 3)
        return points.astype(np.float32).reshape(0, 3), np.zeros(
            (0, attrs.shape[1]), np.float32
        )
    leaf = np.broadcast_to(np.asarray(leaf, dtype=np.float64), (3,))
    min_b = np.floor(points.min(axis=0) / leaf).astype(np.int64)
    ijk = np.floor(points / leaf).astype(np.int64) - min_b
    dims = ijk.max(axis=0) + 1
    flat = (ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]

    order = np.argsort(flat, kind="stable")
    flat_sorted = flat[order]
    starts = np.flatnonzero(
        np.concatenate([[True], flat_sorted[1:] != flat_sorted[:-1]])
    )
    counts = np.diff(np.concatenate([starts, [flat.size]]))

    pts_sorted = points[order]
    centroids = np.add.reduceat(pts_sorted, starts, axis=0) / counts[:, None]
    centroids = centroids.astype(np.float32)
    if attrs is None:
        return centroids
    attrs_sorted = np.asarray(attrs, dtype=np.float64)[order]
    attrs_out = np.add.reduceat(attrs_sorted, starts, axis=0) / counts[:, None]
    return centroids, attrs_out.astype(np.float32)
