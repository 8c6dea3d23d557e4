"""Dense voxel occupancy / min-label grid for the beam model's DDA raycast.

Replaces ``RaycastUsingDDA``'s host-built voxel point lists
(raycasts/raycast_using_dda.h:162-190): voxels covering the map AABB at
``dda_grid_size``; a voxel is occupied when any map point falls in it.
The minimum point label of each voxel supports label transparency
(lidar_measurement_model_beam.cpp:168-169): a voxel blocks a ray iff it
holds a point with ``label <= filter_label_max``.

Each voxel keeps up to ``REP_POINTS`` spread-sampled representative
points as u8 offsets within the voxel; the raycast tests every one
against the reference's perpendicular-distance rule
(raycast_using_dda.h:237-258).  Voxels with at most ``REP_POINTS``
points are exact.

The build is the JAX package's numpy build (``map/occupancy.py``)
restated line for line, so the grid equals it value for value; it runs
in the native map compiler (``map/native.py``), which gives the numpy
build's bytes.
``min_label`` is held as int64 (the uint32 labels, 0xFFFFFFFF where
empty): torch compares no uint32 tensors on CUDA.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mcl_3dl_tpu_torch.map.native import build_occupancy_rep_native
from mcl_3dl_tpu_torch.math import f32

# representative points stored per voxel; slots beyond the voxel's point
# count repeat its points (idempotent under the any-of test)
REP_POINTS = 4
EMPTY_LABEL = 0xFFFFFFFF


@dataclass(frozen=True)
class OccupancyGrid:
    occupied: torch.Tensor      # [nx, ny, nz] bool
    min_label: torch.Tensor     # [nx, ny, nz] int64 (EMPTY_LABEL when empty)
    rep_point: torch.Tensor     # [nx, ny, nz, REP_POINTS, 3] uint8 offsets
    origin: torch.Tensor        # [3] float32, min corner of voxel (0, 0, 0)
    cell: float

    @property
    def shape(self):
        return tuple(self.occupied.shape)

    def voxel(self, q):
        """Integer voxel [..., 3] of query points ``q`` [..., 3]."""
        cell = torch.full((), f32(self.cell), device=q.device)
        return torch.floor((q - self.origin) / cell).to(torch.int32)

    def lookup(self, q):
        """Query points ``q`` [..., 3] -> ``(occupied, label, rep_pos)``:
        ``rep_pos`` [..., REP_POINTS, 3] are the voxel's dequantized
        representative points (its center when empty); out-of-map queries
        are unoccupied."""
        nx, ny, nz = self.shape
        dims = torch.tensor([nx, ny, nz], dtype=torch.int32, device=q.device)
        idx = self.voxel(q)
        oob = torch.any((idx < 0) | (idx >= dims), dim=-1)
        ic = torch.minimum(torch.clamp(idx, min=0), dims - 1)
        flat = ((ic[..., 0] * ny + ic[..., 1]) * nz + ic[..., 2]).to(torch.int64)
        occ = self.occupied.reshape(-1)[flat] & ~oob
        label = self.min_label.reshape(-1)[flat]
        off = self.rep_point.reshape(-1, REP_POINTS, 3)[flat].to(
            torch.float32) / torch.full((), 255.0, device=q.device)
        pos = self.origin + (ic[..., None, :].to(torch.float32) + off) \
            * f32(self.cell)
        return occ, label, pos


def build_occupancy_arrays(points, cell: float, labels=None, native=True):
    """``(occupied [nx, ny, nz] bool, min_label uint32, rep_point
    [nx, ny, nz, REP_POINTS, 3] uint8, origin [3] float64)``.

    Representatives: ``REP_POINTS`` stride samples of the voxel's point
    list (sorted by voxel, stable) including its first and last member.
    Built by the native map compiler (``map/native.py``), or with
    ``native=False`` in numpy, its plain version; both give the same
    bytes."""
    points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    if labels is None:
        labels = np.zeros((points.shape[0],), np.uint32)
    labels = np.asarray(labels).astype(np.uint32)
    if points.shape[0] == 0:
        return (np.zeros((1, 1, 1), bool),
                np.full((1, 1, 1), EMPTY_LABEL, np.uint32),
                np.full((1, 1, 1, REP_POINTS, 3), 127, np.uint8), np.zeros(3))

    origin = points.min(axis=0)
    # +1 as raycast_using_dda.h:179 (size = span / cell + 1)
    dims = ((points.max(axis=0) - origin) / cell).astype(np.int64) + 1
    nx, ny, nz = (int(d) for d in dims)
    if native:
        occupied, min_label, rep_point = build_occupancy_rep_native(
            points, labels, cell, origin, dims, REP_POINTS)
        return (occupied.reshape(nx, ny, nz), min_label.reshape(nx, ny, nz),
                rep_point.reshape(nx, ny, nz, REP_POINTS, 3), origin)
    idx = np.clip(np.floor((points - origin) / cell).astype(np.int64), 0,
                  dims - 1)
    flat = (idx[:, 0] * ny + idx[:, 1]) * nz + idx[:, 2]
    order = np.argsort(flat, kind="stable")
    flat_s = flat[order]
    starts = np.flatnonzero(np.concatenate([[True], flat_s[1:] != flat_s[:-1]]))
    counts = np.diff(np.concatenate([starts, [flat.size]]))
    uids = flat_s[starts]

    occupied = np.zeros(nx * ny * nz, bool)
    occupied[uids] = True
    min_label = np.full(nx * ny * nz, EMPTY_LABEL, np.uint32)
    min_label[uids] = np.minimum.reduceat(labels[order], starts)

    rep_sel = np.stack([starts + (r * (counts - 1)) // max(REP_POINTS - 1, 1)
                        for r in range(REP_POINTS)], axis=1)      # [V, R]
    rep_pts = points[order][rep_sel]                              # [V, R, 3]
    off = rep_pts / cell - (origin / cell + idx[order][starts])[:, None, :]
    off_q = np.clip(np.round(off * 255.0), 0, 255).astype(np.uint8)
    rep_point = np.full((nx * ny * nz, REP_POINTS, 3), 127, np.uint8)
    rep_point[uids] = off_q
    return (occupied.reshape(nx, ny, nz), min_label.reshape(nx, ny, nz),
            rep_point.reshape(nx, ny, nz, REP_POINTS, 3), origin)


def from_arrays(occupied, min_label, rep_point, origin, cell,
                device=None) -> OccupancyGrid:
    """An ``OccupancyGrid`` on ``device`` around host arrays (also used by
    ``convert.py``)."""
    return OccupancyGrid(
        occupied=torch.as_tensor(np.asarray(occupied, bool), device=device),
        min_label=torch.as_tensor(np.asarray(min_label).astype(np.int64),
                                  device=device),
        rep_point=torch.as_tensor(np.asarray(rep_point, np.uint8),
                                  device=device),
        origin=torch.as_tensor(np.asarray(origin), dtype=torch.float32,
                               device=device),
        cell=float(cell))


def build_occupancy_grid(points, cell: float, labels=None,
                         device=None) -> OccupancyGrid:
    """Build the occupancy grid of map points [M, 3] on the host and place
    it on ``device``."""
    *arrays, origin = build_occupancy_arrays(points, cell, labels)
    return from_arrays(*arrays, origin, cell, device)
