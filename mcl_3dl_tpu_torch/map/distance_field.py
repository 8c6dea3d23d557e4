"""Truncated anisotropic voxel distance field.

Replaces the reference's per-point kd-tree ``radiusSearch``
(chunked_kdtree.h:217-237): at map load, every voxel cell center gets
the distance to the nearest map point under the anisotropic metric
(coordinates scaled by ``dist_weight``), truncated at ``trunc`` and
quantized to u8 (distance = code * trunc / 255).  Every radius query
then becomes a gather + compare on the device.

The build is the JAX package's numpy build (``distance_field.py``,
numpy path) restated line for line, so the u8 field is byte-identical
to it.  Trilinear sampling and the corner pack are not ported:
``Params.likelihood.interp`` must be ``"nearest"``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mcl_3dl_tpu_torch.math import f32

ZW = 128        # z lanes of one local-table row (ops/grouped.py)


@dataclass(frozen=True)
class DistanceField:
    """Device-resident truncated distance field in weighted space.

    Cell centers sit at ``origin + idx * cell`` (weighted coordinates);
    out-of-bounds queries read ``trunc``.  ``field2d`` is the z-major view
    ``[nx*ny, max(nz, 128)]`` with z padded by 255 (= trunc), the row
    source of the grouped local tables.
    """

    field: torch.Tensor          # [nx, ny, nz] uint8
    origin: torch.Tensor         # [3] float32
    cell: float
    trunc: float
    weights: tuple               # (wx, wy, wz)
    field2d: torch.Tensor        # [nx*ny, max(nz, 128)] uint8

    @property
    def shape(self):
        return tuple(self.field.shape)

    @property
    def device(self):
        return self.field.device

    def sample_nearest(self, q):
        """Nearest-cell distance at query points ``q`` [..., 3]."""
        w = torch.tensor(self.weights, dtype=torch.float32, device=q.device)
        cell = torch.tensor(f32(self.cell), device=q.device)
        u = (q * w - self.origin) / cell
        code, oob = gather_codes(self.field, torch.round(u).to(torch.int32))
        return torch.where(oob, f32(self.trunc),
                           code.to(torch.float32) * f32(self.trunc / 255.0))


def gather_codes(field, iq):
    """``(code, oob)``: u8 codes of the field at integer cells ``iq``
    [..., 3] (clamped into the map) and the out-of-map mask."""
    nx, ny, nz = field.shape
    dims = torch.tensor([nx, ny, nz], dtype=torch.int32, device=iq.device)
    oob = torch.any((iq < 0) | (iq >= dims), dim=-1)
    ic = torch.minimum(torch.clamp(iq, min=0), dims - 1).to(torch.int64)
    flat = (ic[..., 0] * ny + ic[..., 1]) * nz + ic[..., 2]
    return field.reshape(-1)[flat], oob


def _segment_min_scatter(field_flat, target_ids, values):
    """field_flat[id] = min(field_flat[id], min(values where target==id));
    ``target_ids`` sorted ascending."""
    if target_ids.size == 0:
        return
    starts = np.flatnonzero(
        np.concatenate([[True], target_ids[1:] != target_ids[:-1]]))
    mins = np.minimum.reduceat(values, starts)
    ids = target_ids[starts]
    np.minimum.at(field_flat, ids, mins)


def _finish(q3d, origin, cell, trunc, weights, device):
    nx, ny, nz = q3d.shape
    nzp = max(nz, ZW)
    q2d = np.pad(q3d, ((0, 0), (0, 0), (0, nzp - nz)),
                 constant_values=255).reshape(nx * ny, nzp)
    return DistanceField(
        field=torch.tensor(q3d, device=device),
        origin=torch.as_tensor(np.asarray(origin), dtype=torch.float32,
                               device=device),
        cell=float(cell), trunc=float(trunc), weights=tuple(weights),
        field2d=torch.tensor(q2d, device=device),
    )


def build_field_codes(points, cell, trunc, weights=(1.0, 1.0, 1.0),
                      grid=None):
    """Numpy build of the u8 field: ``(codes [nx, ny, nz], origin [3])``.

    Exact within the truncation radius: every cell whose weighted
    distance to some point is below ``trunc`` gets the true minimum.
    ``grid``: optional ``(origin [3], (nx, ny, nz))`` in weighted space,
    so the label-filtered beam field shares the likelihood field's grid.
    """
    w = np.asarray(tuple(float(x) for x in weights), dtype=np.float64)
    points = np.asarray(points, dtype=np.float64).reshape(-1, 3) * w
    pad = trunc + cell
    if points.shape[0] == 0 and grid is None:
        return np.full((1, 1, 1), 255, np.uint8), np.zeros(3)
    if grid is not None:
        origin = np.asarray(grid[0], dtype=np.float64)
        nx, ny, nz = (int(d) for d in grid[1])
        if points.shape[0] == 0:
            return np.full((nx, ny, nz), 255, np.uint8), origin
    else:
        min_p = points.min(axis=0) - pad
        max_p = points.max(axis=0) + pad
        origin = min_p
        dims = np.ceil((max_p - origin) / cell).astype(np.int64) + 1
        nx, ny, nz = (int(d) for d in dims)

    field_flat = np.full(nx * ny * nz, np.float32(trunc), dtype=np.float32)
    base = np.round((points - origin) / cell).astype(np.int64)
    base_flat = (base[:, 0] * ny + base[:, 1]) * nz + base[:, 2]
    order = np.argsort(base_flat, kind="stable")
    points = points[order]
    base = base[order]
    base_flat = base_flat[order]

    r = int(np.ceil(trunc / cell + 0.5))
    centers_base = origin + base * cell
    for dx in range(-r, r + 1):
        ix = base[:, 0] + dx
        vx = (ix >= 0) & (ix < nx)
        ddx = centers_base[:, 0] + dx * cell - points[:, 0]
        for dy in range(-r, r + 1):
            iy = base[:, 1] + dy
            vxy = vx & (iy >= 0) & (iy < ny)
            ddy = centers_base[:, 1] + dy * cell - points[:, 1]
            dxy2 = ddx * ddx + ddy * ddy
            if (dxy2.min() if dxy2.size else 0.0) >= trunc * trunc:
                continue
            for dz in range(-r, r + 1):
                iz = base[:, 2] + dz
                valid = vxy & (iz >= 0) & (iz < nz)
                ddz = centers_base[:, 2] + dz * cell - points[:, 2]
                dist = np.sqrt(dxy2 + ddz * ddz)
                sel = valid & (dist < trunc)
                if not sel.any():
                    continue
                const = (dx * ny + dy) * nz + dz
                _segment_min_scatter(field_flat, base_flat[sel] + const,
                                     dist[sel].astype(np.float32))

    q = np.clip(np.round(field_flat / trunc * 255.0), 0, 255).astype(np.uint8)
    return q.reshape(nx, ny, nz), origin


def build_distance_field(points, cell, trunc, weights=(1.0, 1.0, 1.0),
                         grid=None, device=None) -> DistanceField:
    """Build the truncated distance field from map points [M, 3] and place
    it on ``device``."""
    codes, origin = build_field_codes(points, cell, trunc, weights, grid)
    return _finish(codes, origin, cell, trunc,
                   tuple(float(x) for x in weights), device)


def from_codes(field, origin, cell, trunc, weights, device=None) -> DistanceField:
    """Container around an existing u8 field (used by ``convert.py``)."""
    return _finish(np.asarray(field, np.uint8), np.asarray(origin), cell,
                   trunc, tuple(float(x) for x in weights), device)
