"""Truncated anisotropic voxel distance field.

Replaces the reference's per-point kd-tree ``radiusSearch``
(chunked_kdtree.h:217-237): at map load, every voxel cell center gets
the distance to the nearest map point under the anisotropic metric
(coordinates scaled by ``dist_weight``), truncated at ``trunc`` and
quantized to u8 (distance = code * trunc / 255).  Every radius query
then becomes a gather + compare on the device.

The build is the JAX package's numpy build (``distance_field.py``,
numpy path) restated line for line, so the u8 field and the corner pack
are byte-identical to it; its splat runs in the native map compiler
(``map/native.py``), which gives the numpy splat's bytes.

Two samplers: nearest cell (one gather a query) and trilinear (the
eight corners of the cell cube around the query).  With the corner pack
(``packed``, 8 bytes a cell: the 2x2x2 cube above each cell) a trilinear
query is one row gather of two 32-bit words instead of eight gathers.
``sample_field`` runs either as kernel M4 (``csrc/tier2.cu``) on the
card; the ``sample_*`` methods are its plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from mcl_3dl_tpu_torch.map.native import build_distance_field_native
from mcl_3dl_tpu_torch.math import device_constant, f32
from mcl_3dl_tpu_torch.ops import build

ZW = 128        # z lanes of one local-table row (ops/grouped.py)


@dataclass(frozen=True)
class DistanceField:
    """Device-resident truncated distance field in weighted space.

    Cell centers sit at ``origin + idx * cell`` (weighted coordinates);
    out-of-bounds queries read ``trunc``.  ``field2d`` is the z-major view
    ``[nx*ny, max(nz, 128)]`` with z padded by 255 (= trunc), the row
    source of the grouped local tables.  ``packed`` ``[nx*ny*nz, 2]``
    holds the corner pack's 32-bit words as int32 (the same bytes as the
    JAX package's uint32 table), or ``None``.
    """

    field: torch.Tensor          # [nx, ny, nz] uint8
    origin: torch.Tensor         # [3] float32
    cell: float
    trunc: float
    weights: tuple               # (wx, wy, wz)
    field2d: torch.Tensor        # [nx*ny, max(nz, 128)] uint8
    packed: Optional[torch.Tensor] = None   # [nx*ny*nz, 2] int32 corner pack

    @property
    def shape(self):
        return tuple(self.field.shape)

    @property
    def device(self):
        return self.field.device

    def _cells(self, q):
        """Query points ``q`` [..., 3] in cell units of the grid."""
        w = device_constant(self.weights, torch.float32, q.device)
        cell = device_constant(f32(self.cell), torch.float32, q.device)
        return (q * w - self.origin) / cell

    def sample_nearest(self, q):
        """Nearest-cell distance at query points ``q`` [..., 3]."""
        u = self._cells(q)
        code, oob = gather_codes(self.field, torch.round(u).to(torch.int32))
        return torch.where(oob, f32(self.trunc),
                           code.to(torch.float32) * f32(self.trunc / 255.0))

    def sample_trilinear(self, q):
        """Trilinearly interpolated distance at query points ``q`` [..., 3]:
        the eight corners of the cell cube at ``floor(u)``, each out-of-map
        corner reading ``trunc``.  Through the corner pack when the field
        has one (one row gather a query), else eight gathers."""
        u = self._cells(q)
        i0 = torch.floor(u).to(torch.int32)
        f = u - i0.to(torch.float32)
        dims = torch.tensor(self.shape, dtype=torch.int32, device=q.device)
        # in_map[d][..., a]: corner offset d along axis a stays in the map
        in_map = [(i0 + d >= 0) & (i0 + d < dims) for d in (0, 1)]
        w = [(1.0 - f[..., a], f[..., a]) for a in range(3)]
        scale = f32(self.trunc / 255.0)
        trunc = f32(self.trunc)
        if self.packed is not None:
            ic = torch.minimum(torch.clamp(i0, min=0), dims - 2).to(torch.int64)
            _, ny, nz = self.shape
            rows = self.packed[(ic[..., 0] * ny + ic[..., 1]) * nz + ic[..., 2]]
        out = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    if self.packed is not None:
                        code = (rows[..., dx] >> (8 * (dz + 2 * dy))) & 0xFF
                    else:
                        code, _ = gather_codes(
                            self.field, i0 + torch.tensor(
                                [dx, dy, dz], dtype=torch.int32,
                                device=q.device))
                    ok = (in_map[dx][..., 0] & in_map[dy][..., 1]
                          & in_map[dz][..., 2])
                    v = torch.where(ok, code.to(torch.float32) * scale, trunc)
                    out = out + w[0][dx] * w[1][dy] * w[2][dz] * v
        return out


def sample_field(df: DistanceField, q, trilinear: bool):
    """Kernel M4 (``csrc/tier2.cu``): the field at queries ``q`` [..., 3],
    ``[...]`` f32, bit-equal to ``df.sample_trilinear(q)`` (through the
    corner pack where the field has one) or ``df.sample_nearest(q)``, its
    plain versions, which it takes for CPU tensors.  One thread a query.
    It replaces no Pallas kernel: on the TPU the tier-2 likelihood's
    gather is what XLA fuses (mcl_3dl_tpu/models/likelihood.py:170-187)."""
    if not q.is_cuda:
        return df.sample_trilinear(q) if trilinear else df.sample_nearest(q)
    trunc = float(df.trunc)
    wx, wy, wz = (f32(w) for w in df.weights)
    out = build.op("sample_field")(
        q.reshape(-1, 3).contiguous(), df.field,
        df.packed if trilinear else None, df.origin, wx, wy, wz,
        f32(df.cell), f32(trunc / 255.0), f32(trunc), bool(trilinear))
    sample_field.launches += 1
    return out.reshape(q.shape[:-1])


sample_field.launches = 0


def gather_codes(field, iq):
    """``(code, oob)``: u8 codes of the field at integer cells ``iq``
    [..., 3] (clamped into the map) and the out-of-map mask."""
    nx, ny, nz = field.shape
    dims = device_constant((nx, ny, nz), torch.int32, iq.device)
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


def corner_pack(q: np.ndarray) -> np.ndarray:
    """The corner pack of a u8 field [nx, ny, nz]: for every cell the 8
    cells of its +1 corner cube in two uint32 words, word ``dx``'s byte
    ``dz + 2*dy``; cells past the high edges read 255 (= trunc).
    ``[nx*ny*nz, 2]`` uint32, the JAX package's ``_pack_corners``."""
    nx, ny, nz = q.shape
    qp = np.pad(q, ((0, 1), (0, 1), (0, 1)), constant_values=255)
    words = []
    for dx in (0, 1):
        w = np.zeros((nx, ny, nz), np.uint32)
        for dy in (0, 1):
            for dz in (0, 1):
                c = qp[dx:dx + nx, dy:dy + ny, dz:dz + nz].astype(np.uint32)
                w |= c << np.uint32(8 * (dz + 2 * dy))
        words.append(w.reshape(-1))
    return np.stack(words, axis=-1)


def _packs(shape, pack: bool) -> bool:
    """Whether a field of ``shape`` gets a corner pack: asked for, at least
    two cells on every axis, and at most 192M cells (8 bytes a cell)."""
    nx, ny, nz = shape
    return pack and min(nx, ny, nz) >= 2 and nx * ny * nz <= 192_000_000


def _finish(q3d, origin, cell, trunc, weights, device, pack=False):
    nx, ny, nz = q3d.shape
    nzp = max(nz, ZW)
    q2d = np.pad(q3d, ((0, 0), (0, 0), (0, nzp - nz)),
                 constant_values=255).reshape(nx * ny, nzp)
    packed = None
    if _packs(q3d.shape, pack):
        packed = torch.tensor(corner_pack(q3d).view(np.int32), device=device)
    return DistanceField(
        field=torch.tensor(q3d, device=device),
        origin=torch.as_tensor(np.asarray(origin), dtype=torch.float32,
                               device=device),
        cell=float(cell), trunc=float(trunc), weights=tuple(weights),
        field2d=torch.tensor(q2d, device=device), packed=packed,
    )


def build_field_codes(points, cell, trunc, weights=(1.0, 1.0, 1.0),
                      grid=None, native=True):
    """The u8 field: ``(codes [nx, ny, nz], origin [3])``.

    Exact within the truncation radius: every cell whose weighted
    distance to some point is below ``trunc`` gets the true minimum.
    ``grid``: optional ``(origin [3], (nx, ny, nz))`` in weighted space,
    so the label-filtered beam field shares the likelihood field's grid.
    The splat runs in the native map compiler (``map/native.py``), or with
    ``native=False`` in numpy, its plain version; both give the same
    bytes.
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

    if native:
        field_flat = build_distance_field_native(
            points, cell, trunc, origin, (nx, ny, nz)).reshape(-1)
    else:
        field_flat = _splat_numpy(points, cell, trunc, origin, (nx, ny, nz))
    q = np.clip(np.round(field_flat / trunc * 255.0), 0, 255).astype(np.uint8)
    return q.reshape(nx, ny, nz), origin


def _splat_numpy(points, cell, trunc, origin, dims):
    """The numpy splat: the flat float32 field of ``build_field_codes``."""
    nx, ny, nz = dims
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
    return field_flat


def build_distance_field(points, cell, trunc, weights=(1.0, 1.0, 1.0),
                         grid=None, device=None,
                         pack_corners=True) -> DistanceField:
    """Build the truncated distance field from map points [M, 3] and place
    it on ``device``; ``pack_corners`` adds the corner pack of trilinear
    sampling (not for an empty map)."""
    codes, origin = build_field_codes(points, cell, trunc, weights, grid)
    pack = pack_corners and np.asarray(points).size > 0
    return _finish(codes, origin, cell, trunc,
                   tuple(float(x) for x in weights), device, pack)


def from_codes(field, origin, cell, trunc, weights, device=None,
               pack=False) -> DistanceField:
    """Container around an existing u8 field (used by ``convert.py``),
    with the corner pack derived from it if ``pack``."""
    return _finish(np.asarray(field, np.uint8), np.asarray(origin), cell,
                   trunc, tuple(float(x) for x in weights), device, pack)
