"""Correlative global localization: dense (x, y, yaw) scoring by FFT.

Port of the JAX package's ``map/correlative.py``, its alternative to the
reference's seed-everywhere-and-decay search (src/mcl_3dl.cpp:1039-1099):
the likelihood-field score of every (x, y) cell for each yaw bin,

    S_yaw[t] = sum_k W2[t + q_k(yaw)],

is a 2-D cross-correlation of the planar contribution field ``W2`` with
the impulse image of the yaw-rotated scan, computed by FFT
(``torch.fft``).  The top cells seed the particle filter, which refines z,
roll, pitch and the fine pose with its measurement updates.

The planar field keeps, per (x, y) cell, the largest contribution over
z, so peaks are (x, y, yaw) candidates.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mcl_3dl_tpu_torch.map.distance_field import DistanceField
from mcl_3dl_tpu_torch.math import f32


@dataclass(frozen=True)
class PlanarField:
    """Planar contribution field and its FFT, on the field's device."""

    w2: torch.Tensor          # [fx, fy] float32 contribution, zero-padded
    w2_fft: torch.Tensor      # [fx, fy // 2 + 1] complex64
    origin_xy: torch.Tensor   # [2] weighted-space origin of cell (0, 0)
    cell: float
    shape_unpadded: tuple


def build_planar_field(df: DistanceField, match_dist_min: float,
                       match_dist_flat: float, match_weight: float,
                       z_lo: float, z_hi: float,
                       pad_cells: int) -> PlanarField:
    """Collapse the 3-D distance field into a planar contribution field
    over the (unweighted) world z band ``[z_lo, z_hi]``, padded by
    ``pad_cells`` in x and y."""
    d = df.field.to(torch.float32) * f32(df.trunc / 255.0)     # [nx, ny, nz]
    nz = d.shape[2]
    zs = ((f32(float(df.origin[2])) + torch.arange(
        nz, dtype=torch.float32, device=d.device) * f32(df.cell))
        / f32(df.weights[2]))
    zmask = (zs >= z_lo) & (zs <= z_hi)
    mdm = f32(match_dist_min)
    contrib = torch.where(
        d <= mdm,
        f32(match_weight) * (mdm - torch.clamp(d, min=f32(match_dist_flat))),
        0.0)
    contrib = torch.where(zmask[None, None, :], contrib, 0.0)
    w2 = torch.amax(contrib, dim=2)                            # [nx, ny]
    nx, ny = w2.shape
    w2p = torch.nn.functional.pad(w2, (0, pad_cells, 0, pad_cells))
    return PlanarField(w2=w2p, w2_fft=torch.fft.rfft2(w2p),
                       origin_xy=df.origin[:2], cell=df.cell,
                       shape_unpadded=(nx, ny))


def correlate_scan(field: PlanarField, scan_xy_weighted, yaws):
    """Scores of every (yaw, translation cell), ``[J, fx, fy]``:
    ``scan_xy_weighted`` [K, 2] are the base-frame scan points times
    (wx, wy), ``yaws`` [J] the yaws to test.  The impulse image counts
    scan points per cell offset; its correlation with ``w2`` sums, for
    each translation of the scan origin, each point's contribution at
    its landing cell.  Rotating weighted coordinates is exact when wx ==
    wy (the default)."""
    fx, fy = field.w2.shape
    # a device scalar: torch divides a CUDA tensor by a Python scalar as a
    # reciprocal multiply
    cell = torch.tensor(f32(field.cell), device=yaws.device)
    cos = torch.cos(yaws)[:, None]
    sin = torch.sin(yaws)[:, None]
    x = scan_xy_weighted[None, :, 0]
    y = scan_xy_weighted[None, :, 1]
    rx = cos * x - sin * y                                     # [J, K]
    ry = sin * x + cos * y
    ox = torch.round(rx / cell).to(torch.int64) % fx
    oy = torch.round(ry / cell).to(torch.int64) % fy
    j = torch.arange(yaws.shape[0], device=yaws.device)[:, None].expand_as(ox)
    imgs = torch.zeros((yaws.shape[0], fx, fy), dtype=torch.float32,
                       device=yaws.device)
    imgs.index_put_((j, ox, oy), torch.ones_like(rx), accumulate=True)
    # correlation: IFFT(conj(FFT(impulse)) * FFT(w2))
    return torch.fft.irfft2(torch.conj(torch.fft.rfft2(imgs))
                            * field.w2_fft[None], s=(fx, fy))


def top_candidates(scores, field: PlanarField, n: int):
    """The ``n`` best (x_weighted, y_weighted, yaw index, score) among
    the in-map cells of the score volume."""
    _, fx, fy = scores.shape
    nx, ny = field.shape_unpadded
    dev = scores.device
    valid = ((torch.arange(fx, device=dev) < nx)[:, None]
             & (torch.arange(fy, device=dev) < ny)[None, :])
    flat = torch.where(valid[None], scores, -torch.inf).reshape(-1)
    vals, idx = torch.topk(flat, n)
    yaw_i = idx // (fx * fy)
    rem = idx % (fx * fy)
    cx = rem // fy
    cy = rem % fy
    x = field.origin_xy[0] + cx.to(torch.float32) * f32(field.cell)
    y = field.origin_xy[1] + cy.to(torch.float32) * f32(field.cell)
    return x, y, yaw_i, vals
