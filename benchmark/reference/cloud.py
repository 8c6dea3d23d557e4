"""The scan as the measurement sees it, and the step's random draws.

``to_base`` and ``prepare``: the raw cloud (odometry frame) moved into
the base frame at the odometry pose it was stamped with, then
voxel-downsampled and padded to a power-of-two bucket
(src/mcl_3dl.cpp:304-367).  ``keeps``: each model's
clip of the cloud (likelihood .cpp:84-93, beam .cpp:98-122).

``draws``: the step's draws, made again from the generator state the
program held before the step (an input of the step, as the particles
are).  The uniform point sampler draws one uniform a slot and inverts
the cumulative distribution of the kept points (the inclusive scan in
rows of 1,024, the fixed order that gives the same bits on every run);
then the resampling comb's offset and the jitter, odometry-noise and
expansion normals of every capacity slot, in that order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.field import f32, voxel_downsample

ROW = 1024


def to_base(points_odom, origin_odom, odom_pos, odom_rot):
    """Points and sensor origin [3] from the odometry frame into the base
    frame at the odometry pose ``(pos [3], quat xyzw [4])``."""
    x, y, z, w = np.asarray(odom_rot, np.float64)
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    pos = np.asarray(odom_pos, np.float64)
    pts = (np.asarray(points_odom, np.float64) - pos) @ rot
    org = (np.asarray(origin_odom, np.float64) - pos) @ rot
    return pts.astype(np.float32), org.astype(np.float32)


def bucket(n: int, base: int = 256) -> int:
    c = base
    while c < n:
        c *= 2
    return c


class Cloud(NamedTuple):
    points: torch.Tensor     # [P, 3] f32, padded
    labels: torch.Tensor     # [P] i64 sensor index
    valid: torch.Tensor      # [P] bool
    origins: torch.Tensor    # [S, 3] f32


def prepare(points_base, origin_base, leaf, device) -> Cloud:
    """One sensor's base-frame scan, downsampled and padded."""
    pts = voxel_downsample(points_base, leaf)
    n = pts.shape[0]
    cap = bucket(max(n, 1))
    cloud = np.zeros((cap, 3), np.float32)
    cloud[:n] = pts
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return Cloud(torch.as_tensor(cloud, device=device),
                 torch.zeros(cap, dtype=torch.int64, device=device),
                 torch.as_tensor(valid, device=device),
                 torch.as_tensor(np.asarray(origin_base, np.float32)
                                 .reshape(1, 3), device=device))


def raw(points_base, origin_base, device) -> Cloud:
    """A raw base-frame scan, every point valid (the fleet's input)."""
    p = torch.as_tensor(np.asarray(points_base, np.float32), device=device)
    n = p.shape[0]
    return Cloud(p, torch.zeros(n, dtype=torch.int64, device=device),
                 torch.ones(n, dtype=torch.bool, device=device),
                 torch.as_tensor(np.asarray(origin_base, np.float32)
                                 .reshape(1, 3), device=device))


def clip(points, near, far, z_min, z_max):
    r2 = points[:, 0] ** 2 + points[:, 1] ** 2
    return ((r2 <= f32(far ** 2)) & (r2 >= f32(near ** 2))
            & (points[:, 2] >= f32(z_min)) & (points[:, 2] <= f32(z_max)))


def keeps(cloud: Cloud, like, beam):
    """``(like_keep, beam_keep)``: the valid points inside each clip."""
    return tuple(cloud.valid & clip(cloud.points, m["clip_near"],
                                    m["clip_far"], m["clip_z_min"],
                                    m["clip_z_max"]) for m in (like, beam))


def scan(x):
    """Inclusive sum scan of a 1-D tensor in rows of ``ROW``: each row
    scanned, the row totals scanned likewise, each row offset by the
    total before it (one pass in index order on the host)."""
    if not x.is_cuda:
        return torch.cumsum(x, dim=0)
    n = x.shape[0]
    r = max(-(-n // ROW), 2)
    rows = torch.nn.functional.pad(x, (0, r * ROW - n)).reshape(r, ROW)
    part = torch.cumsum(rows, dim=1)
    if n <= ROW:
        return part[0, :n]
    before = scan(part[:, -1])
    before = torch.cat([before.new_zeros(1), before[:-1]])
    return (part + before[:, None]).reshape(-1)[:n]


def uniform_indices(keep, k, gen):
    p = keep / torch.clamp(torch.sum(keep), min=1)
    cdf = scan(p)
    u = torch.rand((k,), generator=gen, device=keep.device)
    idx = torch.searchsorted(cdf, cdf[-1] * (1.0 - u))
    return torch.clamp(idx, max=keep.shape[0] - 1)


class Draws(NamedTuple):
    like_idx: torch.Tensor
    beam_idx: torch.Tensor
    noise_normals: torch.Tensor   # [cap, 4]


def draws(gen_state, device, like_keep, beam_keep, n_like, n_beam,
          capacity) -> Draws:
    """The step's draws from the generator state before it."""
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    like_idx = uniform_indices(like_keep, n_like, gen)
    beam_idx = uniform_indices(beam_keep, n_beam, gen)
    torch.rand((), generator=gen, device=device)              # comb offset
    torch.randn((capacity, 6), generator=gen, device=device)  # jitter
    noise = torch.randn((capacity, 4), generator=gen, device=device)
    return Draws(like_idx, beam_idx, noise)
