"""Particle state as a struct of arrays.

The reference's ``State6DOF`` (include/mcl_3dl/state_6dof.h:49-275) is a
13-component particle: pos(3), quat(4), odometry error integrals(3+3)
plus 4 per-particle odometry-noise scalars.  Here they are columns of
fixed-capacity tensors with a device scalar ``n_active``, so the active
count can change without reallocating.  ``prob`` and ``prob_bias``
mirror ``pf::Particle`` (pf.h:89-110).

Random draws are inputs: ``init_*`` take their standard normals
``[capacity, 6]`` from the caller.  A state may be one rank's slice of a
particle split: its mask then takes the slice's global ``offset``, and
the weighted moments reduce over every slice through a ``shard.Shard``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mcl_3dl_tpu_torch.math import quat as mq
from mcl_3dl_tpu_torch.shard import offset as _offset


class ParticleState(NamedTuple):
    """All tensors have leading dim = capacity; noise columns are
    (ll, la, al, aa) as in state_6dof.h:55-58."""

    pos: torch.Tensor            # [C, 3] float32
    rot: torch.Tensor            # [C, 4] float32 quaternion (x, y, z, w)
    odom_err_lin: torch.Tensor   # [C, 3] float32
    odom_err_ang: torch.Tensor   # [C, 3] float32
    noise: torch.Tensor          # [C, 4] float32
    prob: torch.Tensor           # [C] float32
    prob_bias: torch.Tensor      # [C] float32
    n_active: torch.Tensor       # [] int32

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self):
        return self.pos.device

    def active_mask(self, offset: int = 0) -> torch.Tensor:
        """Slots below ``n_active``; ``offset`` is the global slot of the
        first row (a slice of a particle split)."""
        return torch.arange(offset, offset + self.capacity, dtype=torch.int32,
                            device=self.device) < self.n_active


def where(pred, a: ParticleState, b: ParticleState) -> ParticleState:
    """Select between two states on a device bool."""
    return ParticleState(*(torch.where(pred, x, y) for x, y in zip(a, b)))


def zeros(capacity: int, n_active=None, device=None) -> ParticleState:
    f = dict(dtype=torch.float32, device=device)
    return ParticleState(
        pos=torch.zeros((capacity, 3), **f),
        rot=mq.identity((capacity,), device=device),
        odom_err_lin=torch.zeros((capacity, 3), **f),
        odom_err_ang=torch.zeros((capacity, 3), **f),
        noise=torch.zeros((capacity, 4), **f),
        prob=torch.zeros((capacity,), **f),
        prob_bias=torch.ones((capacity,), **f),
        n_active=torch.tensor(capacity if n_active is None else n_active,
                              dtype=torch.int32, device=device),
    )


def apply_noise_6dof(state: ParticleState, noise6) -> ParticleState:
    """Compose 6-dof noise samples (dx, dy, dz, droll, dpitch, dyaw) into
    the state (``State6DOF::generateNoise`` + ``operator+``,
    state_6dof.h:226-261): position noise goes to ``pos`` and
    ``odom_err_lin``, rpy noise to ``odom_err_ang`` and, as a world-frame
    quaternion, to ``rot``."""
    dpos = noise6[:, :3]
    drpy = noise6[:, 3:]
    return state._replace(
        pos=state.pos + dpos,
        rot=mq.mul(mq.from_rpy(drpy), state.rot),
        odom_err_lin=state.odom_err_lin + dpos,
        odom_err_ang=state.odom_err_ang + drpy,
    )


def _from_samples(capacity, n_active, mean_pos, mean_rpy, n, device):
    st = zeros(capacity, n_active, device)
    pos_sample = mean_pos + n[:, :3]
    rpy_sample = mean_rpy + n[:, 3:]
    return st._replace(
        pos=pos_sample,
        rot=mq.from_rpy(rpy_sample),
        odom_err_lin=pos_sample,
        odom_err_ang=n[:, 3:],
        prob=st.active_mask() / st.n_active.to(torch.float32),
    )


def init_diagonal(normals6, capacity: int, n_active, mean_pos, mean_rpy,
                  sigma6) -> ParticleState:
    """Per-dimension Gaussian init (``ParticleFilter::init`` via
    ``DiagonalNoiseGenerator``, pf.h:169-181).  ``odom_err_lin`` receives
    the absolute position sample (reference quirk) and ``odom_err_ang``
    the rpy noise."""
    dev = normals6.device
    f = dict(dtype=torch.float32, device=dev)
    n = normals6 * torch.as_tensor(sigma6, **f)
    return _from_samples(capacity, n_active, torch.as_tensor(mean_pos, **f),
                         torch.as_tensor(mean_rpy, **f), n, dev)


def multivariate_transform(cov66) -> torch.Tensor:
    """``V @ sqrt(diag(lambda))`` from a self-adjoint eigendecomposition
    of the f32 covariance (multivariate_noise_generator.h:63-91).
    Eigenvector signs depend on the LAPACK, so only ``T @ T.T`` is
    defined."""
    cov = torch.as_tensor(cov66, dtype=torch.float32, device="cpu")
    w, v = torch.linalg.eigh(cov)
    return v * torch.sqrt(torch.clamp(w, min=0.0))[None, :]


def init_multivariate(normals6, capacity: int, n_active, mean_pos, mean_rpy,
                      cov66) -> ParticleState:
    """Init from a full 6x6 covariance (initialpose seeding)."""
    dev = normals6.device
    f = dict(dtype=torch.float32, device=dev)
    transform = multivariate_transform(cov66).to(dev)
    n = normals6 @ transform.T
    return _from_samples(capacity, n_active, torch.as_tensor(mean_pos, **f),
                         torch.as_tensor(mean_rpy, **f), n, dev)


def weighted_mean(state: ParticleState, weights, shard=None):
    """Quaternion-safe weighted mean -> (mean_pos[3], mean_quat[4]) through
    the averaged front=(1,0,0) and up=(0,0,1) vectors
    (``ParticleWeightedMeanQuat``, state_6dof.h:316-355); with a ``shard``
    the four sums are over every slice."""
    w = weights * state.active_mask(_offset(shard))
    p_sum = torch.sum(w)
    pos_sum = torch.sum(state.pos * w[:, None], dim=0)
    x, y, z, qw = state.rot.unbind(-1)
    front = torch.stack(
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y + qw * z),
         2.0 * (x * z - qw * y)], dim=-1)
    up = torch.stack(
        [2.0 * (x * z + qw * y), 2.0 * (y * z - qw * x),
         1.0 - 2.0 * (x * x + y * y)], dim=-1)
    front_sum = torch.sum(front * w[:, None], dim=0)
    up_sum = torch.sum(up * w[:, None], dim=0)
    if shard is not None:
        p_sum, pos_sum, front_sum, up_sum = shard.sum(p_sum, pos_sum,
                                                      front_sum, up_sum)
    return pos_sum / p_sum, mq.from_frame(front_sum, up_sum)


def wrap_angle(a):
    """Wrap to [-pi, pi] (state_6dof.h:175-179)."""
    return a - 2.0 * math.pi * torch.round(a / (2.0 * math.pi))


def covariance6(state: ParticleState, weights, mean_pos, mean_rot,
                shard=None):
    """Weighted 6x6 covariance over (xyz, rpy) with angle wrapping over
    every particle (pf.h:304-360, state_6dof.h:162-184); with a ``shard``
    over every slice."""
    w = weights * state.active_mask(_offset(shard))
    p_sum = torch.sum(w)
    mean_rpy = mq.to_rpy(mean_rot)
    d_pos = state.pos - mean_pos
    d_rpy = wrap_angle(mq.to_rpy(state.rot) - mean_rpy)
    d = torch.cat([d_pos, d_rpy], dim=-1)                     # [C, 6]
    moment = (d * w[:, None]).T @ d
    if shard is not None:
        p_sum, moment = shard.sum(p_sum, moment)
    return moment / p_sum
