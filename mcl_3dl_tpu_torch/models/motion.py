"""Differential-drive motion prediction
(motion_prediction_models/motion_prediction_model_differential_drive.h:
46-67) over the particle axis, with each particle's four noise scalars
(redrawn after every resample, src/mcl_3dl.cpp:817-825)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcl_3dl_tpu_torch.math import quat as mq
from mcl_3dl_tpu_torch.state import ParticleState


class OdomDelta(NamedTuple):
    """Relative odometry motion in the previous odom frame."""

    translation: torch.Tensor        # [3]
    rotation: torch.Tensor           # [4]
    angle: torch.Tensor              # []
    translation_norm: torch.Tensor   # []
    dt: torch.Tensor                 # []

    @classmethod
    def from_poses(cls, pos_prev, rot_prev, pos_cur, rot_cur,
                   dt) -> "OdomDelta":
        """setOdoms (motion_prediction_model_differential_drive.h:46-54),
        in f32 on the host (``predict_graph`` moves it to the device)."""
        f = dict(dtype=torch.float32)
        pos_prev, rot_prev, pos_cur, rot_cur = (
            torch.as_tensor(x, **f)
            for x in (pos_prev, rot_prev, pos_cur, rot_cur))
        inv_prev = mq.inv(rot_prev)
        translation = mq.rotate(inv_prev, pos_cur - pos_prev)
        rotation = mq.mul(inv_prev, rot_cur)
        _, angle = mq.to_axis_angle(rotation)
        return cls(translation=translation, rotation=rotation, angle=angle,
                   translation_norm=torch.linalg.vector_norm(translation),
                   dt=torch.tensor(dt, **f))


def predict_differential_drive(state: ParticleState, delta: OdomDelta,
                               odom_err_integ_lin_tc: float,
                               odom_err_integ_ang_tc: float) -> ParticleState:
    """predict() (motion_prediction_model_differential_drive.h:56-67)."""
    noise_ll = state.noise[:, 0:1]
    noise_la = state.noise[:, 1]
    noise_al = state.noise[:, 2]
    noise_aa = state.noise[:, 3]

    rel_t = delta.translation
    zero = torch.zeros_like(noise_al)
    diff = rel_t * (1.0 + noise_ll) + torch.stack(
        [noise_al * delta.angle, zero, zero], dim=-1)
    odom_err_lin = state.odom_err_lin + (diff - rel_t)
    pos = state.pos + mq.rotate(state.rot, diff)

    yaw_diff = noise_la * delta.translation_norm + noise_aa * delta.angle
    half = yaw_diff * 0.5
    yaw_quat = torch.stack([zero, zero, torch.sin(half), torch.cos(half)],
                           dim=-1)
    rot = mq.normalize(mq.mul(mq.mul(yaw_quat, state.rot), delta.rotation))

    odom_err_ang = state.odom_err_ang.clone()
    odom_err_ang[:, 2] += yaw_diff
    decay_lin = 1.0 - delta.dt / odom_err_integ_lin_tc
    decay_ang = 1.0 - delta.dt / odom_err_integ_ang_tc
    return state._replace(pos=pos, rot=rot,
                          odom_err_lin=odom_err_lin * decay_lin,
                          odom_err_ang=odom_err_ang * decay_ang)


def reset_error_integrals(state: ParticleState) -> ParticleState:
    """Zero the odometry error integrals (src/mcl_3dl.cpp:190-195, 653-658)."""
    return state._replace(odom_err_lin=torch.zeros_like(state.odom_err_lin),
                          odom_err_ang=torch.zeros_like(state.odom_err_ang))
