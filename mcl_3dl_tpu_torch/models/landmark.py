"""Landmark (absolute pose) measurement.

The node's landmark callback (src/mcl_3dl.cpp:899-940): a 6-D Gaussian
over the pose difference ``s - measured`` (State6DOF operator-,
state_6dof.h:262-274: positions subtract, rotations compose as
``measured.rot^-1 * s.rot``), evaluated through ``NormalLikelihoodNd``.
"""

from __future__ import annotations

import torch

from mcl_3dl_tpu_torch.math import quat as mq
from mcl_3dl_tpu_torch.math.nd import NormalLikelihoodNd


def landmark_likelihood(pos, rot, meas_pos, meas_rot,
                        nd: NormalLikelihoodNd):
    """Likelihood [N] of particles ``pos`` [N, 3], ``rot`` [N, 4] under a
    measured pose ``meas_pos`` [3], ``meas_rot`` [4] with the Gaussian
    ``nd`` of its 6x6 covariance."""
    d_rot = mq.mul(mq.inv(meas_rot), rot)
    diff6 = torch.cat([pos - meas_pos, mq.to_rpy(d_rot)], dim=-1)
    return nd(diff6)
