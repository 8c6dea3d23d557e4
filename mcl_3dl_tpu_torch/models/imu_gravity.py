"""IMU gravity posture model (imu_measurement_models/
imu_measurement_model_gravity.h:40-66): a Gaussian over the angle
between the measured acceleration direction and each particle's
body-frame gravity ``rot^-1 * (0, 0, 1)``.  It copies nothing from the
host after its first call on a device (``ez`` is a kept device constant),
so a CUDA graph may hold it."""

from __future__ import annotations

import torch

from mcl_3dl_tpu_torch.math import device_constant
from mcl_3dl_tpu_torch.math import quat as mq
from mcl_3dl_tpu_torch.math.nd import normal_likelihood


def imu_gravity_likelihood(rot, acc_measure, acc_var: float):
    ez = device_constant((0.0, 0.0, 1.0), torch.float32, rot.device)
    acc_estim = mq.rotate(mq.inv(rot), ez)
    acc_norm = torch.linalg.vector_norm(acc_measure)
    estim_norm = torch.linalg.vector_norm(acc_estim, dim=-1)
    cos = torch.sum(acc_estim * acc_measure, dim=-1) / (acc_norm * estim_norm)
    diff = torch.acos(torch.clamp(cos, -1.0, 1.0))
    return normal_likelihood(diff, acc_var)
