"""6-DOF Monte Carlo localization in PyTorch with hand-written CUDA
kernels for Hopper: the port of the ``mcl_3dl_tpu`` JAX package.

The engine runs on the CUDA device by default; ``MCL3DL(params,
device="cpu")`` runs every kernel's plain PyTorch version instead.
Nothing here imports JAX or the JAX package.
"""

from mcl_3dl_tpu_torch.config import BeamParams, LikelihoodParams, Params
from mcl_3dl_tpu_torch.engine import MCL3DL, StepDraws
from mcl_3dl_tpu_torch.status import (ConvergenceStatus, ErrorCode,
                                      FilterStatus, MeasureResult, Status)

__all__ = [
    "MCL3DL", "StepDraws", "Params", "LikelihoodParams", "BeamParams",
    "MeasureResult", "Status", "FilterStatus", "ErrorCode",
    "ConvergenceStatus",
]
