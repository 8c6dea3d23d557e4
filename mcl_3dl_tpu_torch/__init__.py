"""6-DOF Monte Carlo localization in PyTorch with hand-written CUDA
kernels for Hopper: the port of the ``mcl_3dl_tpu`` JAX package.

The engine runs on the CUDA device by default; ``MCL3DL(params,
device="cpu")`` runs every kernel's plain PyTorch version instead.
Every ``Params`` option runs (trilinear sampling, the DDA raycast, the
normal-weighted sampler, ``output_pcd``), as do the single-robot
services: landmark, map update, global localization, the particle-count
services, the inspection calls and ``Diagnostics``.  Checkpoints are
``checkpoint.save_checkpoint`` / ``load_checkpoint``, tracing is
``profiling``.  Nothing here imports JAX or the JAX package.
"""

from mcl_3dl_tpu_torch import checkpoint, profiling
from mcl_3dl_tpu_torch.config import BeamParams, LikelihoodParams, Params
from mcl_3dl_tpu_torch.engine import MCL3DL, StepDraws
from mcl_3dl_tpu_torch.state import ParticleState
from mcl_3dl_tpu_torch.status import (ConvergenceStatus, Diagnostics,
                                      ErrorCode, FilterStatus, MeasureResult,
                                      Status)

__all__ = [
    "MCL3DL", "StepDraws", "Params", "LikelihoodParams", "BeamParams",
    "ParticleState", "MeasureResult", "Status", "FilterStatus", "ErrorCode",
    "ConvergenceStatus", "Diagnostics", "checkpoint", "profiling",
]
