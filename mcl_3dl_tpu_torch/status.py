"""Engine status reporting (mcl_3dl_msgs/Status equivalent).

Mirrors the fields of the reference's status message
(src/mcl_3dl.cpp:250-254, 895-897, 1146-1147): filter status, error
code, convergence classification, best match ratio, particle-weight
entropy, and particle count.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class FilterStatus:
    NORMAL = 0
    EXPANSION_RESETTING = 1
    GLOBAL_LOCALIZATION = 2


class ErrorCode:
    NORMAL = 0
    POINTS_NOT_FOUND = 1


class ConvergenceStatus:
    NORMAL = 0
    LARGE_STD_VALUE = 1
    CONVERGED = 2


@dataclass
class Status:
    status: int = FilterStatus.NORMAL
    error: int = ErrorCode.NORMAL
    convergence_status: int = ConvergenceStatus.NORMAL
    match_ratio: float = 0.0
    entropy: float = 0.0
    particle_size: int = 0


@dataclass
class Diagnostics:
    """diagnostic_updater equivalent (src/mcl_3dl.cpp:1127-1148)."""

    ok: bool = True
    message: str = "OK"
    map_available: bool = False
    odom_available: bool = False
    imu_available: bool = False


@dataclass
class MeasureResult:
    """Outputs of one measurement update (the amcl_pose + TF publishes)."""

    stamp: object = None            # measurement time = last accumulated
                                    # cloud's stamp (mcl_3dl.cpp:317,712)
    pos: object = None              # np [3] smoothed pose (map frame)
    rot: object = None              # np [4]
    cov: object = None              # np [6, 6]
    map_to_odom_pos: object = None  # np [3] smoothed map->odom TF
    map_to_odom_rot: object = None  # np [4]
    raw_pos: object = None          # np [3] unsmoothed biased mean
    raw_rot: object = None          # np [4]
    match_ratio_min: float = 0.0
    match_ratio_max: float = 0.0
    entropy: float = 0.0
    jumped: bool = False
    expanded: bool = False
    converged: bool = False
    large_std: bool = False
    particle_size: int = 0
    status: Status = field(default_factory=Status)
    beam_status: object = None      # np [B] per-beam status at mean pose
    elapsed: float = 0.0
