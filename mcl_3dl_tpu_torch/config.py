"""Typed configuration (reference layer L5: src/parameters.cpp:52-318).

A copy of the JAX package's ``config.py`` (same dataclasses, names,
defaults and legacy renames), kept here so the port imports nothing of
that package.

Parameter names and defaults match the reference node so existing YAML
profiles (e.g. ``config/test_localization.yaml``) translate 1:1.  Legacy
parameter names handled by the reference's compat shim
(``mcl_3dl_compat/compatibility.h:200-224`` + parameters.cpp:67-83) are
accepted by :func:`Params.from_dict` via the same rename table.

Derived values (``map_grid_min/max`` from the map downsample sizes,
``global_localization_div_yaw`` from the yaw grid, the beam model's
``search_range``) are computed in ``__post_init__`` exactly as
parameters.cpp:91-98,113-116 / lidar_measurement_model_beam.cpp:58-67 do.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional

FLOAT_MAX = 3.4e38


@dataclass
class LikelihoodParams:
    """Likelihood-field model (parameters.cpp:215-245)."""

    num_points: int = 96
    num_points_global: int = 8
    clip_near: float = 0.5
    clip_far: float = 10.0
    clip_z_min: float = -2.0
    clip_z_max: float = 2.0
    match_weight: float = 5.0
    match_dist_min: float = 0.2
    match_dist_flat: float = 0.05
    # distance-field sampling: "nearest" (1 gather/query, the grouped
    # Pallas fast tier, half-cell quantization) or "trilinear"
    # (8 gathers/query, smooth interpolation).  framework addition;
    # global localization always uses nearest.  DEFAULT nearest: the
    # reference's own semantic is an exact (non-interpolated) nearest-
    # neighbor distance (chunked_kdtree.h:217-237), and all three
    # Tier-3 gate variants pass under nearest with the same margins as
    # trilinear (docs/TIER3_GATE.json r5 vs the r4 trilinear run), so
    # the certified config IS the fast config.
    interp: str = "nearest"


@dataclass
class BeamParams:
    """Beam model (parameters.cpp:247-311)."""

    num_points: int = 3
    num_points_global: int = 0
    clip_near: float = 0.5
    clip_far: float = 4.0
    clip_z_min: float = -2.0
    clip_z_max: float = 2.0
    beam_likelihood: float = 0.2      # beam_likelihood_min_
    ang_total_ref: float = math.pi / 6.0
    filter_label_max: int = 0xFFFFFFFF
    add_penalty_short_only_mode: bool = True
    hit_range: float = 0.3
    use_raycast_using_dda: bool = False
    ray_angle_half: float = 0.25 * math.pi / 180.0
    dda_grid_size: float = 0.2
    # static iteration bound for the sphere-tracing raycast march (df
    # mode).  Rays still marching after this many adaptive steps are
    # classified LONG; ~2x the typical step count for clip_far=4 with a
    # 0.6-0.7 m truncated field.  framework addition.
    max_sphere_steps: int = 24


@dataclass
class SamplerWithNormalParams:
    """Importance sampler (parameters.cpp:206-213)."""

    perform_weighting_ratio: float = 2.0
    max_weight_ratio: float = 5.0
    max_weight: float = 5.0
    normal_search_range: float = 0.4


@dataclass
class Params:
    # --- sensor synthesis (parameters.cpp:54-60)
    fake_imu: bool = False
    fake_odom: bool = False

    # --- map processing (parameters.cpp:85-106)
    map_downsample_x: float = 0.1
    map_downsample_y: float = 0.1
    map_downsample_z: float = 0.1
    downsample_x: float = 0.1
    downsample_y: float = 0.1
    downsample_z: float = 0.05
    update_downsample_x: float = 0.3
    update_downsample_y: float = 0.3
    update_downsample_z: float = 0.3
    map_update_interval_interval: float = 2.0
    map_chunk: float = 20.0

    # --- anisotropic match distance (parameters.cpp:108-111)
    dist_weight_x: float = 1.0
    dist_weight_y: float = 1.0
    dist_weight_z: float = 5.0

    # --- global localization (parameters.cpp:113-116)
    global_localization_grid_lin: float = 0.3
    global_localization_grid_ang: float = 0.524

    # --- particle counts (parameters.cpp:118)
    num_particles: int = 64

    # --- resampling / expansion noise (parameters.cpp:120-132)
    resample_var_x: float = 0.05
    resample_var_y: float = 0.05
    resample_var_z: float = 0.05
    resample_var_roll: float = 0.05
    resample_var_pitch: float = 0.05
    resample_var_yaw: float = 0.05
    expansion_var_x: float = 0.2
    expansion_var_y: float = 0.2
    expansion_var_z: float = 0.2
    expansion_var_roll: float = 0.05
    expansion_var_pitch: float = 0.05
    expansion_var_yaw: float = 0.05
    match_ratio_thresh: float = 0.0

    # --- odometry error model (parameters.cpp:134-142)
    odom_err_lin_lin: float = 0.10
    odom_err_lin_ang: float = 0.05
    odom_err_ang_lin: float = 0.05
    odom_err_ang_ang: float = 0.05
    odom_err_integ_lin_tc: float = 10.0
    odom_err_integ_lin_sigma: float = 100.0
    odom_err_integ_ang_tc: float = 10.0
    odom_err_integ_ang_sigma: float = 100.0

    # --- output smoothing / IMU (parameters.cpp:144-147)
    lpf_step: float = 16.0
    acc_lpf_step: float = 128.0
    acc_var: float = math.pi / 4.0

    # --- pose-jump / convergence (parameters.cpp:149-154)
    jump_dist: float = 1.0
    jump_ang: float = 1.57
    fix_dist: float = 0.2
    fix_ang: float = 0.1
    bias_var_dist: float = 2.0
    bias_var_ang: float = 1.57

    # --- scheduling (parameters.cpp:156-166)
    skip_measure: int = 1
    accum_cloud: int = 1
    total_accum_cloud_max: Optional[int] = None  # default accum_cloud * 10
    match_output_interval_interval: float = 0.2
    tf_tolerance: float = 0.05

    # --- debug outputs (parameters.cpp:168-177)
    match_output_dist: float = 0.1
    unmatch_output_dist: float = 0.5
    publish_tf: bool = True
    output_pcd: bool = False
    std_warn_thresh_xy: float = FLOAT_MAX
    std_warn_thresh_z: float = FLOAT_MAX
    std_warn_thresh_yaw: float = FLOAT_MAX

    # --- initial pose (parameters.cpp:181-202)
    init_x: float = 0.0
    init_y: float = 0.0
    init_z: float = 0.0
    init_roll: float = 0.0
    init_pitch: float = 0.0
    init_yaw: float = 0.0
    init_var_x: float = 2.0
    init_var_y: float = 2.0
    init_var_z: float = 0.5
    init_var_roll: float = 0.1
    init_var_pitch: float = 0.1
    init_var_yaw: float = 0.5

    # --- samplers / models (parameters.cpp:204-311)
    use_random_sampler_with_normal: bool = False
    random_sampler_with_normal: SamplerWithNormalParams = field(
        default_factory=SamplerWithNormalParams
    )
    likelihood: LikelihoodParams = field(default_factory=LikelihoodParams)
    beam: BeamParams = field(default_factory=BeamParams)
    use_beam_model: bool = True  # engine-level switch (reference always builds both)

    # --- framework additions (no reference equivalent)
    seed: int = 12345
    # distance-field build: cell size defaults to map_grid_min; margin adds
    # field truncation beyond match_dist_min for trilinear support.
    df_cell_size: Optional[float] = None
    # fleet batch size (leading "robots" axis); 1 keeps reference semantics.
    num_robots: int = 1
    # debug: host-side finiteness assertions on step outputs (the
    # reference's assert(isfinite(...)) guards, src/mcl_3dl.cpp:454-460).
    debug_finite_checks: bool = False

    def __post_init__(self):
        if self.fake_imu and self.fake_odom:
            raise ValueError("One of IMU and Odometry must be enabled")
        if self.total_accum_cloud_max is None:
            self.total_accum_cloud_max = self.accum_cloud * 10
        # parameters.cpp:298-309 — DDA grid must cover the map grid.
        grid_max = max(
            self.map_downsample_x, self.map_downsample_y, self.map_downsample_z
        )
        if self.beam.dda_grid_size < grid_max:
            self.beam = dataclasses.replace(self.beam, dda_grid_size=grid_max)

    # --- derived (parameters.cpp:91-98,113-116)
    @property
    def map_grid_min(self) -> float:
        return min(self.map_downsample_x, self.map_downsample_y, self.map_downsample_z)

    @property
    def map_grid_max(self) -> float:
        return max(self.map_downsample_x, self.map_downsample_y, self.map_downsample_z)

    @property
    def global_localization_div_yaw(self) -> int:
        return round(2.0 * math.pi / self.global_localization_grid_ang)

    @property
    def dist_weight(self):
        return (self.dist_weight_x, self.dist_weight_y, self.dist_weight_z)

    @property
    def beam_search_range(self) -> float:
        """lidar_measurement_model_beam.cpp:60."""
        return self.map_grid_max * 4.0

    @property
    def min_dist_thr_sq(self) -> float:
        """DDA perpendicular-test floor (raycast_using_dda.h:59).
        The reference sums gx^2 + gy^2 + gy^2 — y twice, not z; quirk
        preserved for bit-comparable classification."""
        return (self.map_downsample_x ** 2
                + self.map_downsample_y ** 2
                + self.map_downsample_y ** 2)

    @property
    def initial_pose_mean(self):
        return (self.init_x, self.init_y, self.init_z), (
            self.init_roll,
            self.init_pitch,
            self.init_yaw,
        )

    @property
    def initial_pose_sigma(self):
        return (
            self.init_var_x,
            self.init_var_y,
            self.init_var_z,
            self.init_var_roll,
            self.init_var_pitch,
            self.init_var_yaw,
        )

    # Legacy parameter renames (compatibility.h via parameters.cpp:67-83).
    _LEGACY = {
        "clip_near": "likelihood.clip_near",
        "clip_far": "likelihood.clip_far",
        "clip_z_min": "likelihood.clip_z_min",
        "clip_z_max": "likelihood.clip_z_max",
        "match_dist_min": "likelihood.match_dist_min",
        "match_dist_flat": "likelihood.match_dist_flat",
        "match_weight": "likelihood.match_weight",
        "num_points": "likelihood.num_points",
        "num_points_global": "likelihood.num_points_global",
        "clip_beam_near": "beam.clip_near",
        "clip_beam_far": "beam.clip_far",
        "clip_beam_z_min": "beam.clip_z_min",
        "clip_beam_z_max": "beam.clip_z_max",
        "num_points_beam": "beam.num_points",
        "beam_likelihood": "beam.beam_likelihood",
        "ang_total_ref": "beam.ang_total_ref",
        # this repo's historical alias
        "global_localization_grid": "global_localization_grid_lin",
    }

    @classmethod
    def from_dict(cls, d: dict) -> "Params":
        """Build Params from a (possibly nested, possibly legacy) dict."""
        d = dict(d)
        nested = {
            "likelihood": {},
            "beam": {},
            "random_sampler_with_normal": {},
        }
        flat = {}
        for key, value in d.items():
            target = cls._LEGACY.get(key, key)
            if isinstance(value, dict) and key in nested:
                nested[key].update(value)
            elif "." in target:
                ns, name = target.split(".", 1)
                nested[ns][name] = value
            else:
                flat[target] = value
        kwargs = dict(flat)
        if nested["likelihood"]:
            kwargs["likelihood"] = LikelihoodParams(**nested["likelihood"])
        if nested["beam"]:
            kwargs["beam"] = BeamParams(**nested["beam"])
        if nested["random_sampler_with_normal"]:
            kwargs["random_sampler_with_normal"] = SamplerWithNormalParams(
                **nested["random_sampler_with_normal"]
            )
        return cls(**kwargs)
