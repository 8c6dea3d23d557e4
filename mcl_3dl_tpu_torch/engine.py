"""MCL engine (reference layer L6: src/mcl_3dl.cpp, class MCL3dlNode).

A host shell around one measurement step on the device:

* :meth:`MCL3DL.odometry`   — cbOdom (src/mcl_3dl.cpp:200-247)
* :meth:`MCL3DL.imu`        — cbImu (:941-1018)
* :meth:`MCL3DL.push_cloud` — cbCloud + accumulation (:248-302)
* :meth:`MCL3DL._measurement_step` — measure() (:304-898): scan clip and
  sampling, both LIDAR models, the odometry-error prior, weight update,
  bias, pose expectation, jump detection, TF smoothing, covariance,
  convergence flags, resampling, noise redraw, expansion resetting and
  the global-localization decay.
* services — landmark (:899-940), resize (:1019-1025), expansion reset
  (:1026-1038), global localization (:1039-1099), the one-shot
  correlative search, the map update merge (:1350-1378), and the
  inspection calls: particles, matched/unmatched clouds, beam status,
  diagnostics and the accumulated-scan PCD dump.

The measurement tiers are chosen on the host: the ``fits`` flags of both
models come back in one device-to-host read per step, and ``aux`` reports
``tier_like``/``tier_beam`` with the JAX package's ids (0 grouped
kernel, 1 per-point box kernel, 2 the whole field: kernel M4, or the
sphere trace M2 / the DDA march M3 for the beam; -1 model off).

Every ``Params`` option runs: nearest or trilinear sampling
(``likelihood.interp``; trilinear tracking samples tier 2, global mode
samples nearest), the fixed march or the DDA raycast over the
occupancy grid (``beam.use_raycast_using_dda``, which makes the grouped
beam ineligible), and the uniform or the normal-weighted point sampler
(``use_random_sampler_with_normal``; normals estimated on the host).

Randomness comes from one ``torch.Generator`` on the engine's device,
seeded from ``Params.seed``; every function below the engine takes its
draws as tensors (``StepDraws``), so tests can inject other draws.

Above ``num_particles`` active particles a step runs in global mode: the
likelihood model samples a slot bucket that follows the reference's point
ramp (:func:`global_slots`), the beam model is dropped while its global
budget is 0, and the particle count decays 0.75x a step.  Capacity grows
and shrinks on the host in power-of-two buckets.  Checkpoints are
``checkpoint.py``.

The step is split at the host read of the ``fits`` flags:
``_step_front`` (clip, sampling, the grouping's statistics, boxes and
flags) and ``_step_back`` (the layout, both models, the filter's tail).
``_step`` runs ``_measurement_step`` from CUDA graphs where it can
(``step_graph.py``, the counterpart of the JAX engine's
``jax.jit(self._measurement_step)``): the front replayed every step, the
back from the graph of its ``fits`` outcome where that remainder reads
nothing on the host (tiers 0/0, trilinear sampling, the small counts
without grouping, the DDA beam), else eagerly; on the CPU ``_step`` is
``_measurement_step``.  Every service that replaces the particle state
or the map drops the graphs (``drop_step_graphs``).

Each public call (``push_cloud``, ``odometry``, ``imu``,
``initial_pose``, ``global_localization``) is a request of the program's
tracer, ``profiling.spans``, whose spans split it at the layers'
boundaries (the shell's ``scan.*`` pieces, the step, the host reads
``read.*``).  The global-localization service splits into
``global.standable`` (the standable-cell search on the host) and
``global.seed`` (capacity growth and the seeding, counter
``global.seeds``: the seed count); a global-mode step records its slot
bucket (``global.slots``) and the capacity's cut after the decay is
``capacity.shrink``.

The fleet and the splits over ``torch.distributed`` are ``parallel/``;
the step gains two switches for them.  ``spmd_safe`` (the batched fleet,
``torch.func.vmap`` over the step) reads nothing on the host: the
likelihood samples the whole field (tier 2) without grouping, the beam
marches every ray (kernels M4 and M2 or M3 on the card, their vmap rules
folding the robots into the queries and rays; on the CPU a fixed trip
count).  ``shard`` (the particle split) runs the step
on this rank's slice of the capacity: the models on the slice with the
rank's own tiers, the filter's boundaries (weight normalization, entropy,
moments, covariance, the resampling CDF, the best particle) across every
slice, and ``aux`` reports the worst tier any slice paid.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from mcl_3dl_tpu_torch import pf
from mcl_3dl_tpu_torch import state as st
from mcl_3dl_tpu_torch import step_graph
from mcl_3dl_tpu_torch.cloud_accum import (CloudAccumulation,
                                           CloudAccumulationPassThrough)
from mcl_3dl_tpu_torch.config import Params
from mcl_3dl_tpu_torch.io.pcd import write_pcd
from mcl_3dl_tpu_torch.map import correlative as mc
from mcl_3dl_tpu_torch.map.distance_field import sample_field
from mcl_3dl_tpu_torch.map.map_data import MapData
from mcl_3dl_tpu_torch.map.voxel import voxel_downsample
from mcl_3dl_tpu_torch.math import f32
from mcl_3dl_tpu_torch.math import filters as mf
from mcl_3dl_tpu_torch.math import quat as mq
from mcl_3dl_tpu_torch.math import quat_np as mqn
from mcl_3dl_tpu_torch.math.nd import NormalLikelihoodNd, normal_likelihood
from mcl_3dl_tpu_torch.models.beam import (BeamVirtualPoints, beam_measure,
                                           beam_measure_grouped)
from mcl_3dl_tpu_torch.models.imu_gravity import imu_gravity_likelihood
from mcl_3dl_tpu_torch.models.landmark import landmark_likelihood
from mcl_3dl_tpu_torch.models.likelihood import clip_mask, likelihood_measure
from mcl_3dl_tpu_torch.models.motion import (OdomDelta,
                                             predict_differential_drive,
                                             reset_error_integrals)
from mcl_3dl_tpu_torch.models.samplers import (
    draw_gumbel, draw_uniform_indices, estimate_normals_host,
    normal_weight_direction, sample_uniform,
    sample_weighted_without_replacement, weights_along)
from mcl_3dl_tpu_torch.ops import grouped as og
from mcl_3dl_tpu_torch.profiling import now, spans
from mcl_3dl_tpu_torch.shard import offset as shard_offset
from mcl_3dl_tpu_torch.state import ParticleState
from mcl_3dl_tpu_torch.status import (ConvergenceStatus, Diagnostics,
                                      ErrorCode, FilterStatus, MeasureResult,
                                      Status)

# TF32 would keep ~3 decimal digits in the small f32 transforms
# (einsum/matmul in the models and the per-bin moments): off.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class GroupFront(NamedTuple):
    """The pose-grouped sort up to the step's one host read: ``rmat``,
    the bins' statistics, each eligible model's window origins (``vp``,
    the beam's virtual points) and ``flags`` [1-2] bool (the likelihood's
    ``fits`` where ``share_like``, then the beam's where ``grouped_beam``),
    ``None`` where no model is eligible; ``cap`` the overflow slots."""

    rmat: torch.Tensor
    stats: Optional[og.GroupStats] = None
    lo_like: Optional[torch.Tensor] = None
    lo_beam: Optional[torch.Tensor] = None
    vp: Optional[BeamVirtualPoints] = None
    flags: Optional[torch.Tensor] = None
    share_like: bool = False
    grouped_beam: bool = False
    cap: int = 0

    def fits(self) -> list:
        """The host read of ``flags`` ([] without them)."""
        if self.flags is None:
            return []
        with spans.span("read.fits"):
            return self.flags.tolist()


class StepFront(NamedTuple):
    """``_step_front``'s outputs: the active mask, the sampled points, the
    all-filtered-out flag, the draws (a shard's slice), whether the beam
    model runs, and the grouping (``None`` for ``spmd_safe``)."""

    mask: torch.Tensor
    like_pts: torch.Tensor
    like_valid: torch.Tensor
    beam_pts: torch.Tensor
    beam_labels: torch.Tensor
    beam_valid: torch.Tensor
    points_not_found: torch.Tensor
    draws: "StepDraws"
    use_beam: bool
    group: Optional[GroupFront]

    def fits(self) -> list:
        """The host read of the grouping's flags ([] without them)."""
        return [] if self.group is None else self.group.fits()


class StepDraws(NamedTuple):
    """Random draws of one measurement step.  The uniform sampler reads
    the indices, the normal-weighted sampler the Gumbel draws (one a
    cloud slot); the other pair is ``None``."""

    like_idx: Optional[torch.Tensor]  # [K_like] i64 sampled cloud indices
    beam_idx: Optional[torch.Tensor]  # [K_beam] i64
    u0: torch.Tensor                # [] f32 resampling comb offset in [0, 1)
    resample_normals: torch.Tensor  # [cap, 6] f32
    noise_normals: torch.Tensor     # [cap, 4] f32
    expand_normals: torch.Tensor    # [cap, 6] f32
    like_gumbel: Optional[torch.Tensor] = None   # [P] f32
    beam_gumbel: Optional[torch.Tensor] = None   # [P] f32


def _bucket(n: int, base: int = 64) -> int:
    """Round up to a power-of-two capacity bucket."""
    c = max(base, 1)
    while c < n:
        c *= 2
    return c


def global_slots(params: Params, n_active: int) -> int:
    """Likelihood slot bucket of a global-mode step at ``n_active``
    particles: the reference's point ramp (``num_points * num_particles /
    n``, floored at ``num_points_global``;
    lidar_measurement_model_likelihood.cpp:63-77) rounded up to a power of
    two times the floor and capped at the full budget, the JAX engine's
    choice of graph one for one."""
    lp = params.likelihood
    ramp = max(lp.num_points * params.num_particles // max(n_active, 1),
               lp.num_points_global)
    k = max(lp.num_points_global, 1)
    while k < min(ramp, lp.num_points):
        k *= 2
    return min(k, lp.num_points)


_HOST_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
                torch.int32: np.int32, torch.int64: np.int64,
                torch.bool: np.bool_}


def to_host(aux: dict) -> dict:
    """Host copies of a step's ``aux``: every tensor comes over in one
    device-to-host transfer (packed as float64, which holds each float32,
    bool and int32 value exactly); other values pass through."""
    keys = [k for k, v in aux.items() if isinstance(v, torch.Tensor)]
    if not keys:
        return dict(aux)
    flat = torch.cat([aux[k].reshape(-1).to(torch.float64) for k in keys])
    flat = flat.cpu().numpy()
    out, off = dict(aux), 0
    for k in keys:
        v = aux[k]
        out[k] = flat[off:off + v.numel()].reshape(tuple(v.shape)).astype(
            _HOST_DTYPES[v.dtype])
        off += v.numel()
    return out


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for another device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions")
        device = "cuda"
    return torch.device(device)


def beam_num_steps(params: Params) -> int:
    """Fixed-march probe count of the grouped beam (covers the longest
    clipped ray plus a 1 m sensor-origin margin)."""
    bp = params.beam
    z_ext = max(abs(bp.clip_z_min), abs(bp.clip_z_max))
    return int(math.ceil((math.hypot(bp.clip_far, z_ext) + bp.hit_range + 1.0)
                         / params.map_grid_min)) + 2


def dda_num_steps(params: Params) -> int:
    """Probe bound of the DDA march: half-cell probes over ``clip_far +
    hit_range``."""
    bp = params.beam
    return int(math.ceil((bp.clip_far + bp.hit_range)
                         / (bp.dda_grid_size * 0.5))) + 2


def sphere_num_steps(params: Params) -> int:
    """Probe bound of the tier-2 sphere trace: ``max_sphere_steps``, at
    most the fixed-step probes over ``clip_far + hit_range``."""
    bp = params.beam
    return min(bp.max_sphere_steps,
               int(math.ceil((bp.clip_far + bp.hit_range)
                             / params.map_grid_min)) + 2)


class MCL3DL:
    """6-DOF Monte Carlo localizer on one CUDA device."""

    def __init__(self, params: Optional[Params] = None,
                 capacity: Optional[int] = None, device=None):
        self.params = params or Params()
        p = self.params
        self.device = resolve_device(device)
        dev = self.device
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(p.seed)
        self._base_capacity = _bucket(p.num_particles)
        cap = capacity or self._base_capacity

        mean_pos, mean_rpy = p.initial_pose_mean
        self.pstate = st.init_diagonal(
            self._normals(cap, 6), cap, p.num_particles, mean_pos, mean_rpy,
            p.initial_pose_sigma)

        self.f_pos = mf.lpf_init(p.lpf_step, torch.zeros(3), device=dev)
        self.f_ang = mf.lpf_init(p.lpf_step, torch.zeros(3), angle=True,
                                 device=dev)
        # host-side scalar filters
        self.f_acc = mf.lpf_init(p.acc_lpf_step, torch.zeros(3))
        self.localize_rate = mf.lpf_init(5.0, 0.0)

        if p.accum_cloud == 0:
            self.accum = CloudAccumulationPassThrough()
        else:
            self.accum = CloudAccumulation(p.accum_cloud, p.total_accum_cloud_max)

        self.map: Optional[MapData] = None
        self.has_map = False
        self.has_odom = False
        self.has_imu = False
        self.odom_pos = np.zeros(3, np.float32)
        self.odom_rot = np.array([0, 0, 0, 1], np.float32)
        self.odom_prev_pos = np.zeros(3, np.float32)
        self.odom_prev_rot = np.array([0, 0, 0, 1], np.float32)
        self.odom_last = 0.0
        self.imu_last = 0.0
        self.imu_quat = np.array([0, 0, 0, 1], np.float32)

        f = dict(dtype=torch.float32, device=dev)
        self.state_prev_pos = torch.tensor(mean_pos, **f)
        self.state_prev_rot = mq.from_rpy(torch.tensor(mean_rpy, **f))
        self._tf_seeded = False

        self.tf_tolerance_base = 0.0
        self.localized_last = 0.0
        self.global_localization_fix_cnt = 0
        self.cnt_measure = 0
        self.match_output_last = -1e18
        # the matched/unmatched debug clouds (pub_matched_/pub_unmatched_,
        # src/mcl_3dl.cpp:762-805): a callback (t, matched [M, 3],
        # unmatched [U, 3], both in the map frame), called at most every
        # match_output_interval_interval seconds; None skips them
        self.on_match_clouds = None
        self.status = Status()
        self.entropy = 0.0

        self._accum_points: list = []
        self._accum_origins: list = []
        self._accum_odom: list = []
        self._accum_stamps: list = []
        self._last_scan_base: Optional[np.ndarray] = None
        self._pc_all_accum: list = []       # output_pcd: scans in the map frame
        self._n_active_host = p.num_particles
        self.last_aux: Optional[dict] = None     # host copy of the last step's aux
        self._resample_sigma = torch.tensor(
            [p.resample_var_x, p.resample_var_y, p.resample_var_z,
             p.resample_var_roll, p.resample_var_pitch, p.resample_var_yaw], **f)
        self._expansion_sigma = torch.tensor(
            [p.expansion_var_x, p.expansion_var_y, p.expansion_var_z,
             p.expansion_var_roll, p.expansion_var_pitch, p.expansion_var_yaw],
            **f)
        self._odom_noise_scale = torch.tensor(
            [p.odom_err_lin_lin, p.odom_err_lin_ang, p.odom_err_ang_lin,
             p.odom_err_ang_ang], **f)
        # ``_step``'s CUDA graphs by key (``step_graph.step_key``), and how
        # many steps took each route (``step_graph.ROUTES``)
        self._graphs: dict = {}
        self.step_routes = dict.fromkeys(step_graph.ROUTES, 0)

    def drop_step_graphs(self) -> None:
        """Forget ``_step``'s graphs (the next step at a key warms it up
        again), as the JAX engine re-creates its jitted step: every service
        that replaces the particle state or the map calls this."""
        if self._graphs:
            spans.count("graph.drops")
        self._graphs.clear()

    # ------------------------------------------------------------ randomness

    def _normals(self, n: int, d: int) -> torch.Tensor:
        return torch.randn((n, d), generator=self._gen, device=self.device)

    def draw_step(self, like_keep, beam_keep, like_slots=None,
                  beam_slots=None, *, gen=None, capacity=None) -> StepDraws:
        """This step's draws from ``gen`` (default the engine's generator)
        for ``capacity`` particles (default the engine's); the sample sizes
        default to the full budgets."""
        p = self.params
        gen = self._gen if gen is None else gen
        dev = self.device
        cap = self.pstate.capacity if capacity is None else capacity
        if p.use_random_sampler_with_normal:
            n = like_keep.shape[0]
            sample = dict(like_idx=None, beam_idx=None,
                          like_gumbel=draw_gumbel(n, gen, dev),
                          beam_gumbel=draw_gumbel(n, gen, dev))
        else:
            sample = dict(
                like_idx=draw_uniform_indices(
                    like_keep, like_slots or p.likelihood.num_points, gen),
                beam_idx=draw_uniform_indices(
                    beam_keep, beam_slots or p.beam.num_points, gen))

        def normals(d):
            return torch.randn((cap, d), generator=gen, device=dev)

        return StepDraws(
            u0=torch.rand((), generator=gen, device=dev),
            resample_normals=normals(6), noise_normals=normals(4),
            expand_normals=normals(6), **sample)

    # -------------------------------------------------------------- capacity

    def _grow_capacity(self, n: int) -> None:
        """Grow the particle tensors to a bucket >= n; the new slots are
        inactive (identity ``rot``, ``prob_bias`` 1, zeros elsewhere)."""
        s = self.pstate
        new_cap = _bucket(n, self._base_capacity)
        if new_cap <= s.capacity:
            return
        pad = st.zeros(new_cap - s.capacity, device=self.device)
        self.pstate = ParticleState(
            *(torch.cat([a, b]) for a, b in zip(s[:-1], pad[:-1])),
            n_active=s.n_active)

    def _maybe_shrink_capacity(self, n: int) -> None:
        """Cut the tensors back to the bucket of ``n`` active particles
        once the count has decayed (span ``capacity.shrink`` where it
        cuts)."""
        target = _bucket(n, self._base_capacity)
        s = self.pstate
        if s.capacity > target:
            with spans.span("capacity.shrink"):
                self.pstate = ParticleState(*(a[:target] for a in s[:-1]),
                                            n_active=s.n_active)

    # ---------------------------------------------------------------- map I/O

    def load_map(self, points: np.ndarray, labels: Optional[np.ndarray] = None):
        """cbMapcloud / loadMapCloud (src/mcl_3dl.cpp:127-140, 1150-1170)."""
        self.drop_step_graphs()
        self.map = MapData.build(points, self.params, labels, device=self.device)
        self.has_map = True
        self._accum_clear()
        self.accum.reset()
        return self.map

    def update_map(self, points: np.ndarray, labels: Optional[np.ndarray] = None):
        """cbMapcloudUpdate + the merge timer (src/mcl_3dl.cpp:141-153,
        1350-1369): the update cloud, downsampled at the update leaf size,
        merged into the map, whose every index (``df``, ``df_beam``, the
        corner pack, ``occ``) is built anew; nothing sized at the old map
        is kept."""
        if self.map is None:
            return None
        self.drop_step_graphs()
        p = self.params
        pts = np.asarray(points, np.float64).reshape(-1, 3)
        if labels is None:
            labels = np.zeros((pts.shape[0],), np.uint32)
        pts, attrs = voxel_downsample(
            pts, (p.update_downsample_x, p.update_downsample_y,
                  p.update_downsample_z),
            attrs=np.asarray(labels, np.float64)[:, None])
        self.map = self.map.merged_with(
            pts, np.round(attrs[:, 0]).astype(np.uint32))
        return self.map

    # ------------------------------------------------------------- pose seed

    def initial_pose(self, pos, rot, cov66) -> None:
        """initialpose re-seed (cbPosition, src/mcl_3dl.cpp:155-198)."""
        with spans.request("initial_pose"):
            rot = np.asarray(rot, np.float64)
            if abs(float(np.sum(rot * rot)) - 1.0) > 0.1:
                raise ValueError(
                    "initialpose orientation must be a unit quaternion")
            rpy = mqn.to_rpy(rot)
            self.drop_step_graphs()
            cap = self.pstate.capacity
            self.pstate = st.init_multivariate(
                self._normals(cap, 6), cap, self.params.num_particles,
                np.asarray(pos, np.float32), np.asarray(rpy, np.float32), cov66)
            self.pstate = reset_error_integrals(self.pstate)
            self._n_active_host = self.params.num_particles
            # state_prev_ stays: the next measurement sees the re-seed as a
            # pose jump and resets the TF smoothers (:155-198)
            self._maybe_shrink_capacity(self._n_active_host)

    # ------------------------------------------------------------ odom / imu

    def odometry(self, pos, rot, t: float) -> None:
        """cbOdom (src/mcl_3dl.cpp:200-247)."""
        with spans.request("odometry"):
            self._odometry(pos, rot, t)

    def _odometry(self, pos, rot, t: float) -> None:
        pos = np.asarray(pos, np.float32)
        rot = np.asarray(rot, np.float32)
        self.odom_pos, self.odom_rot = pos, rot
        if not self.has_odom:
            self.odom_prev_pos, self.odom_prev_rot = pos, rot
            self.odom_last = t
            self.has_odom = True
            return
        dt = t - self.odom_last
        if dt < 0.0 or dt > 5.0:
            self.has_odom = False
            return
        if dt > 0.05:
            p = self.params
            with spans.span("odometry.predict"):
                delta = OdomDelta.from_poses(
                    self.odom_prev_pos, self.odom_prev_rot, pos, rot, dt,
                    device=self.device)
                self.pstate = predict_differential_drive(
                    self.pstate, delta, p.odom_err_integ_lin_tc,
                    p.odom_err_integ_ang_tc)
            self.odom_last = t
            self.odom_prev_pos, self.odom_prev_rot = pos, rot
        if self.params.fake_imu:
            accel = mqn.rotate(rot, np.array([0.0, 0.0, 1.0], np.float32))
            self.imu(accel, rot, t)

    def imu(self, acc, orientation, t: float) -> None:
        """cbImu (src/mcl_3dl.cpp:941-1018); ``acc`` and ``orientation`` in
        the base_link frame."""
        with spans.request("imu"):
            self._imu(acc, orientation, t)

    def _imu(self, acc, orientation, t: float) -> None:
        self.f_acc, acc_f = mf.filter_step(
            self.f_acc, torch.as_tensor(acc, dtype=torch.float32))
        if not self.has_imu:
            self.f_acc = mf.filter_set(self.f_acc, torch.zeros(3))
            self.imu_last = t
            self.has_imu = True
            return
        dt = t - self.imu_last
        if dt < 0.0 or dt > 5.0:
            self.has_imu = False
            return
        if dt > 0.05:
            with spans.span("imu.weigh"):
                acc_measure = (acc_f / torch.linalg.vector_norm(acc_f)).to(
                    self.device)
                self.imu_quat = np.asarray(orientation, np.float32)
                lik = imu_gravity_likelihood(self.pstate.rot, acc_measure,
                                             self.params.acc_var)
                self.pstate, _ = pf.measure(self.pstate, lik)
            self.imu_last = t
            if self.params.fake_odom:
                self.odometry(np.zeros(3, np.float32), self.imu_quat, t)

    # ----------------------------------------------------------- scan intake

    def _accum_clear(self) -> None:
        self._accum_points = []
        self._accum_origins = []
        self._accum_odom = []
        self._accum_stamps = []

    def push_cloud(self, frame_id: str, points_odom: np.ndarray,
                   sensor_origin_odom: np.ndarray,
                   t: float) -> Optional[MeasureResult]:
        """cbCloud (src/mcl_3dl.cpp:248-302): points already in the odom
        frame; returns a MeasureResult when this cloud triggered a
        measurement."""
        with spans.request("push_cloud"):
            return self._push_cloud(frame_id, points_odom, sensor_origin_odom,
                                    t)

    def _push_cloud(self, frame_id, points_odom, sensor_origin_odom, t):
        if not self.has_map or not self.has_odom:
            return None
        self.status = Status(status=FilterStatus.NORMAL, error=ErrorCode.NORMAL,
                             convergence_status=ConvergenceStatus.NORMAL)
        result: list = [None]

        def process():
            result[0] = self._measure(t)

        def accumulate(msg):
            with spans.span("scan.accumulate"):
                pts, origin = msg
                self._accum_points.append(
                    np.asarray(pts, np.float64).reshape(-1, 3))
                self._accum_origins.append(
                    np.asarray(origin, np.float64).reshape(3))
                self._accum_odom.append((self.odom_pos.copy(),
                                         self.odom_rot.copy()))
                self._accum_stamps.append(t)
            return True

        self.accum.push(frame_id, (points_odom, sensor_origin_odom), process,
                        accumulate, self._accum_clear)
        return result[0]

    def measure_direct(self, points_base, origins_base, labels, t: float):
        """Measure a base_link-frame cloud directly (test API)."""
        return self._measure_base(points_base, labels, origins_base, t)

    def _measure(self, t: float) -> Optional[MeasureResult]:
        """measure() preamble (src/mcl_3dl.cpp:304-360): odom -> base_link
        at the last accumulated cloud's stamp, then the device step."""
        if not self._accum_points:
            self.status.error = ErrorCode.POINTS_NOT_FOUND
            return None
        with spans.span("scan.transform"):
            odom_pos, odom_rot = self._accum_odom[-1]
            inv_rot = mqn.inv(odom_rot)
            pts = np.concatenate(self._accum_points, axis=0)
            labels = np.concatenate([np.full((len(p),), i, np.int32)
                                     for i, p in enumerate(self._accum_points)])
            pts_base = mqn.rotate(inv_rot, pts - odom_pos).astype(np.float32)
            origins = np.stack(self._accum_origins, axis=0)
            origins_base = mqn.rotate(inv_rot, origins - odom_pos).astype(np.float32)
        return self._measure_base(pts_base, labels, origins_base,
                                  self._accum_stamps[-1],
                                  odom=(odom_pos, odom_rot))

    # ------------------------------------------------------- measurement step

    def prepare_cloud(self, pts_base, labels, origins_base):
        """VoxelGrid downsample (src/mcl_3dl.cpp:363-367) and padding to a
        power-of-two bucket: ``(pts_ds, (cloud, cloud_label, cloud_valid,
        origins))`` with the tensors on the engine's device."""
        p = self.params
        pts_ds, attrs = voxel_downsample(
            pts_base, (p.downsample_x, p.downsample_y, p.downsample_z),
            attrs=np.asarray(labels, np.float64)[:, None])
        lbl_ds = np.round(attrs[:, 0]).astype(np.int64)
        n_pts = pts_ds.shape[0]
        bucket = _bucket(max(n_pts, 1), 256)
        cloud = np.zeros((bucket, 3), np.float32)
        cloud[:n_pts] = pts_ds
        cloud_label = np.zeros((bucket,), np.int64)
        cloud_label[:n_pts] = np.clip(lbl_ds, 0, max(len(origins_base) - 1, 0))
        cloud_valid = np.zeros((bucket,), bool)
        cloud_valid[:n_pts] = True
        origins = np.zeros((max(len(origins_base), 1), 3), np.float32)
        if len(origins_base):
            origins[: len(origins_base)] = origins_base
        return pts_ds, tuple(torch.as_tensor(a).to(self.device)
                             for a in (cloud, cloud_label, cloud_valid, origins))

    def scan_normals(self, pts_ds, bucket: int) -> Optional[torch.Tensor]:
        """Surface normals of the downsampled scan, padded to the cloud's
        bucket and on the engine's device (``estimate_normals_host``), or
        ``None`` when the normal-weighted sampler is off."""
        p = self.params
        if not p.use_random_sampler_with_normal:
            return None
        normals = np.zeros((bucket, 3), np.float32)
        normals[:len(pts_ds)] = estimate_normals_host(
            pts_ds, p.random_sampler_with_normal.normal_search_range)
        return torch.as_tensor(normals).to(self.device)

    def _measure_base(self, pts_base, labels, origins_base, t,
                      odom=None) -> Optional[MeasureResult]:
        self.cnt_measure += 1
        if self.cnt_measure % max(int(self.params.skip_measure), 1) != 0:
            return None
        with spans.span("scan"):
            t0 = now()
            with spans.span("scan.prepare"):
                args = self._step_inputs(pts_base, labels, origins_base, odom)
            (self.pstate, self.f_pos, self.f_ang, self.state_prev_pos,
             self.state_prev_rot, aux) = self._step(*args[0], **args[1])
            with spans.span("read.aux"):
                aux = to_host(aux)
            with spans.span("scan.publish"):
                return self._publish(aux, t, t0)

    def _step_inputs(self, pts_base, labels, origins_base, odom):
        """``_step``'s positional and keyword arguments for a base-frame
        cloud: the downsampled, padded cloud and the odometry on the
        device, the filters, and the graph selection."""
        p = self.params
        dev = self.device
        self._last_scan_base, cloud = self.prepare_cloud(pts_base, labels,
                                                         origins_base)
        pts_ds = self._last_scan_base
        normals = self.scan_normals(pts_ds, cloud[0].shape[0])

        op = odom[0] if odom is not None else self.odom_pos
        orot = odom[1] if odom is not None else self.odom_rot
        if not self._tf_seeded:
            # seed the TF smoothers with the current map->odom at the first
            # measurement (the configure-time identity seed only holds when
            # odometry starts near identity)
            pp = self.state_prev_pos.cpu().numpy().astype(np.float64)
            pr = self.state_prev_rot.cpu().numpy().astype(np.float64)
            mrot = mqn.mul(pr, mqn.inv(np.asarray(orot, np.float64)))
            mpos = pp - mqn.rotate(mrot, np.asarray(op, np.float64))
            self.f_ang = mf.filter_set(self.f_ang, np.float32(mqn.to_rpy(mrot)))
            self.f_pos = mf.filter_set(self.f_pos, np.float32(mpos))
            self._tf_seeded = True

        def put(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

        # graph selection (setGlobalLocalizationStatus on the host): above
        # num_particles a global-mode step runs, its likelihood slots
        # bucketed along the reference's ramp and the beam dropped
        global_mode = self._n_active_host > p.num_particles
        return ((self.pstate, self.map.df, self.map.df_beam, *cloud,
                 put(op), put(orot),
                 self.state_prev_pos, self.state_prev_rot, self.f_pos,
                 self.f_ang, self.global_localization_fix_cnt > 0,
                 (p.std_warn_thresh_xy, p.std_warn_thresh_z,
                  p.std_warn_thresh_yaw)),
                dict(global_mode=global_mode,
                     global_slots=(global_slots(p, self._n_active_host)
                                   if global_mode else None),
                     occ=self.map.occ, normals=normals))

    def _publish(self, aux, t, t0) -> MeasureResult:
        """The epilogue on the step's host ``aux`` (src/mcl_3dl.cpp:
        853-897): status, rates, the published result, whose ``elapsed``
        is the time since ``t0`` (the tracer's clock ``now``, ns), the
        measurement's start."""
        p = self.params
        pts_ds = self._last_scan_base
        self.last_aux = aux

        if p.debug_finite_checks:
            for name in ("e_pos", "e_rot", "pub_pos", "pub_rot", "cov"):
                if not np.isfinite(aux[name]).all():
                    raise FloatingPointError(
                        f"non-finite {name} in measurement step: {aux[name]}")
        if aux["points_not_found"]:
            self.status.error = ErrorCode.POINTS_NOT_FOUND
            return MeasureResult(status=self.status,
                                 elapsed=(now() - t0) * 1e-9)

        # host-side epilogue (src/mcl_3dl.cpp:853-897)
        if aux["expanded"]:
            self.status.status = FilterStatus.EXPANSION_RESETTING
        dt = min(max(t - self.localized_last, 0.0), 1.0)
        self.localize_rate, tol = mf.filter_step(self.localize_rate, dt)
        self.tf_tolerance_base = float(tol)
        self.localized_last = t
        n_active = int(aux["n_active"])
        if aux["did_resize"]:
            # wait 99.7% fix: three sigma (src/mcl_3dl.cpp:886-887)
            self.global_localization_fix_cnt = 1 + int(math.ceil(p.lpf_step)) * 3
            self._maybe_shrink_capacity(n_active)
        if self.global_localization_fix_cnt:
            self.global_localization_fix_cnt -= 1
            self.status.status = FilterStatus.GLOBAL_LOCALIZATION
        if aux["large_std"]:
            self.status.convergence_status = ConvergenceStatus.LARGE_STD_VALUE
        elif aux["converged"]:
            self.status.convergence_status = ConvergenceStatus.CONVERGED
        self.entropy = float(aux["entropy"])
        self.status.match_ratio = float(aux["match_ratio_max"])
        self.status.particle_size = n_active
        self._n_active_host = n_active
        self.status.entropy = self.entropy

        if p.output_pcd:
            moved = mq.rotate(torch.as_tensor(aux["pub_rot"]),
                              torch.as_tensor(pts_ds, dtype=torch.float32))
            self._pc_all_accum.append(
                (moved + torch.as_tensor(aux["pub_pos"])).numpy())
        # interval-throttled matched/unmatched clouds (src/mcl_3dl.cpp:
        # 762-805): at most every match_output_interval_interval seconds,
        # re-armed by a backward time jump (stamp + 1 s < last)
        if self.on_match_clouds is not None and (
                t > self.match_output_last + p.match_output_interval_interval
                or t + 1.0 < self.match_output_last):
            self.match_output_last = t
            matched, unmatched = self.classify_cloud(pts_ds, aux["e_pos"],
                                                     aux["e_rot"])
            pts_map = mqn.rotate(np.asarray(aux["e_rot"]),
                                 np.asarray(pts_ds, np.float64)) + aux["e_pos"]
            self.on_match_clouds(t, pts_map[matched], pts_map[unmatched])
        return MeasureResult(
            stamp=t, pos=aux["pub_pos"], rot=aux["pub_rot"], cov=aux["cov"],
            map_to_odom_pos=aux["map_to_odom_pos"],
            map_to_odom_rot=aux["map_to_odom_rot"],
            raw_pos=aux["e_pos"], raw_rot=aux["e_rot"],
            match_ratio_min=float(aux["match_ratio_min"]),
            match_ratio_max=float(aux["match_ratio_max"]),
            entropy=self.entropy, jumped=bool(aux["jumped"]),
            expanded=bool(aux["expanded"]), converged=bool(aux["converged"]),
            large_std=bool(aux["large_std"]),
            particle_size=n_active, status=self.status,
            elapsed=(now() - t0) * 1e-9)

    def slots(self, global_mode: bool = False, global_slots=None):
        """``(like_slots, beam_slots, use_beam)`` of a step: the full
        budgets, or in global mode ``global_slots`` (default the floor
        ``num_points_global``) and the beam's global budget, which drops
        the beam model when it is 0 (one slot keeps the shapes)."""
        p = self.params
        lp, bp = p.likelihood, p.beam
        if not global_mode:
            return lp.num_points, bp.num_points, p.use_beam_model
        beam_slots = bp.num_points_global
        return (global_slots or lp.num_points_global, max(beam_slots, 1),
                p.use_beam_model and beam_slots > 0)

    def keeps(self, cloud, cloud_valid):
        """``(like_keep, beam_keep)``: the cloud slots inside each model's
        clip range (likelihood .cpp:79-103 / beam :98-122)."""
        lp, bp = self.params.likelihood, self.params.beam
        return (cloud_valid & clip_mask(cloud, lp.clip_near, lp.clip_far,
                                        lp.clip_z_min, lp.clip_z_max),
                cloud_valid & clip_mask(cloud, bp.clip_near, bp.clip_far,
                                        bp.clip_z_min, bp.clip_z_max))

    def sample_points(self, cloud, cloud_label, cloud_valid,
                      draws: Optional[StepDraws] = None, *,
                      global_mode: bool = False, global_slots=None,
                      n_active=None, state: Optional[ParticleState] = None,
                      normals=None, shard=None):
        """Clip and sample (likelihood .cpp:79-103 / beam :98-122):
        ``(like_pts, like_valid, beam_pts, beam_labels, beam_valid,
        points_not_found, draws)``.  In global mode the valid slots follow
        the reference's point ramp at ``n_active`` (a device scalar),
        clipped to the slot bucket.  The normal-weighted sampler reads the
        scan's ``normals`` [P, 3] and the particle ``state`` before the
        step (its mean and covariance, setParticleStatistics,
        src/mcl_3dl.cpp:369-375), over every slice with a ``shard``."""
        p = self.params
        lp, bp = p.likelihood, p.beam
        like_slots, beam_slots, use_beam = self.slots(global_mode,
                                                      global_slots)
        like_keep, beam_keep = self.keeps(cloud, cloud_valid)
        if draws is None:
            draws = self.draw_step(like_keep, beam_keep, like_slots,
                                   beam_slots)
        if p.use_random_sampler_with_normal:
            sw = p.random_sampler_with_normal
            mean_pos, mean_rot = pf.expectation(state, shard=shard)
            cov = st.covariance6(state, state.prob, mean_pos, mean_rot,
                                 shard)
            direction, amp = normal_weight_direction(
                cov[:3, :3], mean_rot, sw.perform_weighting_ratio,
                sw.max_weight_ratio, sw.max_weight)
            like_pts, like_valid, _ = sample_weighted_without_replacement(
                cloud, weights_along(normals, like_keep, direction, amp),
                like_slots, draws.like_gumbel)
            beam_pts, beam_valid, beam_idx = \
                sample_weighted_without_replacement(
                    cloud, weights_along(normals, beam_keep, direction, amp),
                    beam_slots, draws.beam_gumbel)
        else:
            like_pts, like_valid, _ = sample_uniform(cloud, like_keep,
                                                     draws.like_idx)
            beam_pts, beam_valid, beam_idx = sample_uniform(cloud, beam_keep,
                                                            draws.beam_idx)
        if global_mode:
            # the point-count shrink (setGlobalLocalizationStatus,
            # lidar_measurement_model_likelihood.cpp:63-77) from the full
            # budgets, clipped to the slots
            def active_points(default, global_min, slots):
                num = default * p.num_particles // torch.clamp(n_active, min=1)
                num = torch.clamp(num, min=global_min)
                num = torch.where(n_active <= p.num_particles, default, num)
                return torch.arange(slots, device=cloud.device) < torch.clamp(
                    num, max=slots)

            like_valid = like_valid & active_points(
                lp.num_points, lp.num_points_global, like_slots)
            beam_valid = beam_valid & active_points(
                bp.num_points, bp.num_points_global, beam_slots)
        if not use_beam:
            beam_valid = torch.zeros_like(beam_valid)
        return (like_pts, like_valid, beam_pts, cloud_label[beam_idx],
                beam_valid, torch.sum(like_keep) == 0, draws)

    def group(self, pos, rot, mask, df, df_beam, like_pts, like_valid,
              beam_pts, beam_labels, beam_valid, origins, use_beam=None):
        """The pose-grouped sort both models share (df and df_beam live on
        one grid): ``(rmat, grouped_like, grouped_beam)`` with
        ``grouped_like = (stats, layout, lo, fits)`` and ``grouped_beam =
        (stats, layout, lo, fits, vp)``, or ``None`` where a model is not
        eligible.  Each model keeps its own boxes and ``fits`` flag; both
        flags come to the host in one transfer, and the layout is built
        only if one of them fits.  ``use_beam`` overrides
        ``params.use_beam_model`` (global mode drops the beam).  Trilinear
        sampling makes the likelihood ineligible, the DDA raycast the
        beam (as in the JAX engine).  ``group_front`` and ``group_layout``
        are its two halves, before and after the host read."""
        front = self.group_front(pos, rot, mask, df, df_beam, like_pts,
                                 like_valid, beam_pts, beam_labels,
                                 beam_valid, origins, use_beam)
        return self.group_layout(front, front.fits())

    def group_front(self, pos, rot, mask, df, df_beam, like_pts, like_valid,
                    beam_pts, beam_labels, beam_valid, origins,
                    use_beam=None) -> GroupFront:
        """``group`` up to its host read: the statistics, the boxes and the
        ``fits`` flags as one device tensor (``GroupFront``)."""
        p = self.params
        use_beam = p.use_beam_model if use_beam is None else use_beam
        n_cap = pos.shape[0]
        rmat = mq.rotation_matrix(mq.normalize(rot))
        steps_g = beam_num_steps(p)
        use_grouped_beam = (use_beam and not p.beam.use_raycast_using_dda
                            and n_cap % og.TILE == 0 and steps_g + 1 <= 64)
        share_like = (p.likelihood.interp == "nearest"
                      and n_cap % og.TILE == 0)
        if not (share_like or use_grouped_beam):
            return GroupFront(rmat)
        cap = og.default_overflow_cap(n_cap)
        stats = og.group_stats(pos, rmat, rot, df.weights, float(df.cell),
                               df.origin, mask)
        under_cap = stats.n_over <= cap
        flags = []
        lo_l = lo_b = vp = None
        if share_like:
            lo_l, fits_kg_l = og.group_boxes(stats, like_pts, df.shape)
            flags.append(torch.all(fits_kg_l | ~like_valid[:, None]) & under_cap)
        if use_grouped_beam:
            vp = BeamVirtualPoints(beam_pts, beam_labels, beam_valid, origins,
                                   p.map_grid_min, p.beam.hit_range, steps_g)
            lo_b, fits_kg_b = og.group_boxes(stats, vp.vpf, df_beam.shape)
            flags.append(torch.all(fits_kg_b | ~vp.chainf[:, None]) & under_cap)
        return GroupFront(rmat, stats, lo_l, lo_b, vp, torch.stack(flags),
                          share_like, use_grouped_beam, cap)

    @staticmethod
    def group_layout(front: GroupFront, fits):
        """``group``'s result from its front and the host's ``fits``
        (``front.flags`` read back): the layout built if one fits."""
        if front.flags is None:
            return front.rmat, None, None
        layout = og.build_layout(front.stats, front.cap) if any(fits) else None
        return (front.rmat,
                ((front.stats, layout, front.lo_like, fits[0])
                 if front.share_like else None),
                ((front.stats, layout, front.lo_beam, fits[-1], front.vp)
                 if front.grouped_beam else None))

    def _measure_models(self, pos, rot, mask, df, df_beam, like_pts,
                        like_valid, beam_pts, beam_labels, beam_valid,
                        origins, use_beam=None, *, occ=None,
                        global_mode=False, spmd_safe=False, grouped=None):
        """Per-particle measurement likelihoods (measure_func,
        src/mcl_3dl.cpp:402-425): ``(lik_l, qual_l, lik_b, tier_like,
        tier_beam)``; ``use_beam`` overrides ``params.use_beam_model``.
        With ``interp="trilinear"`` tracking samples trilinear (tier 2) and
        a ``global_mode`` step samples nearest, its layout built inside
        the likelihood model; the DDA raycast marches ``occ`` (default the
        map's).  ``spmd_safe`` reads nothing on the host: no grouping, the
        whole field sampled, every ray marched (tiers 2/2).  ``grouped``: the
        result of ``group`` on these arguments, when the caller has it."""
        p = self.params
        lp, bp = p.likelihood, p.beam
        use_beam = p.use_beam_model if use_beam is None else use_beam
        if grouped is not None:
            rmat, grouped_like, grouped_beam = grouped
        elif spmd_safe:
            rmat = mq.rotation_matrix(mq.normalize(rot))
            grouped_like = grouped_beam = None
        else:
            rmat, grouped_like, grouped_beam = self.group(
                pos, rot, mask, df, df_beam, like_pts, like_valid, beam_pts,
                beam_labels, beam_valid, origins, use_beam)

        like_args = (df, pos, rot, like_pts, like_valid, lp.match_dist_min,
                     lp.match_dist_flat, lp.match_weight)
        if lp.interp == "nearest" or global_mode:
            lik_l, qual_l, tier_like = likelihood_measure(
                *like_args, active=mask, rmat=rmat, grouped=grouped_like,
                local_kernel=not spmd_safe)
        else:
            lik_l, qual_l, tier_like = likelihood_measure(
                *like_args, rmat=rmat, trilinear=True)

        if not use_beam:
            return lik_l, qual_l, torch.ones_like(lik_l), tier_like, -1
        kw = dict(map_grid_min=p.map_grid_min, map_grid_max=p.map_grid_max,
                  hit_range=bp.hit_range, beam_likelihood_min=bp.beam_likelihood,
                  num_points_default=bp.num_points,
                  sin_total_ref=math.sin(bp.ang_total_ref),
                  add_penalty_short_only_mode=bp.add_penalty_short_only_mode)
        if grouped_beam is not None and grouped_beam[3]:
            lik_b = beam_measure_grouped(
                df_beam, pos, rot, beam_pts, beam_labels, beam_valid, origins,
                num_steps=beam_num_steps(p), grouped=grouped_beam, **kw)
            tier_beam = 0
        else:
            num_steps = (dda_num_steps(p) if bp.use_raycast_using_dda
                         else sphere_num_steps(p))
            lik_b, _ = beam_measure(
                df_beam, pos, rot, beam_pts, beam_labels, beam_valid, origins,
                num_steps=num_steps, use_dda=bp.use_raycast_using_dda,
                occ=occ if occ is not None else self.map.occ,
                filter_label_max=bp.filter_label_max,
                ray_angle_half=bp.ray_angle_half,
                min_dist_thr_sq=p.min_dist_thr_sq, early_exit=not spmd_safe,
                **kw)
            tier_beam = 2
        return lik_l, qual_l, lik_b, tier_like, tier_beam

    def _measurement_step(self, state: ParticleState, df, df_beam, cloud,
                          cloud_label, cloud_valid, origins, odom_pos,
                          odom_rot, prev_pos, prev_rot, f_pos, f_ang,
                          is_global_fix, std_warn_thresh,
                          draws: Optional[StepDraws] = None, *,
                          global_mode: bool = False, global_slots=None,
                          occ=None, normals=None, spmd_safe: bool = False,
                          shard=None):
        """The measurement update (src/mcl_3dl.cpp:363-893).  Returns
        ``(state, f_pos, f_ang, prev_pos, prev_rot, aux)``; ``draws``
        defaults to the engine generator's.  ``is_global_fix`` is a bool or
        a device bool.

        ``global_mode`` (chosen on the host from the particle count) samples
        ``global_slots`` likelihood points (default ``num_points_global``)
        masked by the point ramp, drops the beam model while its global
        budget is 0, and decays the particle count 0.75x through
        ``pf.resize``.  A non-global step is only run with ``n_active <=
        num_particles`` (the host mirror is refreshed from the device every
        step), so it does not build the decay and its ``did_resize`` reads
        False.  ``occ`` is the DDA raycast's grid (default the map's),
        ``normals`` [P, 3] the scan's normals for the normal-weighted
        sampler.

        ``spmd_safe`` (the batched fleet) makes no host read.  With a
        ``shard`` (``shard.Shard``) ``state`` is this rank's slice; the
        draws are the whole capacity's, made alike on every rank (default
        the engine generator's), and each rank keeps its slice.

        It is ``_step_front``, the host read of the grouping's ``fits``
        flags, and ``_step_back``."""
        front = self._step_front(
            state, df, df_beam, cloud, cloud_label, cloud_valid, origins,
            draws, global_mode=global_mode, global_slots=global_slots,
            normals=normals, spmd_safe=spmd_safe, shard=shard)
        return self._step_back(
            front, front.fits(), state, df, df_beam, origins, odom_pos,
            odom_rot, prev_pos, prev_rot, f_pos, f_ang, is_global_fix,
            std_warn_thresh, global_mode=global_mode, occ=occ,
            spmd_safe=spmd_safe, shard=shard)

    def _step(self, *args, **kw):
        """``_measurement_step``'s signature and outputs, from CUDA graphs
        where it can (``step_graph.run``; on the CPU, and for global-mode,
        batched, split and normal-sampler steps, ``_measurement_step``
        itself), inside the span ``step``; a global-mode step records its
        likelihood slot bucket (counter ``global.slots``)."""
        with spans.span("step"):
            if kw.get("global_mode"):
                spans.count("global.slots", kw["global_slots"])
            return step_graph.run(self, *args, **kw)

    def _step_front(self, state: ParticleState, df, df_beam, cloud,
                    cloud_label, cloud_valid, origins,
                    draws: Optional[StepDraws] = None, *,
                    global_mode: bool = False, global_slots=None,
                    normals=None, spmd_safe: bool = False,
                    shard=None) -> StepFront:
        """The step up to its one host read: clip, sampling and
        (``spmd_safe`` aside) ``group_front``."""
        mask = state.active_mask(shard_offset(shard))
        if draws is None and shard is not None:
            slots = self.slots(global_mode, global_slots)
            draws = self.draw_step(*self.keeps(cloud, cloud_valid), *slots[:2],
                                   capacity=shard.capacity)
        (like_pts, like_valid, beam_pts, beam_labels, beam_valid,
         points_not_found, draws) = self.sample_points(
            cloud, cloud_label, cloud_valid, draws, global_mode=global_mode,
            global_slots=global_slots, n_active=state.n_active, state=state,
            normals=normals, shard=shard)
        if shard is not None:
            draws = draws._replace(
                resample_normals=shard.local(draws.resample_normals),
                noise_normals=shard.local(draws.noise_normals),
                expand_normals=shard.local(draws.expand_normals))
        use_beam = self.slots(global_mode, global_slots)[2]
        group = None if spmd_safe else self.group_front(
            state.pos, state.rot, mask, df, df_beam, like_pts, like_valid,
            beam_pts, beam_labels, beam_valid, origins, use_beam)
        return StepFront(mask, like_pts, like_valid, beam_pts, beam_labels,
                         beam_valid, points_not_found, draws, use_beam, group)

    def _step_back(self, front: StepFront, fits, state: ParticleState, df,
                   df_beam, origins, odom_pos, odom_rot, prev_pos, prev_rot,
                   f_pos, f_ang, is_global_fix, std_warn_thresh, *,
                   global_mode: bool = False, occ=None,
                   spmd_safe: bool = False, shard=None):
        """The step after its host read, given ``front`` and the ``fits``
        flags read from it: the layout, both models, the odometry prior,
        the weight update, bias, expectation, jump detection, TF smoothing,
        covariance, resampling, noise redraw, expansion resetting and the
        global-mode decay."""
        p = self.params
        mask, draws = front.mask, front.draws
        like_pts = front.like_pts
        points_not_found = front.points_not_found

        # --- per-particle likelihoods (measure_func, src/mcl_3dl.cpp:402-425)
        lik_l, qual_l, lik_b, tier_like, tier_beam = self._measure_models(
            state.pos, state.rot, mask, df, df_beam, like_pts,
            front.like_valid, front.beam_pts, front.beam_labels,
            front.beam_valid, origins, front.use_beam, occ=occ,
            global_mode=global_mode, spmd_safe=spmd_safe,
            grouped=(None if front.group is None
                     else self.group_layout(front.group, fits)))
        odom_error = normal_likelihood(
            torch.linalg.vector_norm(state.odom_err_lin, dim=-1),
            p.odom_err_integ_lin_sigma)
        likelihood = lik_l * lik_b * odom_error
        match_ratio_min = torch.min(torch.where(mask, qual_l, torch.inf))
        match_ratio_max = torch.max(torch.where(mask, qual_l, -torch.inf))
        if shard is not None:
            # the worst tier any slice paid (JAX's sharded step reports the
            # same); every rank reaches these collectives in this order
            tier_like, tier_beam = shard.max(torch.tensor(
                [tier_like, tier_beam], device=state.device)).tolist()
            match_ratio_min = shard.min(match_ratio_min)
            match_ratio_max = shard.max(match_ratio_max)
        state2, entropy = pf.measure(state, likelihood, shard)

        # --- bias toward the previous pose (src/mcl_3dl.cpp:428-450)
        lin_diff = torch.linalg.vector_norm(state2.pos - prev_pos, dim=-1)
        ang_diff = mq.angle(mq.mul(state2.rot, mq.inv(prev_rot)))
        p_bias = (normal_likelihood(lin_diff, p.bias_var_dist)
                  * normal_likelihood(ang_diff, p.bias_var_ang) + 1e-6)
        in_global = state2.n_active > p.num_particles
        state2 = pf.bias(state2, torch.where(in_global, 1.0, p_bias))
        e_pos, e_rot = pf.expectation_biased(state2, shard)
        e_rot = mq.normalize(e_rot)
        e_max = pf.max_particle(state2, shard)

        # --- map->odom + jump detection (src/mcl_3dl.cpp:630-661)
        map_rot = mq.mul(e_rot, mq.inv(odom_rot))
        map_pos = e_pos - mq.rotate(map_rot, odom_pos)
        jump_dist = torch.linalg.vector_norm(e_pos - prev_pos)
        jump_ang = mq.angle(mq.mul(mq.inv(e_rot), prev_rot))
        jumped = ~in_global & ((jump_dist > p.jump_dist)
                               | (torch.abs(jump_ang) > p.jump_ang))
        state2 = st.where(jumped, reset_error_integrals(state2), state2)
        jump = in_global | jumped

        # --- TF output smoothing (src/mcl_3dl.cpp:662-684); global mode
        # resets the smoothers every step
        rpy = mq.to_rpy(map_rot)
        f_ang2 = mf.where(jump, mf.filter_set(f_ang, rpy), f_ang)
        f_pos2 = mf.where(jump, mf.filter_set(f_pos, map_pos), f_pos)
        f_ang2, rpy_s = mf.filter_step(f_ang2, rpy)
        f_pos2, map_pos_s = mf.filter_step(f_pos2, map_pos)
        map_rot_s = mq.from_rpy(rpy_s)
        pub_rot = mq.mul(map_rot_s, odom_rot)
        pub_pos = map_pos_s + mq.rotate(map_rot_s, odom_pos)

        # --- covariance + convergence (src/mcl_3dl.cpp:704-751)
        cov = pf.covariance(state2, shard)
        thr = [float(x) for x in std_warn_thresh]
        fix = (is_global_fix if isinstance(is_global_fix, torch.Tensor)
               else torch.full((), bool(is_global_fix), dtype=torch.bool,
                               device=state.device))
        large_std = ~fix & (
            (torch.sqrt(cov[0, 0] + cov[1, 1]) > thr[0])
            | (torch.sqrt(cov[2, 2]) > thr[1])
            | (torch.sqrt(cov[5, 5]) > thr[2]))
        fix_ang = torch.sqrt(cov[3, 3] + cov[4, 4] + cov[5, 5])
        fix_dist = torch.sqrt(cov[0, 0] + cov[1, 1] + cov[2, 2])
        converged = ~large_std & (fix_dist < p.fix_dist) & (
            torch.abs(fix_ang) < p.fix_ang)

        # --- resample + noise redraw (src/mcl_3dl.cpp:809-825)
        state3 = pf.resample(state2, draws.u0, draws.resample_normals,
                             self._resample_sigma.to(state.device), shard)
        state3 = state3._replace(
            noise=draws.noise_normals * self._odom_noise_scale.to(state.device))

        # --- expansion resetting (src/mcl_3dl.cpp:853-864)
        expanded = match_ratio_max < p.match_ratio_thresh
        state4 = st.where(expanded, pf.add_noise(
            state3, draws.expand_normals,
            self._expansion_sigma.to(state.device), shard), state3)

        # --- global-localization decay (src/mcl_3dl.cpp:875-888)
        did_resize = state4.n_active > p.num_particles
        if global_mode:
            reduced = (state.n_active.to(torch.float32) * 0.75).to(torch.int32)
            new_n = torch.clamp(reduced, min=p.num_particles)
            state4 = st.where(did_resize, pf.resize(state4, new_n, shard),
                              state4)

        # all-filtered-out guard: leave the filter untouched (:385-391)
        final_state = st.where(points_not_found, state, state4)
        aux = {
            "e_pos": e_pos, "e_rot": e_rot,
            "pub_pos": pub_pos, "pub_rot": pub_rot,
            "map_to_odom_pos": map_pos_s, "map_to_odom_rot": map_rot_s,
            "cov": cov, "entropy": entropy,
            "match_ratio_min": match_ratio_min,
            "match_ratio_max": match_ratio_max,
            "jumped": jump, "expanded": expanded,
            "large_std": large_std, "converged": converged,
            "did_resize": did_resize, "n_active": final_state.n_active,
            "like_slots": like_pts.shape[0],
            "points_not_found": points_not_found,
            "tier_like": tier_like, "tier_beam": tier_beam,
            "e_max_odom_err_lin": e_max["odom_err_lin"],
            "e_max_odom_err_ang": e_max["odom_err_ang"],
        }
        return (final_state,
                mf.where(points_not_found, f_pos, f_pos2),
                mf.where(points_not_found, f_ang, f_ang2),
                torch.where(points_not_found, prev_pos, e_pos),
                torch.where(points_not_found, prev_rot, e_rot),
                aux)

    # --------------------------------------------------------------- services

    def resize_particles(self, n: int) -> None:
        """resize_mcl_particle service (src/mcl_3dl.cpp:1019-1025)."""
        self.drop_step_graphs()
        self._grow_capacity(n)
        self.pstate = pf.resize(self.pstate, n)
        self._n_active_host = n
        self._maybe_shrink_capacity(n)

    def expansion_reset(self) -> None:
        """expansion_resetting service (src/mcl_3dl.cpp:1026-1038)."""
        self.drop_step_graphs()
        self.pstate = pf.add_noise(
            self.pstate, self._normals(self.pstate.capacity, 6),
            self._expansion_sigma)

    def _standable_points(self) -> np.ndarray:
        """The map voxelized at the global-localization grid, keeping the
        points a robot could stand on (src/mcl_3dl.cpp:1050-1074)."""
        p = self.params
        grid = p.global_localization_grid_lin
        points = voxel_downsample(self.map.points, grid)
        return points[standable_mask(points, grid, p.dist_weight)]

    def _seed(self, n: int, pos, yaw, prob) -> int:
        """Replace the particle set with ``n`` seeds: ``pos`` [cap, 3],
        ``yaw`` [cap] (composed with the IMU attitude) and ``prob`` [cap],
        host arrays or device tensors, capacity already grown."""
        f = dict(dtype=torch.float32, device=self.device)
        yaw = torch.as_tensor(yaw, **f)
        zero = torch.zeros_like(yaw)
        rpy = torch.stack([zero, zero, yaw], dim=-1)
        rot = mq.normalize(mq.mul(mq.from_rpy(rpy),
                                  torch.as_tensor(self.imu_quat, **f)))
        self.pstate = st.zeros(self.pstate.capacity, n, self.device)._replace(
            pos=torch.as_tensor(pos, **f), rot=rot,
            prob=torch.as_tensor(prob, **f))
        self._n_active_host = n
        return n

    def global_localization(self) -> int:
        """global_localization service (src/mcl_3dl.cpp:1039-1099): one
        particle per (standable surface point, yaw bin), the yaw composed
        with the IMU attitude; returns the new particle count."""
        if not self.has_map:
            raise RuntimeError("No map received.")
        with spans.request("global_localization"):
            self.drop_step_graphs()
            with spans.span("global.standable"):
                points = self._standable_points()
            if points.shape[0] == 0:
                return self._n_active_host
            with spans.span("global.seed"):
                dyaw = self.params.global_localization_div_yaw
                n = points.shape[0] * dyaw
                spans.count("global.seeds", n)
                self._grow_capacity(n)
                # built on the device from the standable points: on the
                # host, millions of seeds would take most of the call
                idx = torch.arange(self.pstate.capacity, device=self.device)
                pt_idx = torch.clamp(idx // dyaw, max=points.shape[0] - 1)
                pos = torch.as_tensor(points, dtype=torch.float32,
                                      device=self.device)[pt_idx]
                yaw = (2.0 * math.pi * (idx % dyaw).double() / dyaw).float()
                # reference quirk: 1/points, not 1/n
                prob = torch.where(idx < n,
                                   float(np.float32(1.0 / points.shape[0])),
                                   0.0)
                return self._seed(n, pos, yaw, prob)

    def global_localization_correlative(
            self, num_seeds: int = 1024, yaw_bins: Optional[int] = None,
            scan_points_base: Optional[np.ndarray] = None,
            yaw_prior: Optional[tuple] = None,
            seed_z: Optional[float] = None) -> int:
        """One-shot dense global localization (the JAX package's addition):
        every (x, y) map cell x yaw bin scored against the latest scan by
        FFT cross-correlation of the planar likelihood field
        (``map/correlative.py``), the top ``num_seeds`` candidates seeded
        with score weights, z from the nearest standable surface point
        and the yaw composed with the IMU attitude.

        ``yaw_prior=(center, tol)`` keeps the yaw bins within ``tol`` of
        ``center`` (a kidnap cannot corrupt the attitude); ``seed_z``
        pins the seeded height.  Returns the new particle count."""
        if not self.has_map:
            raise RuntimeError("No map received.")
        self.drop_step_graphs()
        if scan_points_base is None:
            scan_points_base = self._last_scan_base
        if scan_points_base is None or len(scan_points_base) == 0:
            raise RuntimeError("No scan available for correlation.")
        p = self.params
        lp = p.likelihood
        scan = np.asarray(scan_points_base, np.float32)
        keep = clip_mask(torch.as_tensor(scan), lp.clip_near, lp.clip_far,
                         lp.clip_z_min, lp.clip_z_max).numpy()
        scan = scan[keep]
        if len(scan) == 0:
            raise RuntimeError("All scan points clipped.")

        df = self.map.df
        # padding covers the scan footprint, so the circular correlation
        # never wraps a real peak
        pad = int(np.ceil(lp.clip_far / df.cell)) + 2
        field2d = mc.build_planar_field(
            df, lp.match_dist_min, lp.match_dist_flat, lp.match_weight,
            z_lo=-np.inf, z_hi=np.inf, pad_cells=pad)
        w = np.asarray(df.weights)
        scan_xyw = torch.as_tensor((scan[:, :2] * w[None, :2]).astype(np.float32),
                                   device=self.device)
        nbins = yaw_bins or max(p.global_localization_div_yaw, 36)
        yaws_np = (2.0 * np.pi * np.arange(nbins) / nbins).astype(np.float32)
        yaws = torch.as_tensor(yaws_np, device=self.device)
        scores = mc.correlate_scan(field2d, scan_xyw, yaws)
        if yaw_prior is not None:
            # the seeded map yaw is the bin's yaw, so the bins are held
            # against the prior's center directly
            center, tol = yaw_prior
            dy = np.arctan2(np.sin(yaws_np - center), np.cos(yaws_np - center))
            bin_ok = torch.as_tensor(np.abs(dy) <= tol, device=self.device)
            scores = torch.where(bin_ok[:, None, None], scores, -torch.inf)
        xs, ys, yaw_is, vals = (a.cpu().numpy() for a in
                                mc.top_candidates(scores, field2d, num_seeds))
        good = np.isfinite(vals) & (vals > 0)
        xs, ys, yaw_is, vals = xs[good], ys[good], yaw_is[good], vals[good]
        if len(xs) == 0:
            return self._n_active_host

        cand_xy = np.stack([xs / w[0], ys / w[1]], axis=1)
        if seed_z is not None:
            zs = np.full(len(cand_xy), float(seed_z), np.float32)
        else:
            surf = self._standable_points()
            if len(surf) == 0:
                surf = self.map.points
            d2 = ((surf[None, :, 0] - cand_xy[:, None, 0]) ** 2
                  + (surf[None, :, 1] - cand_xy[:, None, 1]) ** 2)
            zs = surf[np.argmin(d2, axis=1), 2]
        return self._seed_correlative(cand_xy, zs, yaw_is, vals, nbins)

    def _seed_correlative(self, cand_xy, zs, yaw_is, vals, nbins) -> int:
        """Replace the particle set with score-weighted candidates (the
        tail of ``global_localization_correlative``)."""
        n = len(cand_xy)
        self._grow_capacity(n)
        idx = np.arange(self.pstate.capacity)
        sel = np.minimum(idx, n - 1)
        pos = np.stack([cand_xy[sel, 0], cand_xy[sel, 1], zs[sel]], axis=1)
        # the candidates carry the absolute map yaw: take the IMU yaw out
        # before composing with the IMU attitude
        imu_yaw = float(mqn.to_rpy(np.asarray(self.imu_quat, np.float64))[2])
        yaw = 2.0 * np.pi * np.asarray(yaw_is)[sel] / nbins - imu_yaw
        # weights from the relative correlation score, sharpened so the
        # budget concentrates on the top candidates
        rel = np.asarray(vals)[sel] / max(float(np.max(vals)), 1e-12)
        prob = np.where(idx < n, np.exp(-60.0 * (1.0 - rel)), 0.0)
        prob = prob / max(prob[:n].sum(), 1e-12)
        return self._seed(n, pos, yaw, prob)

    def landmark_step(self, state: ParticleState, meas_pos, meas_rot, nd,
                      u0, normals6) -> ParticleState:
        """The landmark update on ``state`` (src/mcl_3dl.cpp:899-940): the
        6-D Gaussian of the pose difference as the likelihood, then
        resampling with the draws ``u0`` and ``normals6`` [cap, 6]."""
        lik = landmark_likelihood(state.pos, state.rot, meas_pos, meas_rot,
                                  nd)
        state2, _ = pf.measure(state, lik)
        return pf.resample(state2, u0, normals6, self._resample_sigma)

    def landmark(self, pos, rot, cov66) -> None:
        """Landmark pose measurement (cbLandmark, src/mcl_3dl.cpp:899-940);
        the Gaussian's normalization and inverse are computed on the host
        once, as the reference's NormalLikelihoodNd constructor does."""
        self.drop_step_graphs()
        f = dict(dtype=torch.float32, device=self.device)
        u0 = torch.rand((), generator=self._gen, device=self.device)
        normals6 = self._normals(self.pstate.capacity, 6)
        self.pstate = self.landmark_step(
            self.pstate, torch.as_tensor(np.asarray(pos, np.float32), **f),
            torch.as_tensor(np.asarray(rot, np.float32), **f),
            NormalLikelihoodNd(cov66, device=self.device), u0, normals6)

    # ------------------------------------------------------------ inspection

    def get_particles(self):
        """publishParticles (src/mcl_3dl.cpp:1101-1125): ``(pos [n, 3],
        rot [n, 4] normalized, prob [n])`` of the active particles, numpy
        float32."""
        n = int(self.pstate.n_active)
        rot = mq.normalize(self.pstate.rot[:n])
        return (self.pstate.pos[:n].cpu().numpy(), rot.cpu().numpy(),
                self.pstate.prob[:n].cpu().numpy())

    def classify_cloud(self, points_base, pos, rot):
        """The matched/unmatched debug clouds (src/mcl_3dl.cpp:761-805):
        ``(matched, unmatched)`` masks over ``points_base`` placed at the
        pose ``pos``, ``rot``, from the trilinear field (whatever
        ``likelihood.interp`` is): unmatched beyond
        ``unmatch_output_dist``, matched below ``match_output_dist``."""
        p = self.params
        f = dict(dtype=torch.float32, device=self.device)
        q = mq.rotate(torch.as_tensor(np.asarray(rot, np.float32), **f),
                      torch.as_tensor(np.asarray(points_base, np.float32), **f)
                      ) + torch.as_tensor(np.asarray(pos, np.float32), **f)
        d = sample_field(self.map.df, q, trilinear=True)
        unmatched = d > f32(p.unmatch_output_dist)
        matched = ~unmatched & (d < f32(p.match_output_dist))
        return matched.cpu().numpy(), unmatched.cpu().numpy()

    def debug_beam_status(self, pos, rot, points_base, origin_indices,
                          origins_base) -> np.ndarray:
        """Beam classification [B] (``BeamStatus``) of ``points_base`` at
        one pose: the data behind the reference's ray and collision
        markers (src/mcl_3dl.cpp:464-628), by the configured raycaster."""
        p = self.params
        bp = p.beam
        f = dict(dtype=torch.float32, device=self.device)
        num_steps = (dda_num_steps(p) if bp.use_raycast_using_dda
                     else bp.max_sphere_steps)
        _, status = beam_measure(
            self.map.df_beam,
            torch.as_tensor(np.asarray(pos, np.float32), **f)[None, :],
            torch.as_tensor(np.asarray(rot, np.float32), **f)[None, :],
            torch.as_tensor(np.asarray(points_base, np.float32), **f),
            torch.as_tensor(np.asarray(origin_indices, np.int64),
                            device=self.device),
            torch.ones(len(points_base), dtype=torch.bool, device=self.device),
            torch.as_tensor(np.asarray(origins_base, np.float32), **f),
            map_grid_min=p.map_grid_min, map_grid_max=p.map_grid_max,
            hit_range=bp.hit_range, beam_likelihood_min=bp.beam_likelihood,
            num_points_default=max(bp.num_points, 1),
            sin_total_ref=math.sin(bp.ang_total_ref),
            add_penalty_short_only_mode=bp.add_penalty_short_only_mode,
            num_steps=num_steps, use_dda=bp.use_raycast_using_dda,
            occ=self.map.occ, filter_label_max=bp.filter_label_max,
            ray_angle_half=bp.ray_angle_half,
            min_dist_thr_sq=p.min_dist_thr_sq)
        return status[0].cpu().numpy()

    def save_accumulated_pcd(self, path) -> int:
        """Write the scans accumulated in the map frame (``output_pcd``) to
        a binary PCD, the reference's shutdown dump (src/mcl_3dl.cpp:
        1340-1348); returns the number of points written."""
        if not self._pc_all_accum:
            return 0
        pts = np.concatenate(self._pc_all_accum, axis=0)
        write_pcd(path, pts)
        return len(pts)

    def diagnostics(self) -> Diagnostics:
        """diagnoseStatus (src/mcl_3dl.cpp:1127-1148)."""
        if self.status.error == ErrorCode.POINTS_NOT_FOUND:
            return Diagnostics(False, "Valid points does not found.",
                               self.has_map, self.has_odom, self.has_imu)
        if self.status.convergence_status == ConvergenceStatus.LARGE_STD_VALUE:
            return Diagnostics(False, "Too Large Standard Deviation.",
                               self.has_map, self.has_odom, self.has_imu)
        return Diagnostics(True, "OK", self.has_map, self.has_odom,
                           self.has_imu)


def standable_mask(points: np.ndarray, grid: float, dist_weight) -> np.ndarray:
    """Points with no neighbour within weighted ``grid`` of p + (0, 0,
    0.01 + grid): the pc_filter of src/mcl_3dl.cpp:1062-1074 with the
    node's anisotropic point representation, as an exact radius query on
    a kd-tree."""
    from scipy.spatial import cKDTree

    points = np.asarray(points, np.float64).reshape(-1, 3)
    if points.shape[0] == 0:
        return np.zeros((0,), bool)
    w = np.asarray(dist_weight, np.float64)
    probe = (points + np.array([0.0, 0.0, 0.01 + grid])) * w
    tree = cKDTree(points * w, balanced_tree=False, compact_nodes=False)
    d, _ = tree.query(probe, k=1, distance_upper_bound=grid, workers=-1)
    return ~np.isfinite(d)
