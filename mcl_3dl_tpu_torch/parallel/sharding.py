"""The mesh, and the fleet and particle-split filter steps.

The port of ``mcl_3dl_tpu/parallel/sharding.py``.  Ranks of the default
``torch.distributed`` process group form a ``("robots", "particles")``
mesh; each axis has its subgroups (``dist.new_group``).  The map is
replicated; every rank holds its own slice of the particle state.

* ``sharded_filter_step``: one robot's particles split over the
  particles axis.  The measurement models run on the rank's slice, with
  the kernels and the rank's own tier choice (one host read per rank, as
  JAX runs a ``lax.cond`` per shard under ``shard_map``); only the
  filter's boundaries cross ranks (``shard.Shard``).
* ``fleet_filter_step_grouped``: robots split over the robots axis; each
  rank runs its robots in turn through the single-robot step
  (``MCL3DL._step``: one pair of CUDA graphs serves every robot, the
  counterpart of JAX's ``lax.scan`` over robots), with the grouped kernels
  K1/K2 and each robot's own host tier read.
* ``fleet_filter_step``: the batched ``spmd_safe`` fleet,
  ``torch.func.vmap`` of the single-robot step over a leading robots
  axis: no host read inside, so the likelihood samples the whole field
  (tier 2, kernel M4) and the beam marches every ray (M2, or M3 with the
  DDA beam), each kernel launched once for the fleet through its vmap
  rule (``ops/build.py``), on the whole fleet's ``[R * P, K]`` working
  set at once.

The fleet steps take the single-robot step's arguments with a leading
robots axis: ``step(state_b, df, df_beam, cloud [R, P, 3], cloud_label
[R, P], cloud_valid [R, P], origins [R, L, 3], odom_pos [R, 3], odom_rot
[R, 4], prev_pos [R, 3], prev_rot [R, 4], f_pos_b, f_ang_b,
is_global_fix [R], std_warn_thresh=None, draws=None, *, occ=None,
normals=None)``, for this rank's robots (``shard_state(..., batched=True)``
and ``robots_slice``).  ``draws`` are per-robot ``StepDraws`` stacked on
a leading axis; by default robot ``r`` (its index in the whole fleet)
draws from its own ``torch.Generator``, seeded from ``Params.seed`` and
``r``.  They return ``(state_b, f_pos_b, f_ang_b, prev_pos [R, 3],
prev_rot [R, 4], aux)``, every ``aux`` entry with a leading robots axis.

A card holds one NCCL rank.  Every rank must reach the same collectives
in the same order: none sits inside a tier branch or a host-exited march.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from mcl_3dl_tpu_torch.engine import StepDraws, resolve_device
from mcl_3dl_tpu_torch.profiling import spans
from mcl_3dl_tpu_torch.shard import Shard
from mcl_3dl_tpu_torch.state import ParticleState


class Mesh:
    """A ``(robots, particles)`` grid of ranks with this rank's place in
    it, its axis subgroups (``None`` for the default group) and its
    device.  Without a process group: a 1x1 mesh with no groups."""

    axis_names = ("robots", "particles")

    def __init__(self, ranks: np.ndarray, rank: int, device: torch.device,
                 robots_group=None, particles_group=None,
                 distributed: bool = False):
        self.devices = ranks          # [robots, particles] global ranks
        self.rank = rank
        self.device = device
        self.robots_group = robots_group
        self.particles_group = particles_group
        self.distributed = distributed
        row, col = np.argwhere(ranks == rank)[0]
        self.robot_index, self.particle_index = int(row), int(col)

    @classmethod
    def local(cls, device) -> "Mesh":
        """The 1x1 mesh of this process alone, with or without a process
        group."""
        return cls(np.zeros((1, 1), np.int64), 0, torch.device(device))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def particle_shard(self, local_capacity: int) -> Optional[Shard]:
        """The ``Shard`` of this rank's slice of ``local_capacity`` slots
        (None without a process group: the one-process step)."""
        if not self.distributed:
            return None
        n = self.shape["particles"]
        return Shard(self.particles_group, self.particle_index * local_capacity,
                     n * local_capacity)

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, device={self.device}, "
                f"distributed={self.distributed})")


def make_mesh(n_devices: Optional[int] = None, robots: int = 1,
              device=None) -> Mesh:
    """Mesh over ``("robots", "particles")`` of the default process
    group's ranks (``n_devices``, when given, must be the world size), or
    a 1x1 mesh without one.  ``device``: the rank's device, by default
    its card (``cuda:LOCAL_RANK``, made current) unless the caller asks
    for the CPU."""
    distributed = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if distributed else 1
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a world of {n} ranks; "
                         f"the world has {world}")
    if n % robots != 0:
        raise ValueError(f"{n} devices not divisible by {robots} robot groups")
    ranks = np.arange(n).reshape(robots, n // robots)
    rank = dist.get_rank() if distributed else 0
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)     # the kernels launch on this device
    if not distributed:
        return Mesh.local(dev)

    def groups(sets):
        # every rank creates every group, in one order; an axis that spans
        # the world reduces over the default group
        mine = None
        for members in sets:
            members = [int(r) for r in members]
            g = None if len(members) == world else dist.new_group(members)
            if rank in members:
                mine = g
        return mine

    return Mesh(ranks, rank, dev, robots_group=groups(ranks.T),
                particles_group=groups(ranks), distributed=True)


class LocalState(NamedTuple):
    """A rank's slice of a state: ``offset`` is the global slot of its
    first particle, ``robot_offset`` the global index of its first robot
    (0 for one robot's state)."""

    state: ParticleState
    offset: int
    robot_offset: int


def _slice(x, n_parts: int, part: int, dim: int):
    size = x.shape[dim]
    if size % n_parts:
        raise ValueError(f"{size} does not split evenly over {n_parts}")
    k = size // n_parts
    return x.narrow(dim, part * k, k), part * k


def shard_state(state: ParticleState, mesh: Mesh,
                batched: bool = False) -> LocalState:
    """This rank's slice of ``state`` on the mesh's device: the particle
    axis split over the particles axis (``n_active`` stays the whole
    count), and with ``batched`` the leading robots axis over the robots
    axis.  Each axis must split evenly."""
    lead = 1 if batched else 0
    n_p, n_r = mesh.shape["particles"], mesh.shape["robots"]
    cols, robot_offset = list(state[:-1]), 0
    n_active = state.n_active
    if batched:
        cut = [_slice(c, n_r, mesh.robot_index, 0) for c in cols]
        cols, robot_offset = [c for c, _ in cut], cut[0][1]
        n_active = _slice(n_active, n_r, mesh.robot_index, 0)[0]
    cut = [_slice(c, n_p, mesh.particle_index, lead) for c in cols]
    local = ParticleState(*(c.to(mesh.device).contiguous() for c, _ in cut),
                          n_active=n_active.to(mesh.device))
    return LocalState(local, cut[0][1], robot_offset)


def robots_slice(x, mesh: Mesh):
    """This rank's robots of a whole-fleet per-robot input (a tensor, or
    a tuple of them such as a ``FilterState`` or ``StepDraws``, ``None``
    fields kept)."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x)(*(robots_slice(v, mesh) for v in x))
    return _slice(x, mesh.shape["robots"], mesh.robot_index, 0)[0]


def sharded_filter_step(engine, mesh: Mesh):
    """The engine's measurement step on this rank's slice of one robot's
    particles (``shard_state``), with the same arguments and return
    layout as ``MCL3DL._measurement_step``.  Inputs other than the state
    are replicated: every rank passes the same cloud, filters and draws
    (the whole capacity's; each rank keeps its slice).  The models run on
    the slice with the kernels and the rank's own tiers; ``aux`` holds
    the worst tier any rank paid.  Without a process group it is the
    one-process step."""

    def step(state, *args, **kw):
        return engine._measurement_step(
            state, *args, shard=mesh.particle_shard(state.capacity), **kw)

    return step


def _robot_seed(seed: int, robot: int) -> int:
    return int(np.random.SeedSequence([seed, robot]).generate_state(1)[0])


class _FleetDraws:
    """Each robot's ``torch.Generator``, seeded from ``Params.seed`` and
    the robot's index in the whole fleet, made at first use."""

    def __init__(self, engine):
        self.engine = engine
        self.gens = {}

    def __call__(self, robot: int, cloud, cloud_valid, capacity: int):
        eng = self.engine
        gen = self.gens.get(robot)
        if gen is None:
            gen = torch.Generator(device=eng.device)
            gen.manual_seed(_robot_seed(eng.params.seed, robot))
            self.gens[robot] = gen
        return eng.draw_step(*eng.keeps(cloud, cloud_valid), gen=gen,
                             capacity=capacity)


def _robot(x, i):
    """Robot ``i`` of a batched tensor or tuple of tensors."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x)(*(_robot(v, i) for v in x))
    return x[i]


def _stack(xs, device):
    """Per-robot values stacked on a leading axis (tuples field by field;
    Python ints and bools into an int32 or bool tensor on ``device``)."""
    x0 = xs[0]
    if x0 is None:
        return None
    if isinstance(x0, tuple):
        return type(x0)(*(_stack([x[k] for x in xs], device)
                          for k in range(len(x0))))
    if isinstance(x0, torch.Tensor):
        return torch.stack(xs)
    return torch.tensor(xs, device=device, dtype=torch.bool
                        if isinstance(x0, bool) else torch.int32)


def _thresholds(engine, std_warn_thresh):
    p = engine.params
    return std_warn_thresh or (p.std_warn_thresh_xy, p.std_warn_thresh_z,
                               p.std_warn_thresh_yaw)


def _fleet_draws(draw, r0, cloud, cloud_valid, capacity):
    return _stack([draw(r0 + i, cloud[i], cloud_valid[i], capacity)
                   for i in range(cloud.shape[0])], cloud.device)


def fleet_filter_step_grouped(engine, mesh: Optional[Mesh] = None):
    """The fleet step with the fast per-robot tiers: robots split over the
    mesh's robots axis, each rank running its robots in turn through the
    full single-robot step, ``MCL3DL._step`` (grouped kernels K1/K2, K3
    where a robot is tight in attitude, each robot's own host read of its
    ``fits`` flags).  On the card each robot's state, draws and inputs are
    copied into the engine's graphs, which replay and are copied out:
    every robot has the same shapes, so one pair of graphs serves them
    all.  Robot ``i``'s outputs are the single-robot step's on
    its state and draws, bit for bit.  The working set is one robot's.
    Without a mesh this process runs every robot it is given.
    A call is one request of ``profiling.spans``, ``fleet_step``: each
    robot's ``fleet.draws`` and step spans carry its index in the whole
    fleet, then ``fleet.stack``.
    Raises on a particles axis other than 1 (build the mesh with
    ``make_mesh(n, robots=n)``)."""
    mesh = mesh or Mesh.local(engine.device)
    if mesh.shape["particles"] != 1:
        raise ValueError(
            "fleet_filter_step_grouped needs a robots-only mesh "
            f"(particles axis = 1); got {mesh.shape} -- build it "
            "with make_mesh(n, robots=n)")
    draw = _FleetDraws(engine)

    def step(state_b, df, df_beam, cloud, cloud_label, cloud_valid, origins,
             odom_pos, odom_rot, prev_pos, prev_rot, f_pos_b, f_ang_b,
             is_global_fix, std_warn_thresh=None, draws=None, *, occ=None,
             normals=None):
        with spans.request("fleet_step"):
            n_robots, cap = state_b.pos.shape[:2]
            r0 = mesh.robot_index * n_robots
            thr = _thresholds(engine, std_warn_thresh)
            gfix = torch.as_tensor(is_global_fix).expand(n_robots)
            outs = []
            try:
                for i in range(n_robots):
                    spans.robot = r0 + i
                    if draws is not None:
                        d = _robot(draws, i)
                    else:
                        with spans.span("fleet.draws"):
                            d = draw(r0 + i, cloud[i], cloud_valid[i], cap)
                    outs.append(engine._step(
                        _robot(state_b, i), df, df_beam, cloud[i],
                        cloud_label[i], cloud_valid[i], origins[i],
                        odom_pos[i], odom_rot[i], prev_pos[i], prev_rot[i],
                        _robot(f_pos_b, i), _robot(f_ang_b, i), gfix[i], thr,
                        d, occ=occ, normals=_robot(normals, i)))
            finally:
                spans.robot = None
            dev = cloud.device
            with spans.span("fleet.stack"):
                state, f_pos, f_ang, pp, pr = (
                    _stack([o[k] for o in outs], dev) for k in range(5))
                aux = {k: _stack([o[5][k] for o in outs], dev)
                       for k in outs[0][5]}
            return state, f_pos, f_ang, pp, pr, aux

    return step


def fleet_filter_step(engine, mesh: Optional[Mesh] = None):
    """The batched fleet step: ``torch.func.vmap`` of the single-robot
    ``spmd_safe`` step over the leading robots axis, robots split over
    the mesh's robots axis.  No host read inside: tiers 2/2 (the whole
    field sampled, every ray marched) for every robot, each robot's result
    the single-robot ``spmd_safe`` step's up to the order of the batched
    reductions.  It holds the whole fleet's measurement working set at
    once.  Raises on a particles axis other than 1 (one robot's particle
    split is ``sharded_filter_step``)."""
    mesh = mesh or Mesh.local(engine.device)
    if mesh.shape["particles"] != 1:
        raise ValueError(
            "fleet_filter_step splits robots only (particles axis = 1); "
            f"got {mesh.shape}")
    draw = _FleetDraws(engine)

    def step(state_b, df, df_beam, cloud, cloud_label, cloud_valid, origins,
             odom_pos, odom_rot, prev_pos, prev_rot, f_pos_b, f_ang_b,
             is_global_fix, std_warn_thresh=None, draws=None, *, occ=None,
             normals=None):
        n_robots, cap = state_b.pos.shape[:2]
        thr = _thresholds(engine, std_warn_thresh)
        if draws is None:
            draws = _fleet_draws(draw, mesh.robot_index * n_robots, cloud,
                                 cloud_valid, cap)
        gfix = torch.as_tensor(is_global_fix, device=cloud.device).expand(
            n_robots)
        # vmap maps tensors only: the draws' None fields, and the aux
        # entries that are Python values, go around it
        fields = [k for k, v in draws._asdict().items() if v is not None]
        constants = {}

        def one(state, cl, cll, clv, org, op, orot, pp, pr, fp, fa, gf, nrm,
                *draw_cols):
            d = StepDraws(**dict(zip(fields, draw_cols)),
                          **{k: None for k in StepDraws._fields
                             if k not in fields})
            out = engine._measurement_step(
                state, df, df_beam, cl, cll, clv, org, op, orot, pp, pr, fp,
                fa, gf, thr, d, occ=occ, normals=nrm, spmd_safe=True)
            aux = {k: v for k, v in out[5].items()
                   if isinstance(v, torch.Tensor)}
            constants.update((k, v) for k, v in out[5].items()
                             if not isinstance(v, torch.Tensor))
            return (*out[:5], aux)

        nrm_dim = None if normals is None else 0
        in_dims = (0,) * 12 + (nrm_dim,) + (0,) * len(fields)
        out = torch.func.vmap(one, in_dims=in_dims)(
            state_b, cloud, cloud_label, cloud_valid, origins, odom_pos,
            odom_rot, prev_pos, prev_rot, f_pos_b, f_ang_b, gfix, normals,
            *(getattr(draws, k) for k in fields))
        aux = dict(out[5])
        for k, v in constants.items():
            aux[k] = _stack([v] * n_robots, cloud.device)
        return (*out[:5], aux)

    return step


__all__ = ["Mesh", "LocalState", "make_mesh", "shard_state", "robots_slice",
           "sharded_filter_step", "fleet_filter_step",
           "fleet_filter_step_grouped"]
