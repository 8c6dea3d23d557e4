"""The particle split and the robots split over ``torch.distributed``: the
port's ``__graft_entry__.dryrun_multichip``, ``tools/exp_collective.py``
and part A of ``tools/exp_scaling.py``.

    torchrun --nproc-per-node 4 -m mcl_3dl_tpu_torch.tools.sharded --backend nccl
    python -m mcl_3dl_tpu_torch.tools.sharded --cpu --backend gloo --world 4
    python -m mcl_3dl_tpu_torch.tools.sharded --world 1 --particles 1048576

Under ``torchrun`` the ranks come from its environment; otherwise the
tool spawns ``--world`` processes itself (a ``file://`` rendezvous in a
temporary directory).  Every rank builds the flagship room world's engine
at ``--particles`` (the whole capacity; default 1024 a rank) from the
converged-tracking spread, the whole state and the whole capacity's draws
from one seed, and then

1. runs ``parallel.sharded_filter_step`` on its slice, and the
   one-process step on the whole state with the same draws;
2. checks: the outputs are finite, tiers 0/0 on every rank (``aux``
   holds the worst any rank paid), the pose matches the one-process step
   (``e_pos``/``e_rot`` atol 1e-5, ``cov`` rtol 1e-3), and so do the
   measured weights against one process scoring the same slices in turn
   (``WEIGHTS_RTOL`` of the largest: sums split over ranks add in another
   order).  Each rank groups its own slice's poses for the kernels, and a
   particle's grouped score depends on its group, so against the
   one-process step's weights (the whole capacity grouped at once) the
   difference is reported (``grouping_err``), not held.  The resampling
   is held bit for bit: the weights ``pf.measure`` gives the slices
   (recomputed as the step computes them, and tied to the step by its
   entropy, which must be equal), gathered, go through one-process
   ``pf.resample`` with the same comb offset and normals, and the rank's
   resampled slice must be that result's slice.  Against the one-process
   step a resampled slot may differ where a comb tooth falls between the
   two processes' CDFs; the count is reported (``resampled_moved``).  With a world of
   1 the collectives return their inputs, so the slice must equal the
   one-process state bit for bit;
3. at the shipped settings (96 likelihood points, 3 beams, a 1024-point
   scan) and the same capacity, times the split step on the ranks
   against the one-process step on one rank's device, in turns
   (``--iters`` each): with a world of 1 the cost of the machinery (and
   the two must be bit-equal), with more ranks the split's gain.

Rank 0 prints one JSON line with the card's ``nvidia-smi`` name and
power limit.  A card holds one NCCL rank; with gloo the tensors stay on
the CPU (``--cpu``).  ``spawn`` and the ``case_*`` functions are what
``tests/test_torch_sharding.py`` runs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from mcl_3dl_tpu_torch import pf, worlds
from mcl_3dl_tpu_torch import state as st
from mcl_3dl_tpu_torch.math.nd import normal_likelihood
from mcl_3dl_tpu_torch.models.motion import reset_error_integrals
from mcl_3dl_tpu_torch.parallel import (fleet_filter_step_grouped, make_mesh,
                                        robots_slice, shard_state,
                                        sharded_filter_step)
from mcl_3dl_tpu_torch.tools import card
from mcl_3dl_tpu_torch.tools import fleet as tfleet

PER_RANK = 1024
CLOUD_POINTS = 256
WEIGHTS_RTOL = 1e-5      # measured weights, of the largest weight
SMALL = dict(like_points=8, beam_clip_far=2.0, beam_clip_z=1.0)


def step_args(eng, scan):
    """The step's arguments after the state, for ``scan`` at the
    engine's filters and previous pose, odometry at the identity."""
    p = eng.params
    _, cloud = eng.prepare_cloud(scan, np.zeros(len(scan), np.int64),
                                 tfleet.ORIGIN)
    f = dict(dtype=torch.float32, device=eng.device)
    return (eng.map.df, eng.map.df_beam, *cloud, torch.zeros(3, **f),
            torch.tensor([0.0, 0.0, 0.0, 1.0], **f), eng.state_prev_pos,
            eng.state_prev_rot, eng.f_pos, eng.f_ang, False,
            (p.std_warn_thresh_xy, p.std_warn_thresh_z, p.std_warn_thresh_yaw))


def measured_weights(eng, state, args, draws, shard=None, slices=1):
    """The weights ``pf.measure`` gives ``state`` in the step on ``args``
    and ``draws`` (the step's own sampling, models and normalization),
    over the whole capacity: with ``shard`` the state is this rank's slice
    and its weights are gathered; with ``slices`` the models score that
    many equal slices in turn (each grouped on its own, as the split's
    ranks group theirs) before one normalization.  ``(weights,
    entropy)``."""
    p = eng.params
    df, df_beam, cloud, label, valid, origins = args[:6]
    (like_pts, like_valid, beam_pts, beam_labels, beam_valid, _,
     _) = eng.sample_points(cloud, label, valid, draws,
                            n_active=state.n_active, state=state, shard=shard)
    mask = state.active_mask(0 if shard is None else shard.offset)
    k = state.capacity // slices
    parts = [eng._measure_models(
        state.pos[i * k:(i + 1) * k], state.rot[i * k:(i + 1) * k],
        mask[i * k:(i + 1) * k], df, df_beam, like_pts, like_valid, beam_pts,
        beam_labels, beam_valid, origins, eng.slots(False)[2])
        for i in range(slices)]
    lik_l = torch.cat([m[0] for m in parts])
    lik_b = torch.cat([m[2] for m in parts])
    odom = normal_likelihood(torch.linalg.vector_norm(state.odom_err_lin,
                                                      dim=-1),
                             p.odom_err_integ_lin_sigma)
    measured, entropy = pf.measure(state, lik_l * lik_b * odom, shard)
    prob = measured.prob if shard is None else shard.gather(measured.prob)
    return prob, entropy


def _flat(aux, keys=("e_pos", "e_rot", "pub_pos", "cov")):
    return {k: aux[k].detach().cpu().numpy().tolist() for k in keys}


def case_step(mesh, dev, particles=None, seed=0):
    """The particle split against the one-process step on the same
    draws: this rank's comparison (see the module docstring)."""
    world = mesh.shape["particles"]
    cap = particles or PER_RANK * world
    eng = tfleet.engine(cap, dev, **SMALL)
    scan = worlds.scan(np.random.default_rng(seed), CLOUD_POINTS)
    args = step_args(eng, scan)
    draws = eng.draw_step(*eng.keeps(args[2], args[4]), capacity=cap)
    full = eng.pstate
    ref = eng._measurement_step(full, *args, draws)
    local = shard_state(full, mesh)
    out = sharded_filter_step(eng, mesh)(local.state, *args, draws)
    aux, raux = out[5], ref[5]
    sl = slice(local.offset, local.offset + local.state.capacity)
    # the resampling on the split's own weights, in one process
    shard = mesh.particle_shard(local.state.capacity)
    w_split, entropy = measured_weights(eng, local.state, args, draws, shard)
    w_sliced, _ = measured_weights(eng, full, args, draws, slices=world)
    w_one, _ = measured_weights(eng, full, args, draws)
    pre = full._replace(prob=w_split)
    pre = st.where(aux["jumped"], reset_error_integrals(pre), pre)
    resampled = pf.resample(pre, draws.u0, draws.resample_normals,
                            eng._resample_sigma.to(dev))
    moved = (out[0].pos - ref[0].pos[sl]).abs().max(dim=-1).values > 1e-5
    res = dict(
        rank=mesh.rank, world=world, capacity=cap, offset=local.offset,
        tiers=[aux["tier_like"], aux["tier_beam"]],
        ref_tiers=[raux["tier_like"], raux["tier_beam"]],
        finite=bool(all(torch.isfinite(aux[k]).all() for k in
                        ("e_pos", "e_rot", "pub_pos", "pub_rot", "cov"))),
        e_pos_err=float((aux["e_pos"] - raux["e_pos"]).abs().max()),
        e_rot_err=float((aux["e_rot"] - raux["e_rot"]).abs().max()),
        pub_pos_err=float((aux["pub_pos"] - raux["pub_pos"]).abs().max()),
        cov_ok=bool(torch.allclose(aux["cov"], raux["cov"], rtol=1e-3,
                                   atol=1e-9)),
        weights_err=float((w_split - w_sliced).abs().max()
                          / w_sliced.max()),
        grouping_err=float((w_split - w_one).abs().max() / w_one.max()),
        entropy_equal=bool(torch.equal(entropy, aux["entropy"])),
        tail_ran=bool(aux["expanded"] or aux["points_not_found"]),
        resampled_equal=all(
            torch.equal(getattr(out[0], k), getattr(resampled, k)[sl])
            for k in ("pos", "rot", "odom_err_lin", "odom_err_ang", "prob")),
        resampled_moved=int(moved.sum()),
        state_equal=all(torch.equal(a, b[sl]) for a, b in
                        zip(out[0][:-1], ref[0][:-1])),
        n_active=int(out[0].n_active), **_flat(aux))
    return res


def case_state(mesh, dev, seed=1):
    """``shard_state`` round trip, and the split ``pf.expectation`` and
    ``pf.resample`` against one process (the JAX package's
    ``test_sharding`` cases)."""
    world = mesh.shape["particles"]
    cap = 512 * world
    g = torch.Generator().manual_seed(seed)
    full = st.init_diagonal(torch.randn((cap, 6), generator=g), cap, cap,
                            [0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [1.0] * 6)
    prob = torch.rand((cap,), generator=g)
    full = full._replace(prob=prob / prob.sum())
    full = st.ParticleState(*(x.to(dev) for x in full))
    local = shard_state(full, mesh)
    shard = mesh.particle_shard(local.state.capacity)
    sl = slice(local.offset, local.offset + local.state.capacity)
    roundtrip = all(torch.equal(a, b[sl]) for a, b in
                    zip(local.state[:-1], full[:-1]))
    m1, q1 = pf.expectation(full)
    m2, q2 = pf.expectation(local.state, shard)
    u0 = torch.rand((), generator=g).to(dev)
    normals = torch.randn((cap, 6), generator=g).to(dev)
    sigma = torch.full((6,), 0.1, device=dev)
    r1 = pf.resample(full, u0, normals, sigma)
    r2 = pf.resample(local.state, u0, normals[sl], sigma, shard)
    n = 3 * cap // 4
    z1 = pf.resize(full, n)
    z2 = pf.resize(local.state, n, shard)
    best1 = pf.max_particle(full)
    best2 = pf.max_particle(local.state, shard)
    return dict(
        rank=mesh.rank, roundtrip=roundtrip,
        mean_err=float(max((m1 - m2).abs().max(), (q1 - q2).abs().max())),
        resample_err=float((r1.pos[sl] - r2.pos).abs().max()),
        resample_prob_equal=bool(torch.equal(r1.prob[sl], r2.prob)),
        resize_err=float((z1.pos[sl] - z2.pos).abs().max()),
        resize_prob_equal=bool(torch.equal(z1.prob[sl], z2.prob)),
        best_equal=all(torch.equal(best1[k], best2[k]) for k in best1))


def case_mesh(mesh, dev):
    """Mesh shapes after JAX's ``test_mesh_axes``, and the refusals."""
    world = dist.get_world_size()
    m2 = make_mesh(world, robots=2, device=dev)
    errors = []
    for bad in (dict(n_devices=world, robots=3), dict(n_devices=world + 1)):
        try:
            make_mesh(**bad, device=dev)
            errors.append(None)
        except ValueError as exc:
            errors.append(str(exc))
    return dict(rank=mesh.rank, axis_names=list(mesh.axis_names),
                shape=list(mesh.devices.shape),
                index=[mesh.robot_index, mesh.particle_index],
                shape2=list(m2.devices.shape),
                index2=[m2.robot_index, m2.particle_index], errors=errors)


def case_robots(mesh, dev, robots_per_rank=2, seed=0):
    """The robots split (``make_mesh(world, robots=world)``) of the grouped
    fleet against the one-process fleet on the whole fleet, each robot
    drawing from its own generator: this rank's robots compared."""
    world = dist.get_world_size()
    rmesh = make_mesh(world, robots=world, device=dev)
    n_robots = robots_per_rank * world
    eng = tfleet.engine(PER_RANK, dev, **SMALL)
    scan = worlds.scan(np.random.default_rng(seed), CLOUD_POINTS)
    args = tfleet.apart(tfleet.inputs(eng, n_robots, scan), 0.5)
    ref = fleet_filter_step_grouped(eng)(*args)       # this process alone
    local = shard_state(args[0], rmesh, batched=True)
    local_args = [local.state, args[1], args[2],
                  *(robots_slice(a, rmesh) for a in args[3:])]
    out = fleet_filter_step_grouped(eng, rmesh)(*local_args)
    sl = slice(local.robot_offset, local.robot_offset + robots_per_rank)
    equal = all(torch.equal(a, b[sl]) for a, b in zip(out[0], ref[0]))
    equal &= all(torch.equal(out[5][k], ref[5][k][sl]) for k in out[5])
    return dict(rank=rmesh.rank, robot_offset=local.robot_offset,
                equal=bool(equal), tiers=out[5]["tier_like"].tolist()
                + out[5]["tier_beam"].tolist(),
                pub_pos=out[5]["pub_pos"].cpu().numpy().tolist())


CASES = {"step": case_step, "state": case_state, "mesh": case_mesh,
         "robots": case_robots}


def time_split(eng, scan, mesh, iters=5):
    """The split step against the plain step on the engine's state, the
    same draws, in turns (plain, split, split, plain, ...): ``(plain ms,
    split ms, equal)``, ``equal`` whether every output is bit-equal (a
    world of 1)."""
    args = step_args(eng, scan)
    cap = eng.pstate.capacity
    draws = eng.draw_step(*eng.keeps(args[2], args[4]), capacity=cap)
    split = sharded_filter_step(eng, mesh)
    local = shard_state(eng.pstate, mesh).state
    runs = {"plain": lambda: eng._measurement_step(eng.pstate, *args, draws),
            "split": lambda: split(local, *args, draws)}
    outs = {k: f() for k, f in runs.items()}
    equal = outputs_equal(outs["plain"], outs["split"])
    times = {"plain": [], "split": []}
    for i in range(iters):
        for k in (("plain", "split") if i % 2 == 0 else ("split", "plain")):
            _sync(eng.device)
            t0 = time.perf_counter()
            runs[k]()
            _sync(eng.device)
            times[k].append((time.perf_counter() - t0) * 1e3)
    return (statistics.median(times["plain"]),
            statistics.median(times["split"]), equal, outs["split"][5])


def outputs_equal(a, b):
    """Whether two steps' outputs are equal, every tensor bit for bit."""
    def eq(x, y):
        if isinstance(x, torch.Tensor):
            return torch.equal(x, y)
        if isinstance(x, tuple):
            return all(eq(u, v) for u, v in zip(x, y))
        if isinstance(x, dict):
            return all(eq(x[k], y[k]) for k in x)
        return x == y
    return eq(tuple(a), tuple(b))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _init(rank, world, init_file, backend):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)


def _entry(rank, case, world, tmp, backend, device, kw):
    """One spawned rank: join the group, run ``case``, write its result."""
    torch.set_num_threads(1)
    _init(rank, world, os.path.join(tmp, "store"), backend)
    try:
        mesh = make_mesh(device=device)
        res = CASES[case](mesh, mesh.device, **kw)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(case: str, world: int, tmp, backend="gloo", device="cpu",
          timeout=60.0, **kw):
    """Run ``CASES[case]`` on ``world`` spawned ranks; every rank's result
    in rank order.  Raises ``TimeoutError`` (after killing the ranks) when
    they are not done within ``timeout`` seconds."""
    import torch.multiprocessing as mp

    tmp = str(tmp)
    ctx = mp.spawn(_entry, args=(case, world, tmp, backend, device, kw),
                   nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{case} on {world} ranks: not done in "
                               f"{timeout} s")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def check(res, tol=1e-5):
    """The failed checks of one rank's ``case_step`` result."""
    bad = []
    if not res["finite"]:
        bad.append("non-finite output")
    if res["tiers"] != [0, 0]:
        bad.append(f"tiers {res['tiers']}")
    for k in ("e_pos_err", "e_rot_err"):
        if not res[k] <= tol:
            bad.append(f"{k} {res[k]}")
    if not res["weights_err"] <= WEIGHTS_RTOL:
        bad.append(f"weights_err {res['weights_err']}")
    if not res["cov_ok"]:
        bad.append("cov")
    if not res["entropy_equal"]:
        bad.append("the recomputed weights are not the step's")
    if res["tail_ran"]:
        bad.append("expansion resetting or the empty-scan guard ran: the "
                   "resampled slice cannot be compared")
    elif not res["resampled_equal"]:
        bad.append("the resampled slice differs from one-process "
                   "pf.resample on the split's weights")
    if res["world"] == 1 and not res["state_equal"]:
        bad.append("a world of 1 differs from the one-process step")
    return bad


def _rank_main(a, rank, world, dev_name):
    mesh = make_mesh(device=dev_name)
    dev = mesh.device
    res = case_step(mesh, dev, a.particles)
    bad = check(res)
    rows = [None] * world
    dist.all_gather_object(rows, dict(res, failed=bad))
    line = dict(world=world, backend=a.backend, capacity=res["capacity"],
                per_rank=[dict(rank=r["rank"], tiers=r["tiers"],
                               e_pos_err=r["e_pos_err"],
                               weights_err=r["weights_err"],
                               grouping_err=r["grouping_err"],
                               resampled_equal=r["resampled_equal"],
                               resampled_moved=r["resampled_moved"],
                               failed=r["failed"]) for r in rows],
                ok=all(not r["failed"] for r in rows), device=card(dev))
    # the shipped settings (96 + 3 points, 1024-point scan), timed
    eng = tfleet.engine(res["capacity"], dev)
    scan = worlds.scan(np.random.default_rng(1), tfleet.CLOUD_POINTS)
    plain, split, equal, aux = time_split(eng, scan, mesh, a.iters)
    line.update(timed_particles=eng.pstate.capacity, plain_ms=plain,
                split_ms=split, split_equal=equal,
                split_tiers=[aux["tier_like"], aux["tier_beam"]])
    if world == 1:
        line["ok"] = line["ok"] and equal
    if rank == 0:
        print(json.dumps(line), flush=True)
    return line["ok"]


def _spawned(rank, world, tmp, a, dev_name):
    if a.cpu:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * world)))
    _init(rank, world, os.path.join(tmp, "store"), a.backend)
    try:
        ok = _rank_main(a, rank, world, dev_name)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if not ok:
        raise SystemExit(1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="nccl", choices=("gloo", "nccl"))
    ap.add_argument("--world", type=int, default=None,
                    help="ranks to spawn (default: torchrun's, else 1)")
    ap.add_argument("--particles", type=int, default=None,
                    help="whole capacity (default 1024 a rank)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)
    dev_name = "cpu" if a.cpu else None
    if "RANK" in os.environ:            # under torchrun
        dist.init_process_group(a.backend)
        try:
            ok = _rank_main(a, dist.get_rank(), dist.get_world_size(),
                            dev_name)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        return 0 if ok else 1
    import torch.multiprocessing as mp

    world = a.world or 1
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_spawned, args=(world, tmp, a, dev_name), nprocs=world)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
