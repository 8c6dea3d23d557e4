"""The two closed loops that drive the program, and what they record.

Each takes the messages its mix's drive made (``drives/``).

``single``: one robot.  Each message of the lap is handed to the engine
as soon as the last call returned: odometry (``MCL3DL.odometry``), IMU
(``MCL3DL.imu``), re-seeds (``MCL3DL.initial_pose``), global
localization (``MCL3DL.global_localization``) and scans
(``MCL3DL.push_cloud``, under the cloud's frame id), in stamp order, the
lap looped.  An update is a ``push_cloud`` that steps the filter (a push
that only accumulates its cloud is none) and returns a result; its
latency is the host time of the call (the call returns with the pose on
the host).  The clouds a step folds in are every cloud accumulated since
the last step, as the engine's cloud accumulation hands them over.

``fleet``: every robot at once through ``parallel.fleet_filter_step_
grouped``, one fleet step a scan period on the robots' scan banks, each
robot's outputs fed into its next step.  An update is one robot's slice
of a step's outputs; a step ends when the device has finished it.

Both warm up on the mix's own messages first (every graph captured),
then measure for the window: it ends at the end of the first update
that finishes after ``seconds``.  For the comparison they keep, for a
sample of updates drawn from the seed, the program's state before the
step (particles, output filters, previous pose, the random generator's
state), the inputs the benchmark sent, and the answer.
"""

from __future__ import annotations

import inspect
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark import traffic as tr
from benchmark.tracing import Spans, profile, reduce, wrap

STATE_FIELDS = ("pos", "rot", "prob", "odom_err_lin", "n_active")


@dataclass
class Run:
    attempted: int = 0
    failed: int = 0
    updates: int = 0
    window_s: float = 0.0
    setup_s: float = 0.0
    latencies: list = field(default_factory=list)
    records: list = field(default_factory=list)
    routes: dict = field(default_factory=dict)
    steps: int = 0
    steps_00: int = 0
    spans: dict = field(default_factory=dict)
    scans: int = 0
    prof: dict = None
    memory_peak_bytes: int = 0


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _params(cfg, seed):
    from mcl_3dl_tpu_torch import Params
    return Params(seed=seed, **cfg["params"])


def _filter(f):
    return tuple(t.clone() for t in f)


def _routes(eng, before):
    return {k: v - before.get(k, 0) for k, v in eng.step_routes.items()}


def _result(res) -> dict:
    return dict(raw_pos=np.asarray(res.raw_pos, np.float64),
                raw_rot=np.asarray(res.raw_rot, np.float64),
                pos=np.asarray(res.pos, np.float64),
                rot=np.asarray(res.rot, np.float64),
                cov=np.asarray(res.cov, np.float64),
                entropy=float(res.entropy))


def _finite(res) -> bool:
    return res is not None and all(
        np.isfinite(np.asarray(v)).all() for v in (res.pos, res.rot, res.cov))


def single(cfg, mix, lap, seed, seconds, traced, device, t_start) -> Run:
    """One robot's closed loop through ``push_cloud`` over ``lap``
    (``traffic.Lap``), looped."""
    from mcl_3dl_tpu_torch import MCL3DL

    dev = torch.device(device)
    run = Run()
    spans = Spans(lambda: _sync(dev))
    eng = MCL3DL(_params(cfg, seed), device=dev)
    world = tr.world_map()
    eng.load_map(world)
    x0, y0, yaw0 = lap.truth[0]
    eng.initial_pose(np.array([x0, y0, 0.0]), tr.yaw_quat(yaw0),
                     np.diag(mix["start_cov"]))
    check_at = set(np.random.default_rng([seed, 2]).choice(
        cfg["check"]["from_first"], cfg["check"]["scans"], replace=False)
        .tolist())
    reseed_cov = np.diag(mix.get("reseed_cov", mix["start_cov"]))
    # "clouds": (points, origin, odometry) of each cloud accumulated since
    # the last step; "folded": the clouds the last push stepped on, or None
    held = {"odom": None, "clouds": [], "folded": None}
    push = eng.accum.push

    def observed(key, msg, process, accumulate, clear):
        def acc(m):
            kept = accumulate(m)
            if kept:
                held["clouds"].append((m[0], m[1], held["odom"]))
            return kept

        def clr():
            clear()
            held["clouds"] = []

        def proc():
            held["folded"] = list(held["clouds"])
            process()

        push(key, msg, proc, acc, clr)

    eng.accum.push = observed
    if traced:
        wrap(eng, "_step", spans, "_step")

    def stream():
        lap_i = 0
        while True:
            for m in lap.messages:
                yield m, m.t + lap_i * lap.duration
            lap_i += 1

    msgs = stream()

    def feed(msg, t):
        if msg.kind == "odom":
            with spans.span("odometry", sync=traced):
                eng.odometry(msg.a, msg.b, t)
            held["odom"] = (np.asarray(msg.a, np.float32),
                            np.asarray(msg.b, np.float32))
        elif msg.kind == "imu":
            with spans.span("imu", sync=traced):
                eng.imu(msg.a, msg.b, t)
        elif msg.kind == "reseed":
            with spans.span("initial_pose", sync=traced):
                eng.initial_pose(msg.a, msg.b, reseed_cov)
        elif msg.kind == "global":
            with spans.span("global_localization", sync=traced):
                eng.global_localization()

    def scan(msg, t, record=None):
        """Push one cloud; ``(result, seconds, whether it stepped)``."""
        if record is not None:
            s = eng.pstate
            record.update(
                state={k: getattr(s, k).clone() for k in STATE_FIELDS},
                gen_state=eng._gen.get_state(), f_pos=_filter(eng.f_pos),
                f_ang=_filter(eng.f_ang),
                prev_pos=eng.state_prev_pos.clone(),
                prev_rot=eng.state_prev_rot.clone())
        held["folded"] = None
        with spans.span("push_cloud"):
            t0 = time.perf_counter()
            res = eng.push_cloud(msg.frame, msg.a, msg.b, t)
            dt = time.perf_counter() - t0
        if res is not None and record is not None:
            record.update(result=_result(res), cloud=held["folded"],
                          tier_beam=int(eng.last_aux["tier_beam"]),
                          post_noise=eng.pstate.noise.clone())
        return res, dt, held["folded"] is not None

    def until(n_scans, window=None, on_scan=None):
        done = 0
        while done < n_scans:
            msg, t = next(msgs)
            if msg.kind != "cloud":
                feed(msg, t)
                continue
            out = (on_scan or scan)(msg, t)
            done += 1
            # the window ends with an update (``timed`` says whether the
            # push stepped), never on a push that only accumulated
            if (window is not None and out
                    and time.perf_counter() - window >= seconds):
                break

    until(mix["warmup_scans"])
    _sync(dev)
    for d in spans.durations.values():
        d.clear()
    before = dict(eng.step_routes)

    def timed(msg, t):
        k = run.attempted
        record = {} if k in check_at else None
        res, dt, stepped = scan(msg, t, record)
        if not stepped:
            return False
        run.attempted += 1
        run.latencies.append(dt)
        if not _finite(res):
            run.failed += 1
        else:
            run.updates += 1
            aux = eng.last_aux
            run.steps += 1
            run.steps_00 += int(aux["tier_like"] == 0 and aux["tier_beam"] == 0)
        if record is not None and "result" in record:
            run.records.append(record)
        return True

    t_win = time.perf_counter()
    run.setup_s = t_win - t_start
    until(10 ** 9, window=t_win, on_scan=timed)
    run.window_s = time.perf_counter() - t_win
    run.scans = run.attempted
    run.routes = _routes(eng, before)
    run.spans = {k: list(v) for k, v in spans.durations.items()}
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    if traced and dev.type == "cuda":
        spans.ranges = True
        n = cfg["profile"]["scans"]
        run.prof = reduce(*profile(lambda: until(n), lambda: _sync(dev)))
    return run


def fleet(cfg, mix, fl, seed, seconds, traced, device, t_start) -> Run:
    """The fleet's closed loop through ``fleet_filter_step_grouped`` over
    ``fl`` (``traffic.Fleet``)."""
    from mcl_3dl_tpu_torch import MCL3DL
    from mcl_3dl_tpu_torch.math import filters as mf
    from mcl_3dl_tpu_torch.parallel import fleet_filter_step_grouped
    from mcl_3dl_tpu_torch.state import ParticleState

    dev = torch.device(device)
    run = Run()
    spans = Spans(lambda: _sync(dev))
    params = _params(cfg, seed)
    n = params.num_particles
    eng = MCL3DL(params, capacity=n, device=dev)
    eng.load_map(tr.world_map())
    robots = fl.poses.shape[0]
    cov = np.diag(mix["start_cov"])
    rows = []
    for x, y, yaw in fl.poses:
        eng.initial_pose(np.array([x, y, 0.0]), tr.yaw_quat(yaw), cov)
        rows.append(eng.pstate)
    state = ParticleState(*(torch.stack([r[i] for r in rows])
                            for i in range(len(rows[0]))))
    del rows
    f32 = dict(dtype=torch.float32, device=dev)
    pose = torch.as_tensor(fl.poses, **f32)
    zero = torch.zeros(robots, **f32)
    prev_pos = torch.stack([pose[:, 0], pose[:, 1], zero], -1)
    prev_rot = torch.as_tensor(tr.yaw_quat(fl.poses[:, 2]), **f32)

    def tiled(f, out0):
        f = mf.FilterState(*(t.unsqueeze(0).expand((robots,) + tuple(t.shape))
                             .contiguous() for t in f))
        return mf.filter_set(f, out0)

    f_pos = tiled(eng.f_pos, prev_pos)
    f_ang = tiled(eng.f_ang, torch.stack([zero, zero, pose[:, 2]], -1))
    bank = torch.as_tensor(fl.bank, device=dev)
    p = bank.shape[2]
    labels = torch.zeros((robots, p), dtype=torch.int64, device=dev)
    valid = torch.ones((robots, p), dtype=torch.bool, device=dev)
    origins = torch.tensor([[[0.0, 0.0, tr.SENSOR_Z]]], **f32).expand(
        robots, 1, 3).contiguous()
    odom_pos = torch.zeros((robots, 3), **f32)
    odom_rot = torch.tensor([0.0, 0.0, 0.0, 1.0], **f32).expand(
        robots, 4).contiguous()
    gfix = torch.zeros(robots, dtype=torch.bool, device=dev)
    step = fleet_filter_step_grouped(eng)
    draws = inspect.getclosurevars(step).nonlocals["draw"]
    carry = [state, f_pos, f_ang, prev_pos, prev_rot]
    check_rng = np.random.default_rng([seed, 2])
    base_origin = np.array([0.0, 0.0, tr.SENSOR_Z])
    base_odom = (np.zeros(3, np.float32),
                 np.array([0.0, 0.0, 0.0, 1.0], np.float32))

    def args(k, sl=slice(None)):
        st, fp, fa, pp, pr = carry
        return (ParticleState(*(t[sl] for t in st)), eng.map.df,
                eng.map.df_beam, bank[k % bank.shape[0]][sl], labels[sl],
                valid[sl], origins[sl], odom_pos[sl], odom_rot[sl], pp[sl],
                pr[sl], mf.FilterState(*(t[sl] for t in fp)),
                mf.FilterState(*(t[sl] for t in fa)), gfix[sl])

    def one(k):
        with spans.span("fleet_step", sync=True):
            out = step(*args(k))
        carry[:] = list(out[:5])
        return out[5]

    k = 0
    for _ in range(mix["warmup_steps"]):
        one(k)
        k += 1
    before = dict(eng.step_routes)
    spans.durations.clear()
    t_win = time.perf_counter()
    run.setup_s = t_win - t_start
    while True:
        sample = check_rng.choice(robots, cfg["check"]["robots"],
                                  replace=False).tolist()
        st, fp, fa, pp, pr = carry
        recs = [dict(robot=r, state={f: getattr(st, f)[r].clone()
                                     for f in STATE_FIELDS},
                     gen_state=draws.gens[r].get_state(),
                     f_pos=tuple(t[r].clone() for t in fp),
                     f_ang=tuple(t[r].clone() for t in fa),
                     prev_pos=pp[r].clone(), prev_rot=pr[r].clone(),
                     cloud=[(fl.bank[k % bank.shape[0], r], base_origin,
                             base_odom)]) for r in sample]
        aux = one(k)
        k += 1
        ok = (torch.isfinite(aux["pub_pos"]).all(-1)
              & torch.isfinite(aux["pub_rot"]).all(-1)
              & torch.isfinite(aux["cov"]).flatten(1).all(-1))
        at00 = (aux["tier_like"] == 0) & (aux["tier_beam"] == 0)
        n_ok, n00 = int(ok.sum()), int(at00.sum())
        run.attempted += robots
        run.failed += robots - n_ok
        run.updates += n_ok
        run.steps += robots
        run.steps_00 += n00
        host = {key: aux[key][sample].double().cpu().numpy()
                for key in ("e_pos", "e_rot", "pub_pos", "pub_rot", "cov",
                            "entropy")}
        tiers = aux["tier_beam"][sample].cpu().numpy()
        for i, rec in enumerate(recs):
            rec.update(result=dict(
                raw_pos=host["e_pos"][i], raw_rot=host["e_rot"][i],
                pos=host["pub_pos"][i], rot=host["pub_rot"][i],
                cov=host["cov"][i], entropy=float(host["entropy"][i])),
                tier_beam=int(tiers[i]),
                post_noise=carry[0].noise[rec["robot"]].clone())
        run.records += recs
        if time.perf_counter() - t_win >= seconds:
            break
    run.window_s = time.perf_counter() - t_win
    run.latencies = list(spans.durations["fleet_step"])
    run.scans = k - mix["warmup_steps"]
    run.routes = _routes(eng, before)
    run.spans = {key: list(v) for key, v in spans.durations.items()}
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    if traced and dev.type == "cuda":
        spans.ranges = True
        sl = slice(0, cfg["profile"]["robots"])

        def part():
            with spans.span("fleet_step"):
                step(*args(k, sl))

        run.prof = reduce(*profile(part, lambda: _sync(dev)))
    return run
