"""The odometry prediction and the IMU weigh through ``predict_graph.py``,
on the CPU: every call eager and bit-equal to ``PerCopy`` (each input moved
to the device by its own copy, then the chain); with the graphs emulated (a capture runs the chain once and keeps
its outputs, a replay runs it again into them) the card's route: one
warm-up, one capture and replays from then on a key, the static buffers,
the packed host inputs, the outputs copied out; the graphs kept across
``drop_step_graphs``, re-seeds and resizes; the route counters and
capture spans; and ``imu_gravity_likelihood`` copying nothing from the
host after its first call.

The same drive on the card, graphed against eager bit for bit:
``tests/test_torch_predict_graph_gpu.py``.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mcl_3dl_tpu_torch import MCL3DL, Params, pf, predict_graph, step_graph
from mcl_3dl_tpu_torch.math import quat_np as mqn
from mcl_3dl_tpu_torch.models.imu_gravity import imu_gravity_likelihood
from mcl_3dl_tpu_torch.models.motion import (OdomDelta,
                                             predict_differential_drive)
from mcl_3dl_tpu_torch.profiling import spans

torch.set_num_threads(2)   # several test workers share the CPU

FIELDS = ("pos", "rot", "prob", "odom_err_lin", "odom_err_ang")
COV = np.diag([0.3, 0.3, 0.01, 0.01, 0.01, 0.2])


def drive(n_odom=60, n_imu=120, seed=0):
    """``(t, kind, a, b)`` messages in stamp order: odometry at 50 Hz
    along an arc with some wobble, the IMU at 100 Hz (gravity tilted by a
    little noise)."""
    rng = np.random.default_rng(seed)
    msgs = []
    for k in range(n_odom):
        t = 0.02 * k
        yaw = 0.4 * t + 0.01 * rng.normal()
        pos = np.array([0.5 * np.sin(0.4 * t), 0.5 * (1 - np.cos(0.4 * t)),
                        0.01 * rng.normal()], np.float32)
        msgs.append((t, "odom", pos, mqn.from_rpy(np.array([0.0, 0.0, yaw]))))
    for k in range(n_imu):
        t = 0.01 * k
        acc = np.array([0.3, -0.2, 9.8], np.float32) + rng.normal(
            0.0, 0.2, 3).astype(np.float32)
        msgs.append((t, "imu", acc, mqn.from_rpy(np.array([0.0, 0.0, 0.0]))))
    return sorted(msgs, key=lambda m: (m[0], m[1]))


def engine(n=64, engine_cls=MCL3DL, device="cpu"):
    """An engine whose particles carry odometry noise (the state's noise
    columns start at zero, and a step redraws them)."""
    eng = engine_cls(Params(num_particles=n, seed=3), device=device)
    gen = torch.Generator()
    gen.manual_seed(11)
    eng.pstate = eng.pstate._replace(noise=0.1 * torch.randn(
        eng.pstate.noise.shape, generator=gen).to(device))
    return eng


def feed(eng, msgs, reseed_at=None):
    for i, (t, kind, a, b) in enumerate(msgs):
        if i == reseed_at:
            eng.initial_pose(np.array([0.1, 0.0, 0.0]),
                             np.array([0.0, 0.0, 0.0, 1.0]), COV)
        if kind == "odom":
            eng.odometry(a, b, t)
        else:
            eng.imu(a, b, t)


def calls(msgs):
    """How many predicts and weighs the drive makes (``dt > 0.05``)."""
    n, last = 0, {}
    for t, kind, _, _ in msgs:
        if kind in last and t - last[kind] > 0.05:
            n += 1
            last[kind] = t
        last.setdefault(kind, t)
    return n


def equal_states(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


class PerCopy(MCL3DL):
    """The reference the chains are held to: the engine's odometry and
    IMU with every input moved to the device by its own copy, then the
    chain, eagerly."""

    def _odometry(self, pos, rot, t):
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
            delta = OdomDelta(*(x.to(self.device) for x in OdomDelta.from_poses(
                self.odom_prev_pos, self.odom_prev_rot, pos, rot, dt)))
            self.pstate = predict_differential_drive(
                self.pstate, delta, p.odom_err_integ_lin_tc,
                p.odom_err_integ_ang_tc)
            self.odom_last = t
            self.odom_prev_pos, self.odom_prev_rot = pos, rot

    def _imu(self, acc, orientation, t):
        from mcl_3dl_tpu_torch.math import filters as mf
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
            acc_measure = (acc_f / torch.linalg.vector_norm(acc_f)).to(
                self.device)
            lik = imu_gravity_likelihood(self.pstate.rot, acc_measure,
                                         self.params.acc_var)
            self.pstate, _ = pf.measure(self.pstate, lik)
            self.imu_last = t


class _Replay:
    """An emulated graph: ``replay`` runs ``fn`` again and copies its
    results into the outputs kept at capture."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out
        self.replays = 0

    def replay(self):
        self.replays += 1
        for d, s in zip(self.out, self.fn(), strict=True):
            d.copy_(s)


@pytest.fixture
def emulated(monkeypatch):
    """Graphs emulated on the CPU; returns the list of captures made."""
    made = []

    def capture(fn, pool):
        out = fn()
        made.append(_Replay(fn, out))
        return made[-1], out

    monkeypatch.setattr(step_graph, "enabled", lambda device: True)
    monkeypatch.setattr(step_graph, "new_pool", lambda device: None)
    monkeypatch.setattr(step_graph, "capture", capture)
    return made


@pytest.fixture
def traced(monkeypatch):
    monkeypatch.setattr(spans, "enabled", True)
    spans.clear()
    yield spans
    spans.clear()


def test_cpu_calls_are_eager_and_equal_the_reference():
    msgs = drive()
    eng, ref = engine(), engine(engine_cls=PerCopy)
    feed(eng, msgs)
    feed(ref, msgs)
    assert equal_states(eng.pstate, ref.pstate)
    assert eng.predict_routes == {"graph": 0, "warm_up": 0,
                                  "eager": calls(msgs)}
    assert eng._predict_graphs == {}


def test_cpu_calls_equal_the_reference_across_a_reseed():
    msgs = drive(seed=1)
    eng, ref = engine(), engine(engine_cls=PerCopy)
    feed(eng, msgs, reseed_at=90)
    feed(ref, msgs, reseed_at=90)
    assert equal_states(eng.pstate, ref.pstate)


@pytest.mark.parametrize("n", [64, 1000])
def test_emulated_graphs_equal_eager(emulated, n):
    msgs = drive()
    eng, eager = engine(n), engine(n, PerCopy)
    feed(eng, msgs)
    feed(eager, msgs)
    assert equal_states(eng.pstate, eager.pstate)
    total = calls(msgs)
    assert eng.predict_routes == {"graph": total - 2, "warm_up": 2,
                                  "eager": 0}
    # one graph a chain, each captured once and replayed on every later
    # call
    assert len(emulated) == 2 and len(eng._predict_graphs) == 2
    assert sum(g.replays for g in emulated) == total - 2


def test_graphs_survive_drop_reseed_and_return_to_a_capacity(emulated):
    msgs = drive(seed=2)
    eng, eager = engine(), engine(engine_cls=PerCopy)
    feed(eng, msgs[:60])
    feed(eager, msgs[:60])
    kept = dict(eng._predict_graphs)
    assert len(kept) == 2
    eng.drop_step_graphs()
    assert eng._predict_graphs == kept
    for e in (eng, eager):
        e.initial_pose(np.array([0.2, 0.1, 0.0]),
                       np.array([0.0, 0.0, 0.0, 1.0]), COV)
        e.resize_particles(200)          # capacity 64 -> 256
    feed(eng, msgs[60:120])
    feed(eager, msgs[60:120])
    assert eng.pstate.capacity == 256 and len(eng._predict_graphs) == 4
    for e in (eng, eager):
        e.resize_particles(64)           # back to 64: its graphs replay
    feed(eng, msgs[120:])
    feed(eager, msgs[120:])
    assert equal_states(eng.pstate, eager.pstate)
    assert len(emulated) == 4            # each key captured once
    assert all(eng._predict_graphs[k] is kept[k] for k in kept)


def test_route_counters_and_capture_spans(emulated, traced):
    msgs = drive()
    eng = engine()
    feed(eng, msgs)
    recs = traced.records()
    by_id = {r.id: r for r in recs}
    chains = [r for r in recs if r.value is None
              and r.name in ("odometry.predict", "imu.weigh")]
    routes = [r for r in recs if r.value is not None
              and r.name.startswith("predict.")]
    assert len(chains) == calls(msgs) == len(routes)
    # one route counter in each call's span, directly
    assert sorted(by_id[r.parent].id for r in routes) == sorted(
        r.id for r in chains)
    assert sum(r.name == "predict.graph" for r in routes) == len(chains) - 2
    assert sum(r.name == "predict.warm_up" for r in routes) == 2
    caps = [r for r in recs if r.name in ("odometry.capture", "imu.capture")]
    assert sorted(r.name for r in caps) == ["imu.capture",
                                            "odometry.capture"]
    assert {by_id[r.parent].name for r in caps} == {"odometry.predict",
                                                    "imu.weigh"}


def test_route_counters_on_the_cpu(traced):
    msgs = drive()
    eng = engine()
    feed(eng, msgs)
    routes = [r.name for r in traced.records() if r.value is not None
              and r.name.startswith("predict.")]
    assert routes == ["predict.eager"] * calls(msgs)


def test_staged_inputs_unpack_to_the_host_values():
    delta = OdomDelta.from_poses(
        np.zeros(3, np.float32), np.array([0, 0, 0, 1], np.float32),
        np.array([0.3, 0.1, 0.0], np.float32),
        mqn.from_rpy(np.array([0.0, 0.0, 0.2])), 0.06)
    staged = predict_graph.stage(delta, "cpu")
    assert staged.shape == (10,) and not staged.is_pinned()
    back = predict_graph.unpack(staged, delta)
    for a, b in zip(back, delta, strict=True):
        assert a.shape == b.shape and torch.equal(a, b)


def test_batched_copy_groups_dtypes():
    src = [torch.arange(6.0).reshape(2, 3), torch.tensor(5, dtype=torch.int32),
           torch.ones(4)]
    dst = [torch.empty_like(s) for s in src]
    predict_graph.batched_copy(dst, src)
    assert all(torch.equal(d, s) for d, s in zip(dst, src))


class _Lifts(TorchDispatchMode):
    """Counts tensors built from host values (``torch.tensor``,
    ``torch.as_tensor`` of Python data: ``aten.lift_fresh``) and copies
    between devices."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if "lift_fresh" in name or "_to_copy" in name:
            self.ops.append(name)
        return func(*args, **(kwargs or {}))


def test_imu_likelihood_copies_nothing_from_the_host_after_its_first_call():
    rot = torch.nn.functional.normalize(torch.randn(
        32, 4, generator=torch.Generator().manual_seed(0)), dim=-1)
    acc = torch.tensor([0.05, -0.02, 1.0]) / torch.linalg.vector_norm(
        torch.tensor([0.05, -0.02, 1.0]))
    first = imu_gravity_likelihood(rot, acc, 0.7)
    with _Lifts() as mode:
        again = imu_gravity_likelihood(rot, acc, 0.7)
    assert mode.ops == []
    assert torch.equal(first, again)


def test_benchmark_reader_over_the_program_records(emulated, traced,
                                                   monkeypatch):
    """``predict_graph_share`` over this drive's own records: every call
    but the two warm-ups replayed; on the CPU's eager route, 0."""
    from benchmark import harness, program_spans

    msgs = drive()
    total = calls(msgs)
    read = harness.metric_reader("predict_graph_share")
    feed(engine(), msgs)
    recs = traced.records()
    monkeypatch.setattr(program_spans, "window", lambda trace: (recs, 1))
    assert read({}) == pytest.approx(100.0 * (total - 2) / total)
    traced.clear()
    monkeypatch.setattr(step_graph, "enabled", lambda device: False)
    feed(engine(), msgs)
    recs = traced.records()
    assert read({}) == 0.0
