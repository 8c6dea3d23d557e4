"""The program's spans and counters (``profiling.spans``) where the port
opens them, on the CPU at a small size (1,024 particles, 16 likelihood
points), and the benchmark's readers of them (``benchmark/
program_spans.py`` and its metrics):

* one ``push_cloud`` yields the shell's and the step's spans nested
  under one request, ``MeasureResult.elapsed`` is its ``scan`` span, and
  a tracer that is off records nothing;
* with the graphs emulated (``test_torch_step_graph.py``'s emulation),
  the routes' spans: the warm-up, the captures inside the replays, the
  eager remainder with its box-path read, the copy out, and the graphs'
  drop counted by a re-seed;
* the fleet step is one request whose robots' spans carry their index;
* kernel K1's live-table count, made beside the likelihood path's K1
  launch, equals a brute count over K1's inputs, eager and with the
  graphs emulated, and is not made with the tracer off;
* the window rule for both loops, and the per-layer metrics, on
  synthetic records.
"""

import inspect
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcl_3dl_tpu_torch import (LikelihoodParams, MCL3DL, Params, profiling,
                               step_graph, worlds)
from mcl_3dl_tpu_torch.ops import grouped as og
from mcl_3dl_tpu_torch.parallel import fleet_filter_step_grouped
from mcl_3dl_tpu_torch.profiling import Record
from mcl_3dl_tpu_torch.tools import fleet as tfleet

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, program_spans  # noqa: E402

torch.set_num_threads(2)   # several test workers share the CPU

QUAT = np.array([0.0, 0.0, 0.0, 1.0])
TIGHT, WIDE = 1e-4, 1.0      # initial covariances: tier 0, and the box path
SHELL = {"scan.accumulate", "scan.transform", "scan.prepare",
         "scan.publish"}


@pytest.fixture
def tracer(monkeypatch):
    """The program's tracer, on and emptied."""
    spans = profiling.spans
    monkeypatch.setattr(spans, "enabled", True)
    spans.clear()
    yield spans
    spans.clear()


@pytest.fixture
def emulated(monkeypatch):
    """CUDA graphs emulated on the CPU: a capture runs the function once
    and keeps its outputs, a replay runs it again into them."""

    class Replay:
        def __init__(self, fn, out):
            self.fn, self.out = fn, out

        def replay(self):
            for d, s in zip(step_graph.leaves(self.out),
                            step_graph.leaves(self.fn()), strict=True):
                for dim in range(d.dim()):
                    if d.stride(dim) == 0 and d.shape[dim] > 1:
                        d, s = d.narrow(dim, 0, 1), s.narrow(dim, 0, 1)
                d.copy_(s)

    def capture(fn, pool):
        out = fn()
        return Replay(fn, out), out

    monkeypatch.setattr(step_graph, "enabled", lambda device: True)
    monkeypatch.setattr(step_graph, "new_pool", lambda device: None)
    monkeypatch.setattr(step_graph, "capture", capture)


def _engine(cov):
    eng = MCL3DL(Params(num_particles=1024, use_beam_model=False,
                        likelihood=LikelihoodParams(num_points=16)),
                 device="cpu")
    eng.load_map(worlds.world_map())
    eng.initial_pose(np.zeros(3), QUAT, np.diag([cov] * 6))
    eng.odometry(np.zeros(3), QUAT, 0.0)
    return eng


def _drive(eng, scans, rng=None):
    """Push ``scans`` clouds (the first only accumulates), odometry
    before each; the results."""
    rng = rng or np.random.default_rng(0)
    out = []
    for k in range(scans):
        t = 0.1 * (k + 1)
        eng.odometry(np.zeros(3), QUAT, t)
        out.append(eng.push_cloud("lidar", worlds.scan(rng, 256),
                                  np.zeros(3), t))
    return out


def _requests(recs, name):
    """Each request whose root is ``name``: its records by name."""
    ids = [r.request for r in recs if r.parent == 0 and r.name == name]
    out = []
    for i in ids:
        by = {}
        for r in recs:
            if r.request == i:
                by.setdefault(r.name, []).append(r)
        out.append(by)
    return out


def _inside(inner, outer):
    return outer.start <= inner.start and inner.end <= outer.end


def test_push_cloud_spans_nest_under_one_request(tracer):
    eng = _engine(TIGHT)
    results = _drive(eng, 2)
    assert results[0] is None and results[1] is not None
    scan_req = _requests(tracer.records(), "push_cloud")[1]
    assert set(scan_req) == SHELL | {"push_cloud", "scan", "read.aux",
                                     "step", "step.eager", "read.fits"}
    one = {k: v[0] for k, v in scan_req.items()}
    assert all(len(v) == 1 for v in scan_req.values())
    push, scan, step = one["push_cloud"], one["scan"], one["step"]
    for name in ("scan.accumulate", "scan.transform", "scan"):
        assert one[name].parent == push.id
    for name in ("scan.prepare", "step", "read.aux", "scan.publish"):
        assert one[name].parent == scan.id and _inside(one[name], scan)
    assert one["step.eager"].parent == step.id
    assert one["read.fits"].parent == one["step.eager"].id
    order = [one[n].start for n in ("scan.transform", "scan.prepare", "step",
                                    "read.aux", "scan.publish")]
    assert order == sorted(order)
    elapsed = results[1].elapsed
    assert 0.0 < elapsed <= (scan.end - scan.start) * 1e-9
    assert (scan.end - scan.start) * 1e-9 - elapsed < 0.01
    odom = _requests(tracer.records(), "odometry")
    assert [set(r) for r in odom] == [{"odometry"}] + [
        {"odometry", "odometry.predict"}] * 2   # the first sets the origin
    assert eng.step_routes["eager"] == 1


def test_trace_off_records_nothing_and_times_the_scan(tracer, monkeypatch):
    monkeypatch.setattr(tracer, "enabled", False)
    res = _drive(_engine(TIGHT), 2)[1]
    assert res.elapsed > 0.0
    assert tracer.records() == [] and tracer.summary() == []


def test_box_path_reads_are_counted(tracer):
    eng = _engine(WIDE)
    _drive(eng, 3)
    assert eng.last_aux["tier_like"] in (1, 2)
    reqs = _requests(tracer.records(), "push_cloud")[1:]
    for req in reqs:
        assert len(req["read.fits"]) == 1 and len(req["read.box"]) == 1
        assert _inside(req["read.box"][0], req["step.eager"][0])
    outer, inside = program_spans.steps(tracer.records())
    assert len(outer) == 2
    assert sum(r.name in program_spans.READS for r in inside) == 4


@pytest.mark.parametrize("cov,route", [(TIGHT, "graph"),
                                       (WIDE, "graph_front")])
def test_graph_routes_spans(tracer, emulated, cov, route):
    eng = _engine(cov)
    _drive(eng, 4)
    assert eng.step_routes == dict(graph=2 * (route == "graph"),
                                   graph_front=2 * (route == "graph_front"),
                                   warm_up=1, eager=0)
    warm, first, later = _requests(tracer.records(), "push_cloud")[1:]
    assert "step.load" not in warm and len(warm["read.fits"]) == 1
    assert _inside(warm["read.fits"][0], warm["step.warm_up"][0])
    for req in (first, later):
        assert {"step.draws", "step.load", "step.replay_a", "read.fits",
                "step.copy_out"} <= set(req)
        assert "step.warm_up" not in req
    cap_a = first["step.capture_a"][0]
    assert cap_a.parent == first["step.replay_a"][0].id
    assert "step.capture_a" not in later
    if route == "graph":
        assert first["step.capture_b"][0].parent == \
            first["step.replay_b"][0].id
        assert "step.capture_b" not in later and "step.replay_b" in later
        assert "read.box" not in later
    else:
        assert "step.replay_b" not in later
        assert later["read.box"][0].parent == later["step.remainder"][0].id
    assert "graph.alloc_retries" not in tracer.counters   # not a card
    eng.initial_pose(np.zeros(3), QUAT, np.diag([cov] * 6))
    drop = _requests(tracer.records(), "initial_pose")[-1]["graph.drops"]
    assert [r.value for r in drop] == [1]
    eng.initial_pose(np.zeros(3), QUAT, np.diag([cov] * 6))
    assert "graph.drops" not in _requests(tracer.records(),
                                          "initial_pose")[-1]


def test_fleet_step_is_one_request_with_robots(tracer):
    eng = tfleet.engine(1024, "cpu", like_points=16,
                        cov=np.diag([WIDE] * 6))
    rng = np.random.default_rng(3)
    args = tfleet.inputs(eng, 2, worlds.scan(rng, 256))
    step = fleet_filter_step_grouped(eng)
    assert callable(inspect.getclosurevars(step).nonlocals["draw"])
    tracer.clear()
    step(*args)
    recs = tracer.records()
    (req,) = _requests(recs, "fleet_step")
    assert {r.request for r in recs} == {req["fleet_step"][0].request}
    assert [r.robot for r in req["fleet.draws"]] == [0, 1]
    assert sorted(r.robot for r in req["step"]) == [0, 1]
    assert req["fleet.stack"][0].robot is None
    assert all(r.robot in (0, 1) for r in recs
               if r.name not in ("fleet_step", "fleet.stack"))
    host_s, n = program_spans.step_host_seconds(recs)
    assert n == 2 and 0.0 < host_s
    named = program_spans.seconds(recs, ("fleet.draws", "step",
                                         "fleet.stack"))
    whole = program_spans.seconds(recs, ("fleet_step",))
    assert named <= whole


def _spy_k1(monkeypatch):
    """K1's inputs at each call of its plain version, the CPU's K1 (the
    wrapper delegates to it): a list of ``(tile_group, skipw)``."""
    seen = []
    plain = og.like_score_plain

    def spy(gp_A, tile_group, meta, pts_fp, skipw, tables, **kw):
        seen.append((tile_group.clone(), skipw.clone()))
        return plain(gp_A, tile_group, meta, pts_fp, skipw, tables, **kw)

    monkeypatch.setattr(og, "like_score_plain", spy)
    monkeypatch.setattr(og.grouped_like_score, "live_tables", None)
    return seen


def _brute(tile_group, skipw):
    held = set(tile_group.tolist())
    return sum(int(skipw[k, g]) != og.SKIP_ALL
               for k in range(skipw.shape[0]) for g in held)


def test_k1_live_tables_equal_a_brute_count(tracer, monkeypatch):
    """The likelihood path counts each K1 launch's live tables beside it
    (``grouped_like_apply``): the counter equals a brute count over the
    inputs K1 was given."""
    seen = _spy_k1(monkeypatch)
    eng = _engine(TIGHT)
    _drive(eng, 3)
    assert eng.last_aux["tier_like"] == 0 and len(seen) == 2
    for tile_group, skipw in seen:
        live = og.live_tables(tile_group, skipw)
        assert live.dtype == torch.int64 and live.dim() == 0
        assert int(live) == _brute(tile_group, skipw)
        assert 0 < int(live) <= skipw.numel()
    counter = og.grouped_like_score.live_tables
    assert counter.dtype == torch.int64 and counter.dim() == 0
    assert int(counter) == sum(_brute(t, s) for t, s in seen)


def test_k1_live_tables_count_each_replay(tracer, emulated, monkeypatch):
    """With the graphs emulated, every run of the graphed likelihood (the
    capture's and each replay's) adds its launch's tables."""
    seen = _spy_k1(monkeypatch)
    eng = _engine(TIGHT)
    _drive(eng, 4)
    assert eng.step_routes["graph"] == 2 and len(seen) > 3
    assert int(og.grouped_like_score.live_tables) == sum(
        _brute(t, s) for t, s in seen)


def test_k1_live_tables_not_counted_with_the_tracer_off(tracer,
                                                         monkeypatch):
    seen = _spy_k1(monkeypatch)
    monkeypatch.setattr(tracer, "enabled", False)
    _drive(_engine(TIGHT), 3)
    assert len(seen) == 2 and og.grouped_like_score.live_tables is None


def _single_run(spans, warm, window, profiled):
    """A one-robot run's requests: warm-up scans, window scans and
    profiled scans, each after an odometry and an IMU call."""
    marks = {}
    for phase, n in (("warm", warm), ("window", window),
                     ("profiled", profiled)):
        for _ in range(n):
            for name in ("odometry", "imu"):
                with spans.request(name):
                    pass
            with spans.request("push_cloud"):
                with spans.span("scan.prepare"):
                    pass
            marks.setdefault(phase, []).append(spans._requests)
    return spans.records(), marks


def test_window_rule_single():
    spans = profiling.Spans(enabled=True)
    recs, marks = _single_run(spans, 3, 4, 2)
    recs_w, scans = program_spans.single_window(recs, 4, 2)
    assert scans == 4
    ids = {r.request for r in recs_w}
    assert min(ids) == marks["warm"][-1] + 1
    assert max(ids) == marks["window"][-1]
    assert sum(r.name == "push_cloud" for r in recs_w) == 4
    assert sum(r.name == "odometry" for r in recs_w) == 4
    everything, _ = program_spans.single_window(recs, 9, 0)
    assert len({r.request for r in everything}) == 27
    assert program_spans.single_window(recs, 8, 2) is None
    assert program_spans.single_window(recs, 0, 2) is None


def test_window_rule_fleet():
    spans = profiling.Spans(enabled=True)
    for robots in (2,) * 6:
        with spans.request("fleet_step"):
            for i in range(robots):
                spans.robot = i
                with spans.span("step"):
                    pass
            spans.robot = None
    recs = spans.records()
    win, n = program_spans.fleet_window(recs, 3, True)
    assert n == 3 and {r.request for r in win} == {3, 4, 5}
    win, _ = program_spans.fleet_window(recs, 3, False)
    assert {r.request for r in win} == {4, 5, 6}
    assert program_spans.fleet_window(recs, 6, True) is None


def test_window_takes_the_profiled_scans_from_the_cell(monkeypatch):
    cfg = harness.config(harness.workload(
        harness.load_benchmark(ROOT), "flagship-1M.tracking")["config"])
    profiled = cfg["profile"]["scans"]
    spans = profiling.Spans(enabled=True)
    recs, marks = _single_run(spans, 2, 5, profiled)
    monkeypatch.setattr(program_spans, "records", lambda: recs)
    trace = dict(cell="flagship-1M.tracking", scans=5, prof={})
    win, scans = program_spans.window(trace)
    assert scans == 5
    assert max(r.request for r in win) == marks["window"][-1]
    win, _ = program_spans.window(dict(trace, prof=None))   # no slice ran
    assert max(r.request for r in win) == marks["profiled"][-1]
    monkeypatch.setattr(program_spans, "records", lambda: None)
    assert program_spans.window(trace) is None


def _rec(i, name, start_ms, end_ms, parent, request=1, value=None):
    return Record(i, name, int(start_ms * 1e6), int(end_ms * 1e6), parent,
                  request, None, value)


# one window scan: a warm-up step (the warm-up holds the host read) and,
# in a second scan, a graphed step whose replay holds a capture
SYNTHETIC = [
    _rec(1, "push_cloud", 0, 40, 0),
    _rec(2, "scan.accumulate", 0, 1, 1),
    _rec(3, "scan.transform", 1, 2, 1),
    _rec(4, "scan", 2, 40, 1),
    _rec(5, "scan.prepare", 2, 4, 4),
    _rec(6, "step", 4, 34, 4),
    _rec(7, "step.warm_up", 4, 33, 6),
    _rec(8, "read.fits", 10, 12, 7),
    _rec(9, "read.aux", 34, 36, 4),
    _rec(10, "scan.publish", 36, 40, 4),
    _rec(11, "odometry", 40, 41, 0, request=2),
    _rec(12, "imu", 41, 43, 0, request=3),
    _rec(13, "push_cloud", 50, 80, 0, request=4),
    _rec(14, "scan.prepare", 50, 52, 13, request=4),
    _rec(15, "step", 52, 70, 13, request=4),
    _rec(16, "step.replay_a", 53, 60, 15, request=4),
    _rec(17, "step.capture_a", 53, 59, 16, request=4),
    _rec(18, "graph.drops", 55, 55, 17, request=4, value=1),
    _rec(19, "read.fits", 60, 61, 15, request=4),
    _rec(20, "read.box", 62, 64, 15, request=4),
    _rec(21, "scan.publish", 70, 72, 13, request=4),
]


@pytest.mark.parametrize("metric,want", [
    ("shell_ms", (1 + 1 + 2 + 4 + 2 + 2) / 2),
    ("predict_host_ms", (1 + 2) / 2),
    ("step_host_ms", ((30 - 29) + (18 - 6 - 1 - 2)) / 2),
    ("host_reads", 3 / 2),
    ("capture_ms", (29 + 6) / 2),
])
def test_metrics_read_the_window(monkeypatch, metric, want):
    monkeypatch.setattr(program_spans, "window",
                        lambda trace: (SYNTHETIC, 2))
    assert harness.metric_reader(metric)({}) == pytest.approx(want)
    assert harness.metric_reader(metric + ".relocalize")({}) == \
        pytest.approx(want)


@pytest.mark.parametrize("metric", ["shell_ms", "predict_host_ms",
                                    "step_host_ms", "host_reads",
                                    "capture_ms", "k1_live_roofline"])
def test_metrics_are_silent_without_records(monkeypatch, metric):
    """A program without the tracer (or with it off) gives nothing, and
    the reader does not raise."""
    monkeypatch.setattr(program_spans, "records", lambda: None)
    monkeypatch.setattr(og.grouped_like_score, "live_tables", None)
    trace = dict(cell="flagship-1M.tracking", scans=4, prof=None,
                 shapes={}, routes={}, spans={})
    assert harness.metric_reader(metric)(trace) is None
    assert harness.metric_reader(metric)(dict(trace, prof={"kernels": {}})) \
        is None


def test_k1_live_roofline_counts_the_mean_live_tables(monkeypatch):
    k1 = harness.roofline("k1")
    monkeypatch.setattr(og.grouped_like_score, "launches", 4)
    monkeypatch.setattr(og.grouped_like_score, "live_tables",
                        torch.tensor(4 * 8000))
    shapes = dict(particles=1 << 20, like_points=96, bins=97)
    trace = dict(prof={"kernels": {"like_score_kernel<4, 2>": [2e-4, 2e-4]}},
                 shapes=shapes)
    least = harness.bound_s(*k1.count(1 << 20, 96, 97, 8000))
    got = harness.metric_reader("k1_live_roofline")(trace)
    assert got == pytest.approx(100.0 * least / 2e-4)
    held = harness.bound_s(*k1.launch(shapes))
    assert least > held          # 8,000 live tables read more than 7,225
