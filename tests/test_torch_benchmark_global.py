"""The benchmark's global-localization cell (``global-1M.recover``) on the
CPU at a small size, and the program's spans and counters it reads:

* (a) the port's global-mode steps against the plain reference
  (``benchmark/references/global.py``) through ``run.run_cell``: 1,024
  particles, 256-point scans and a grid of 294 standable cells x 8 yaw
  bins (2,352 seeds, so that, as at the configuration's size, each call
  decays to ``num_particles`` in exactly three steps, slot buckets 64,
  64 and 96); every sampled step compared, the noise column exactly,
  and the bfloat16 control failing.  The reference's resize rows equal
  ``pf.resize``'s, bit for bit, up to the configuration's size; its
  seeding, built from the map, equals the service's, bit for bit; a
  seeding with a fault (a yaw bin, the cells' positions, one cell
  fewer) makes the run not ``correct``;
* (b) the configuration's grid through the service on the benchmark's
  world: 2,079,576 seeds in a 2^21 capacity, three global-mode steps a
  call;
* (c) the drive: one ``global`` message just before every third cloud,
  no re-seed;
* (d) the service's spans and counters in one request, a global-mode
  step's ``global.slots``, the capacity's cut after the decay, and no
  ``global.slots`` on a tracking step; the cell's two readers on
  synthetic records.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcl_3dl_tpu_torch import MCL3DL, Params, pf, profiling
from mcl_3dl_tpu_torch import state as st
from mcl_3dl_tpu_torch.engine import global_slots
from mcl_3dl_tpu_torch.profiling import Record

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, program_spans, run, traffic  # noqa: E402

torch.set_num_threads(2)   # several test workers share the CPU

CELL = "global-1M.recover"
CFG = harness.config("global-1M")
MIX = harness.traffic("recover")
SEED = 2 ** 31 + 12345
QUAT = np.array([0.0, 0.0, 0.0, 1.0])
SOUND = dict(pose_gap_m=1e-4, yaw_gap_rad=1e-4, cov_gap=1e-3,
             entropy_gap=1e-3, noise_gap=0.0)
SMALL_GRID = {"global_localization_grid_lin": 0.5,
              "global_localization_grid_ang": 2 * math.pi / 8}
SMALL = {"params": dict(num_particles=1024, **SMALL_GRID),
         "model": dict(num_particles=1024, **SMALL_GRID),
         "cloud_points": 256,
         "check": {"scans": 3, "from_first": 3}}
# 294 standable cells x 8 bins, decayed 0.75x a step; at full size the
# room's 5,097 cells x 408 bins
SMALL_STEPS = (2352, 1764, 1323)
FULL_STEPS = (2079576, 1559682, 1169761)
MODELS = ("pose_gap_m", "cov_gap", "entropy_gap")


def reference():
    return harness.reference("global")


@pytest.fixture(scope="module")
def small_run():
    """A small run of the cell with the control's readings, and the
    sampled records it compared, kept for inspection."""
    from benchmark import cells
    kept = []
    single = cells.single

    def keeping(*a, **k):
        r = single(*a, **k)
        kept.extend(r.records)
        return r

    cells.single = keeping
    try:
        out = run.run_cell(CELL, SEED, 2.0, 0, device="cpu", overrides=SMALL,
                           limits=SOUND, control=True, log=lambda m: None)
    finally:
        cells.single = single
    return (*out, kept)


def test_port_matches_the_global_reference(small_run):
    out, checks, _, _ = small_run
    assert out["correct"], checks
    assert out["failed"] == 0 and out["attempted"] >= 3
    assert checks["noise_gap"][0] == 0.0


def test_cell_reports_the_accepted_rate(small_run):
    """The cell reports the scan rate under the end-to-end entry that the
    tracking cell has, and each of its per-layer metrics moves it."""
    out = small_run[0]
    bench = harness.load_benchmark(ROOT)
    assert set(out["metrics"]) == {"updates_per_s", "setup_s"}
    assert out["metrics"]["updates_per_s"][0] > 0
    rate = next(m for m in bench["end_to_end"]
                if m["name"] == "updates_per_s")
    assert rate["workloads"] == ["flagship-1M.tracking", CELL]
    mine = [m for m in bench["per_layer"] if CELL in m.get("workloads", ())]
    assert len(mine) == 5
    assert {m["moves"] for m in mine} == {"updates_per_s"}


def _plant(fault):
    """``global_localization`` with one fault in the seeding it leaves."""
    service = MCL3DL.global_localization

    def planted(self):
        n = service(self)
        s, div = self.pstate, self.params.global_localization_div_yaw
        idx = torch.arange(s.capacity)
        if fault == "yaw_bin":      # each cell's last bin at bin 0's yaw
            last = (idx < n) & (idx % div == div - 1)
            rot = s.rot.clone()
            rot[last] = s.rot[idx[last] - (div - 1)]
            self.pstate = s._replace(rot=rot)
        elif fault == "cells":      # seeds half a cell off the centroids
            pos = s.pos.clone()
            pos[:n, :2] -= self.params.global_localization_grid_lin / 2
            self.pstate = s._replace(pos=pos)
        else:                       # one cell left out
            n -= div
            self.pstate = s._replace(
                prob=torch.where(idx < n, s.prob, 0.0),
                n_active=torch.tensor(n, dtype=torch.int32))
            self._n_active_host = n
        return n

    return planted


@pytest.mark.parametrize("fault", ["yaw_bin", "cells", "count"])
def test_a_wrong_seeding_is_not_correct(monkeypatch, fault):
    """The reference builds the seeding again from the map and steps from
    it: a seeding with a yaw bin, the cells or the count wrong is not
    ``correct``."""
    monkeypatch.setattr(MCL3DL, "global_localization", _plant(fault))
    out, checks, _ = run.run_cell(CELL, SEED, 1.0, 0, device="cpu",
                                  overrides=SMALL, limits=SOUND,
                                  log=lambda m: None)
    assert out["failed"] == 0 and out["attempted"] >= 3
    assert not out["correct"], checks


@pytest.mark.parametrize("small", [True, False])
def test_reference_seeding_equals_the_service(small):
    """The reference's standable cells, seeds, yaws and weights are the
    service's, bit for bit, at the test's grid and the configuration's
    (5,097 cells x 408 bins)."""
    ref = reference()
    model = dict(CFG["model"], **(SMALL["model"] if small else {}))
    params = Params(**(SMALL["params"] if small else CFG["params"]))
    assert all(model[k] == getattr(params, k) for k in SMALL_GRID)
    assert ref.div_yaw(model) == params.global_localization_div_yaw
    eng = MCL3DL(params, capacity=1024, device="cpu")
    eng.load_map(traffic.world_map())
    eng.imu(np.zeros(3), traffic.yaw_quat(0.3), 0.0)
    eng.imu(np.array([0.0, 0.0, 9.8]), traffic.yaw_quat(0.3), 0.06)
    n = eng.global_localization()
    want = ref.seeded(model, ref.standable(traffic.world_map(), model,
                                           "cpu"), eng.pstate.rot[0], "cpu")
    assert int(want["n_active"]) == n
    assert ref.episode(model, n) == list(SMALL_STEPS if small
                                         else FULL_STEPS)
    for k in ("pos", "rot", "prob", "odom_err_lin"):
        assert torch.equal(getattr(eng.pstate, k), want[k]), k


def test_bfloat16_control_fails(small_run):
    _, _, ctl, _ = small_run
    assert not ctl["correct"], ctl
    assert ctl["noise_gap"] == 0.0, ctl
    assert any(ctl[k] >= 3 * SOUND[k] for k in MODELS), ctl


def test_records_hold_each_global_step(small_run):
    """The first three window updates are the three global-mode steps of
    one call, at the ramp's slot buckets; the capacity is cut back to the
    bucket of the decayed count after each step (here 4,096 -> 2,048
    after the first, to the base 1,024 after the last)."""
    records = small_run[3]
    ref = reference()
    model = dict(CFG["model"], num_particles=1024)
    n = [int(r["state"]["n_active"]) for r in records]
    assert n == list(SMALL_STEPS)
    assert [ref.ramp(model, k) for k in n] == [(64, 41), (64, 55), (96, 74)]
    params = Params(num_particles=1024, **SMALL_GRID)
    assert [global_slots(params, k) for k in n] == [64, 64, 96]
    assert [r["state"]["pos"].shape[0] for r in records] == \
        [4096, 2048, 2048]
    assert [r["post_noise"].shape[0] for r in records] == \
        [2048, 2048, 1024]
    assert ref.decayed(model, SMALL_STEPS[-1]) == 1024


@pytest.mark.parametrize("n,cap", [(2352, 4096), (1764, 4096), (1323, 4096),
                                   (FULL_STEPS[0], 1 << 21),
                                   (FULL_STEPS[2], 1 << 21)])
def test_reference_resize_rows_equal_the_port(n, cap):
    """The reference's comb over the resampled (equal) weights takes the
    rows ``pf.resize`` takes, bit for bit."""
    ref = reference()
    model = dict(CFG["model"], num_particles=1024 if cap == 4096
                 else CFG["model"]["num_particles"])
    new_n = ref.decayed(model, n)
    s = st.zeros(cap, n)
    s = s._replace(pos=torch.arange(cap, dtype=torch.float32)[:, None]
                   .expand(cap, 3).contiguous(),
                   prob=s.active_mask() / s.n_active.to(torch.float32))
    out = pf.resize(s, torch.tensor(new_n, dtype=torch.int32))
    want = out.pos[:, 0].to(torch.int64)
    assert torch.equal(ref.resize_rows(n, new_n, cap, "cpu"), want)
    assert int(out.n_active) == new_n


def test_configuration_grid_seeds_two_million():
    """(b) The configuration's grid through ``global_localization`` on the
    benchmark's world: 5,097 standable cells x 408 yaw bins, within 2^21,
    and three global-mode steps a call."""
    params = Params(**CFG["params"])
    assert params.global_localization_div_yaw == 408
    eng = MCL3DL(params, capacity=1024, device="cpu")
    eng.load_map(traffic.world_map())
    n = eng.global_localization()
    assert n == FULL_STEPS[0] == 5097 * 408
    assert eng.pstate.capacity == 1 << 21 and n / (1 << 21) > 0.99
    ref = reference()
    steps = [n]
    while steps[-1] > params.num_particles:
        steps.append(ref.decayed(CFG["model"], steps[-1]))
    assert steps == [*FULL_STEPS, params.num_particles]
    assert [global_slots(params, k) for k in FULL_STEPS] == [64, 64, 96]
    assert [ref.ramp(CFG["model"], k) for k in FULL_STEPS] == \
        [(64, 48), (64, 64), (96, 86)]


def test_drive_calls_the_service_before_every_third_cloud():
    """(c) One ``global`` message just before every third cloud of the
    lap, and no re-seed."""
    drive = harness.drive(MIX["drive"])
    lap = drive.make(MIX, CFG, SEED)
    kinds = [m.kind for m in lap.messages]
    assert "reseed" not in kinds
    clouds = [i for i, k in enumerate(kinds) if k == "cloud"]
    assert len(clouds) == MIX["lap_scans"] and MIX["lap_scans"] % 3 == 0
    for j, i in enumerate(clouds):
        assert (kinds[i - 1] == "global") == (j % 3 == 0), j
    assert kinds.count("global") == MIX["lap_scans"] // 3
    assert MIX["episode_scans"] == 3 and MIX["warmup_scans"] % 3 == 0


@pytest.fixture
def tracer(monkeypatch):
    spans = profiling.spans
    monkeypatch.setattr(spans, "enabled", True)
    spans.clear()
    yield spans
    spans.clear()


def _by_request(recs, name):
    out = []
    for i in [r.request for r in recs if r.parent == 0 and r.name == name]:
        out.append([r for r in recs if r.request == i])
    return out


def test_service_and_global_steps_are_traced(tracer):
    """(d) The service is one request with its two spans and the seed
    count; each global-mode step records its slot bucket inside
    ``step``, the third cuts the capacity, and the tracking step after
    them records no slot bucket."""
    eng = MCL3DL(Params(num_particles=1024, **SMALL_GRID), device="cpu")
    eng.load_map(traffic.world_map())
    eng.odometry(np.zeros(3), QUAT, 0.0)
    rng = np.random.default_rng(0)
    assert eng.global_localization() == SMALL_STEPS[0]
    for k in range(5):      # the first push only accumulates its cloud
        t = 0.1 * (k + 1)
        eng.odometry(np.zeros(3), QUAT, t)
        cloud = traffic.cast(rng, 0.0, 0.0, 0.0, 256, 0.01)
        res = eng.push_cloud("lidar", cloud, np.array(
            [0.0, 0.0, traffic.SENSOR_Z]), t)
        assert (res is None) == (k == 0)
    recs = tracer.records()
    (service,) = _by_request(recs, "global_localization")
    names = [r.name for r in service]
    assert {"global.standable", "global.seed"} <= set(names)
    root = next(r for r in service if r.parent == 0)
    for r in service:
        assert root.start <= r.start and r.end <= root.end
    (seeds,) = [r for r in service if r.name == "global.seeds"]
    assert seeds.value == SMALL_STEPS[0]
    seed_span = next(r for r in service if r.name == "global.seed")
    assert seeds.parent == seed_span.id
    pushes = _by_request(recs, "push_cloud")
    assert len(pushes) == 5
    for k, req in enumerate(pushes[1:]):
        step = next(r for r in req if r.name == "step")
        slots = [r for r in req if r.name == "global.slots"]
        shrink = [r for r in req if r.name == "capacity.shrink"]
        if k < 3:
            assert [r.value for r in slots] == [[64, 64, 96][k]]
            assert slots[0].parent == step.id
        else:
            assert slots == []
        assert len(shrink) == (k in (0, 2))
    assert eng.pstate.capacity == 1024


def _rec(i, name, start_ms, end_ms, parent, request, value=None):
    return Record(i, name, int(start_ms * 1e6), int(end_ms * 1e6), parent,
                  request, None, value)


# a window of three scans: a service call, two global-mode steps and one
# tracking step
WINDOW = [
    _rec(1, "global.standable", 0, 30, 3, 1),
    _rec(2, "global.seed", 30, 50, 3, 1),
    _rec(3, "global_localization", 0, 50, 0, 1),
    _rec(4, "global.slots", 61, 61, 5, 2, value=64),
    _rec(5, "step", 60, 90, 6, 2),
    _rec(6, "push_cloud", 55, 95, 0, 2),
    _rec(7, "global.slots", 101, 101, 8, 3, value=64),
    _rec(8, "step", 100, 130, 9, 3),
    _rec(9, "push_cloud", 96, 135, 0, 3),
    _rec(10, "step", 140, 150, 11, 4),
    _rec(11, "push_cloud", 136, 152, 0, 4),
]


def test_service_ms_and_global_share_read_the_window(monkeypatch):
    monkeypatch.setattr(program_spans, "window", lambda trace: (WINDOW, 3))
    assert harness.metric_reader("service_ms.recover")({}) == \
        pytest.approx(50.0)
    assert harness.metric_reader("global_share.recover")({}) == \
        pytest.approx(200.0 / 3)


@pytest.mark.parametrize("metric", ["service_ms.recover",
                                    "global_share.recover"])
def test_new_readers_are_silent_without_the_service_request(monkeypatch,
                                                            metric):
    """A program that does not trace the service as a request (or keeps
    no records) gives nothing, and the reader does not raise."""
    untraced = [r for r in WINDOW if not r.name.startswith("global")]
    monkeypatch.setattr(program_spans, "window",
                        lambda trace: (untraced, 3))
    assert harness.metric_reader(metric)({}) is None
    monkeypatch.setattr(program_spans, "window", lambda trace: None)
    assert harness.metric_reader(metric)({}) is None
