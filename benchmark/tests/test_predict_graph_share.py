"""``predict_graph_share`` on synthetic records of the program's tracer:
the share of the window's ``odometry.predict`` and ``imu.weigh`` spans
holding ``predict.graph``; nothing from a program that records no route
counter there (a program without the odometry and IMU graphs) or no
records."""

import pytest

from benchmark import harness, program_spans
from mcl_3dl_tpu_torch.profiling import Record


def _rec(i, name, start_ms, end_ms, parent, request=1, value=None):
    return Record(i, name, int(start_ms * 1e6), int(end_ms * 1e6), parent,
                  request, None, value)


# a warm-up, a capture (the capture span nests in the call's span, the
# route counter directly in it), two replays, and a fake IMU's weigh made
# inside an odometry request
WINDOW = [
    _rec(1, "predict.warm_up", 1, 1, 2, value=1),
    _rec(2, "odometry.predict", 0, 3, 3),
    _rec(3, "odometry", 0, 4, 0),
    _rec(4, "predict.graph", 11, 11, 6, request=2, value=1),
    _rec(5, "imu.capture", 12, 20, 6, request=2),
    _rec(6, "imu.weigh", 10, 21, 7, request=2),
    _rec(7, "imu", 10, 22, 0, request=2),
    _rec(8, "predict.graph", 31, 31, 9, request=3, value=1),
    _rec(9, "odometry.predict", 30, 32, 12, request=3),
    _rec(10, "predict.graph", 33, 33, 11, request=3, value=1),
    _rec(11, "imu.weigh", 32, 34, 12, request=3),
    _rec(12, "odometry", 30, 35, 0, request=3),
    _rec(13, "push_cloud", 40, 60, 0, request=4),
]


def test_reads_the_share_of_graphed_calls(monkeypatch):
    monkeypatch.setattr(program_spans, "window", lambda trace: (WINDOW, 1))
    assert harness.metric_reader("predict_graph_share")({}) == \
        pytest.approx(75.0)


def test_silent_without_route_counters(monkeypatch):
    untraced = [r for r in WINDOW if not r.name.startswith("predict.")]
    monkeypatch.setattr(program_spans, "window",
                        lambda trace: (untraced, 1))
    assert harness.metric_reader("predict_graph_share")({}) is None
    monkeypatch.setattr(program_spans, "window", lambda trace: None)
    assert harness.metric_reader("predict_graph_share")({}) is None
