"""The odometry and IMU graphs (``predict_graph.py``) on the card: the same
60 odometry and 120 IMU messages through a graphed engine and through one
forced eager (``predict_graph.graphable`` patched for its drive), every
particle field bit-equal (``torch.equal``):

* at 10,240 and 1,048,576 particles, across an ``initial_pose`` partway
  through, after which the graphs replay and are not captured again;
* across a resize 2^20 -> 2^21 -> 2^20, each of the four keys captured
  once, the first two replayed again after the return.

Skipped without a CUDA device.  On the card, with no JAX installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_predict_graph_gpu.py
"""

import numpy as np
import pytest
import torch

from mcl_3dl_tpu_torch import MCL3DL, predict_graph, step_graph

from test_torch_predict_graph import (COV, calls, drive, engine,  # noqa: E402
                                      equal_states, feed)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def captures(monkeypatch):
    """Counts the graphs captured (``step_graph.capture``)."""
    made = []
    real = step_graph.capture

    def counted(fn, pool):
        made.append(1)
        return real(fn, pool)

    monkeypatch.setattr(step_graph, "capture", counted)
    return made


def eager_twin(monkeypatch, n, device, run):
    """``run(engine)`` on a fresh engine whose chains run eagerly."""
    with monkeypatch.context() as m:
        m.setattr(predict_graph, "graphable", lambda device: False)
        eng = engine(n, MCL3DL, device)
        run(eng)
    assert eng._predict_graphs == {}
    return eng


@pytest.mark.parametrize("n", [10240, 1 << 20])
def test_graphed_drive_equals_eager(cuda, monkeypatch, captures, n):
    msgs = drive()

    def run(eng):
        feed(eng, msgs, reseed_at=90)
        torch.cuda.synchronize()

    eng = engine(n, MCL3DL, cuda)
    run(eng)
    eager = eager_twin(monkeypatch, n, cuda, run)
    assert equal_states(eng.pstate, eager.pstate)
    total = calls(msgs)
    assert eng.predict_routes == {"graph": total - 2, "warm_up": 2,
                                  "eager": 0}
    assert eager.predict_routes == {"graph": 0, "warm_up": 0,
                                    "eager": total}
    assert len(captures) == 2          # the re-seed captured nothing


def test_graphs_across_a_resize(cuda, monkeypatch, captures):
    msgs = drive(seed=4)
    n = 1 << 20

    def run(eng):
        feed(eng, msgs[:60])
        eng.resize_particles(1 << 21)
        assert eng.pstate.capacity == 1 << 21
        feed(eng, msgs[60:120])
        eng.resize_particles(n)
        assert eng.pstate.capacity == n
        eng.initial_pose(np.array([0.1, 0.0, 0.0]),
                         np.array([0.0, 0.0, 0.0, 1.0]), COV)
        feed(eng, msgs[120:])
        torch.cuda.synchronize()

    eng = engine(n, MCL3DL, cuda)
    run(eng)
    eager = eager_twin(monkeypatch, n, cuda, run)
    assert equal_states(eng.pstate, eager.pstate)
    assert len(captures) == 4 and len(eng._predict_graphs) == 4
    assert eng.predict_routes["warm_up"] == 4
