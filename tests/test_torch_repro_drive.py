"""The drive reproducibility tool (``tools/repro_drive.py``) on the CPU:
its fingerprints, its op log and where it places the first difference.
The drive itself needs the card."""

import pytest
import torch

from mcl_3dl_tpu_torch.tools import repro_drive as rd


def test_fingerprint_tells_bits_apart():
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    assert rd.fingerprint(x) == rd.fingerprint(x.clone())
    y = x.clone()
    y[2, 3] = torch.nextafter(y[2, 3], torch.tensor(100.0))
    assert rd.fingerprint(x) != rd.fingerprint(y)
    assert rd.fingerprint(x) != rd.fingerprint(x.reshape(4, 3))
    assert rd.fingerprint(torch.tensor(True))[2] != rd.fingerprint(
        torch.tensor(False))[2]


def _logged(step):
    with rd.OpLog() as log:
        a = torch.arange(64, dtype=torch.float32)
        b = torch.cumsum(a * step, dim=0)
        torch.empty(5)
        (b + 1.0).sum()
    return log.records


def test_op_log_of_equal_runs_is_equal():
    a, b = _logged(0.5), _logged(0.5)
    assert len(a) >= 5
    assert any("cumsum" in r[0] for r in a)
    assert all(len(r) == 4 for r in a)
    assert rd.first_difference(a, b) is None


def test_first_difference_names_the_op():
    ref = [("aten.mul", [1], [2]), ("aten.cumsum", [2], [3]),
           ("aten.empty", [], [9]), ("aten.add", [3], [4])]
    # an op whose output moved on equal inputs
    other = ref[:1] + [("aten.cumsum", [2], [7]), ref[2],
                       ("aten.add", [7], [8])]
    assert rd.first_difference(ref, other) == (
        1, "equal inputs, other outputs: not reproducible")
    # fresh allocations hold garbage: an op that overwrites one reads
    # other inputs and writes equal bits
    other = ref[:2] + [("aten.empty", [], [5]), ("aten.add", [6], [4])]
    assert rd.first_difference(ref, other) is None
    # inputs that changed outside the log
    other = ref[:3] + [("aten.add", [6], [8])]
    assert rd.first_difference(ref, other) == (3, (
        "other inputs and outputs (inputs written outside the log, or read "
        "before they were written)"))
    assert rd.first_difference(ref, ref[:3]) == (3, "one log is longer")
    assert rd.first_difference(_logged(0.5), _logged(0.25))[1] == (
        "equal inputs, other outputs: not reproducible")


def test_repro_drive_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rd.main(["--drives", "1"])


def test_recovery_drive_prints_match_on_cpu(monkeypatch):
    """``--drive recovery`` at a small size on the CPU: one episode from
    12,696 seeds; two drives give one row a measurement each, equal, the
    count falling to 64."""
    from mcl_3dl_tpu_torch.tools import recovery

    make = recovery.engine
    monkeypatch.setattr(recovery, "engine", lambda: make(
        "cpu", grid_lin=0.3, yaw_bins=12))
    monkeypatch.setattr(recovery, "EPISODES", (("global", None, None),))
    a, _ = rd.record_recovery()
    b, _ = rd.record_recovery()
    assert a == b
    assert [s[0] for s in a] == ["global"] * (len(a) - 1) + ["end"]
    assert a[-1][3] == 64 and a[-2][3] == 64
    assert len({s[4] for s in a}) == len(a)
