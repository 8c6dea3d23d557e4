"""The port's tracer (``profiling.py``) on the CPU: ``Spans.summary``
prints the JAX package's lines for the same spans; spans are records with
their parent and request in a bounded ring; ``MCL3DL_TRACE=0`` records
nothing; and ``trace_to`` writes a Chrome trace of a callable's ops with
the program's ``mcl.`` ranges."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

from mcl_3dl_tpu import profiling as jprof

from mcl_3dl_tpu_torch import profiling

torch.set_num_threads(2)   # several test workers share the CPU
ROOT = Path(__file__).resolve().parents[1]


def _fill(spans):
    """Three spans, then the same recorded durations on both sides."""
    for name in ("measure", "map", "measure"):
        with spans.span(name):
            pass
    spans.totals = {"map": 0.5, "measure": 0.0123}
    spans.counts = {"map": 1, "measure": 2}
    spans.last = {"map": 0.5, "measure": 0.0061}


def test_spans_summary_has_the_jax_format():
    port, jax_spans = profiling.Spans(enabled=True), jprof.Spans()
    _fill(port)
    _fill(jax_spans)
    lines = port.summary()
    assert lines == jax_spans.summary()
    assert lines == ["map: total 0.500s over 1 (500.00 ms avg, last 500.00 ms)",
                     "measure: total 0.012s over 2 (6.15 ms avg, last 6.10 ms)"]
    assert [r.name for r in port.records()] == ["measure", "map", "measure"]


def test_spans_accumulate_wall_time():
    spans = profiling.Spans(enabled=True)
    for _ in range(3):
        with spans.span("step"):
            torch.ones(100).sum()
    assert spans.counts["step"] == 3 and spans.totals["step"] >= 0.0
    assert re.fullmatch(r"step: total \d+\.\d{3}s over 3 \(\d+\.\d{2} ms avg, "
                        r"last \d+\.\d{2} ms\)", spans.summary()[0])
    recs = spans.records()
    assert len(recs) == 3
    assert abs(sum(r.end - r.start for r in recs) * 1e-9
               - spans.totals["step"]) < 1e-9


def test_records_carry_parent_request_and_robot():
    spans = profiling.Spans(enabled=True)
    with spans.span("outside"):
        pass
    with spans.request("push_cloud"):
        with spans.span("scan"):
            with spans.request("imu"):        # a call inside a call
                spans.count("graph.drops")
    spans.robot = 7
    with spans.request("fleet_step"):
        with spans.span("step"):
            pass
    spans.robot = None
    recs = {r.name: r for r in spans.records()}
    assert recs["outside"].request == 0 and recs["outside"].parent == 0
    push, scan, imu = recs["push_cloud"], recs["scan"], recs["imu"]
    assert push.parent == 0 and push.request > 0
    assert scan.parent == push.id and imu.parent == scan.id
    assert {scan.request, imu.request} == {push.request}
    drop = recs["graph.drops"]
    assert (drop.value, drop.parent, drop.request) == (1, imu.id,
                                                       push.request)
    assert drop.start == drop.end and push.start <= drop.start <= push.end
    fleet, step = recs["fleet_step"], recs["step"]
    assert fleet.request == push.request + 1 == step.request
    assert step.robot == 7 and recs["scan"].robot is None
    assert all(r.value is None for r in spans.records()
               if r.name != "graph.drops")
    assert spans.summary()[-1] == "graph.drops: count 1"


def test_ring_keeps_the_newest_records():
    spans = profiling.Spans(capacity=8, enabled=True)
    for i in range(21):
        with spans.request(f"r{i}"):
            pass
    recs = spans.records()
    assert [r.name for r in recs] == [f"r{i}" for i in range(13, 21)]
    assert [r.request for r in recs] == list(range(14, 22))
    assert spans.counts["r0"] == 1      # the totals keep every span
    assert profiling.RING == 1 << 18 == profiling.spans.capacity


def test_trace_off_records_nothing():
    spans = profiling.Spans(enabled=False)
    with spans.request("push_cloud"):
        with spans.span("scan"):
            spans.count("graph.drops")
    assert spans.records() == [] and spans.summary() == []
    assert spans.open_request == 0


def test_trace_env_turns_the_program_tracer_off():
    code = ("from mcl_3dl_tpu_torch import profiling as p; "
            "print(p.spans.enabled, p.Spans().enabled)")
    for env, want in (("0", "False False"), ("1", "True True")):
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            env=dict(os.environ, MCL3DL_TRACE=env), cwd=ROOT, check=True)
        assert out.stdout.split() == want.split()


def test_trace_to_writes_a_trace(tmp_path):
    out = profiling.trace_to(str(tmp_path / "trace"), lambda a, b: a @ b,
                             torch.ones(64, 64), b=torch.ones(64, 64))
    assert torch.equal(out, torch.full((64, 64), 64.0))
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n for n in names), sorted(names)[:20]


def test_trace_to_writes_the_program_ranges(tmp_path):
    tracer = profiling.spans

    def work():
        with tracer.request("push_cloud"):
            with tracer.span("scan.prepare"):
                return torch.ones(32, 32) @ torch.ones(32, 32)

    assert not tracer.ranges
    profiling.trace_to(str(tmp_path / "t"), work)
    assert not tracer.ranges            # on for the run only
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    ev = {e["name"]: e for e in trace["traceEvents"]
          if e.get("name", "").startswith("mcl.")}
    assert set(ev) == {"mcl.push_cloud", "mcl.scan.prepare"}
    outer, inner = ev["mcl.push_cloud"], ev["mcl.scan.prepare"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
