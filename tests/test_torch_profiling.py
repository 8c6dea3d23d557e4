"""Tracing of the port (``profiling.py``) on the CPU: ``Spans.summary``
prints the JAX package's lines for the same spans, and ``trace_to``
writes a Chrome trace of a callable's ops."""

import json
import re

import torch

from mcl_3dl_tpu import profiling as jprof

from mcl_3dl_tpu_torch import profiling

torch.set_num_threads(2)   # several test workers share the CPU


def _fill(spans):
    """Three spans, then the same recorded durations on both sides."""
    for name in ("measure", "map", "measure"):
        with spans.span(name):
            pass
    spans.totals = {"map": 0.5, "measure": 0.0123}
    spans.counts = {"map": 1, "measure": 2}
    spans.last = {"map": 0.5, "measure": 0.0061}


def test_spans_summary_has_the_jax_format():
    port, jax_spans = profiling.Spans(), jprof.Spans()
    _fill(port)
    _fill(jax_spans)
    lines = port.summary()
    assert lines == jax_spans.summary()
    assert lines == ["map: total 0.500s over 1 (500.00 ms avg, last 500.00 ms)",
                     "measure: total 0.012s over 2 (6.15 ms avg, last 6.10 ms)"]


def test_spans_accumulate_wall_time():
    spans = profiling.Spans()
    for _ in range(3):
        with spans.span("step"):
            torch.ones(100).sum()
    assert spans.counts["step"] == 3 and spans.totals["step"] >= 0.0
    assert re.fullmatch(r"step: total \d+\.\d{3}s over 3 \(\d+\.\d{2} ms avg, "
                        r"last \d+\.\d{2} ms\)", spans.summary()[0])


def test_trace_to_writes_a_trace(tmp_path):
    out = profiling.trace_to(str(tmp_path / "trace"), lambda a, b: a @ b,
                             torch.ones(64, 64), b=torch.ones(64, 64))
    assert torch.equal(out, torch.full((64, 64), 64.0))
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n for n in names), sorted(names)[:20]
