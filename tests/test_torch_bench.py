"""The port's bench (``tools/bench.py``) and small-count sweep
(``tools/exp_small.py``) on the CPU: their builder against the JAX
package's driver entry, their row functions at 1,024 particles (few steps;
the times are the host's, not a device number), the metric line's
arithmetic, and the command lines without a card.

The builder's map points, scan, sensor origin and engine settings are
``__graft_entry__._build_engine_and_inputs``'s, equal (numpy from the same
seed and formulas); its step gets the scan downsampled and padded as
``push_cloud`` prepares it (``tools.sharded.step_args``), where the JAX
driver entry passes the raw scan.
"""

import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as ge

from mcl_3dl_tpu_torch import worlds
from mcl_3dl_tpu_torch.tools import bench, exp_small

torch.set_num_threads(2)   # several test workers share the CPU

ROOT = Path(__file__).resolve().parents[1]
N = 1024


def test_builder_matches_graft_entry():
    jeng, jargs = ge._build_engine_and_inputs(num_particles=N,
                                              cloud_points=bench.CLOUD_POINTS,
                                              seed=0, fast=True)
    eng, scan, args = bench.build(N, "cpu")
    np.testing.assert_array_equal(worlds.world_map(), ge._make_world_map())
    np.testing.assert_array_equal(eng.map.points, np.asarray(jeng.map.points))
    np.testing.assert_array_equal(scan, np.asarray(jargs[5]))
    np.testing.assert_array_equal(args[5].numpy(), np.asarray(jargs[9]))
    assert eng.params.num_particles == jeng.params.num_particles == N
    assert eng.pstate.capacity == jeng.pstate.capacity
    assert eng.params.likelihood.interp == jeng.params.likelihood.interp
    assert eng.params.use_beam_model and jeng.params.use_beam_model
    assert (eng.params.likelihood.num_points, eng.params.beam.num_points) == (
        jeng.params.likelihood.num_points, jeng.params.beam.num_points)
    # the tracking spread of the driver entry's initial_pose
    np.testing.assert_allclose(eng.pstate.pos.std(0).numpy(),
                               np.asarray(jeng.pstate.pos).std(0), rtol=0.15)


def _row_ok(row, steps):
    assert len(row["step_ms_all"]) == steps
    assert all(math.isfinite(t) and t > 0 for t in row["step_ms_all"])
    assert row["step_ms"] == np.median(row["step_ms_all"])
    assert row["tiers"] and all(len(t) == 2 for t in row["tiers"])
    assert set(row["launches"]) == {"like", "beam", "local", "march",
                                    "sphere", "dda", "field"}
    assert all(v == 0 for v in row["launches"].values())   # plain on the CPU
    assert set(row["routes"]) <= {"eager"}    # no graphs on the CPU


@pytest.fixture(scope="module")
def steady():
    eng, _, args = bench.build(N, "cpu")
    out, row = bench.steady_row(eng, args, warmup=1, iters=1)
    return eng, args, out, row


def test_steady_row(steady):
    eng, _, out, row = steady
    _row_ok(row, 1)
    assert row["first_step_s"] > 0
    assert out[0].capacity == N and np.isfinite(out[0].pos.numpy()).all()
    assert row["tiers"] == [(0, 0)]          # 1024 particles: grouped


def test_push_cloud_row(steady):
    eng, _, out, _ = steady
    row = bench.push_cloud_row(eng, out, scans=1)
    _row_ok(row, 1)
    assert eng.last_aux is not None


def test_fallback_row(steady):
    eng, args, _, _ = steady
    row = bench.fallback_row(eng, args, iters=1)
    _row_ok(row, 1)
    assert row["tiers"] == [(2, 2)]          # the wide spread fits no box


def test_trilinear_row():
    row = bench.trilinear_row(N, "cpu", warmup=1, iters=1)
    _row_ok(row, 1)
    assert row["tiers"][0][0] == 2           # trilinear samples at tier 2


def test_global_row():
    row = bench.global_row("cpu", num_particles=N, grid=0.5, iters=1)
    _row_ok(row, 1)
    assert row["particles"] > N and row["capacity"] >= row["particles"]
    assert row["like_slots"] <= 96
    assert row["tiers"][0][1] == -1          # the beam's global budget is 0


def test_summarize_builds_bench_py_line():
    def child(ms):
        row = dict(step_ms=ms, step_ms_all=[ms], tiers=[[0, 0]],
                   launches={"like": 1, "beam": 1, "local": 0})
        return dict(num_particles=N, use_beam=True, points_per_particle=99,
                    device="no card", kind="cpu", max_memory_allocated=5,
                    steady=dict(row, first_step_s=1.0),
                    push_cloud=dict(row, step_ms=ms + 1.0))
    line = bench.summarize([child(10.0), child(30.0), child(20.0)], "card")
    assert sorted(line) == ["extra", "metric", "unit", "value", "vs_baseline"]
    assert line["metric"] == "particle_likelihood_evals_per_sec_chip"
    assert line["unit"] == "evals/s"
    assert line["value"] == pytest.approx(N * 99 / 0.020)
    assert line["vs_baseline"] == pytest.approx(line["value"] / 63360.0)
    ex = line["extra"]
    assert ex["baseline_evals_per_sec"] == 63360.0
    assert (ex["step_ms"], ex["step_ms_min"], ex["step_ms_max"]) == (
        20.0, 10.0, 30.0)
    assert ex["step_ms_processes"] == [10.0, 30.0, 20.0]
    assert ex["step_ms_steps"] == [[10.0], [30.0], [20.0]]
    assert ex["step_ms_pooled_quantiles"] == [10.0, 15.0, 20.0, 25.0, 30.0]
    assert ex["push_cloud_ms"] == 21.0
    assert (ex["tier_like"], ex["tier_beam"]) == (0, 0)
    assert "fallback_step_ms" not in ex


@pytest.mark.parametrize("n", [64, N])
def test_exp_small_row(n):
    row = exp_small.run_config(n, "cpu", iters=1, repeats=2, warmup=1)
    keys = {"num_particles", "step_ms", "updates_per_sec", "evals_per_sec",
            "tier_like", "tier_beam", "compile_s", "iters", "repeats",
            "fetch_overhead_ms", "block_spread_ms_per_step",
            "block_end_tiers"}
    assert keys <= set(row)
    assert row["num_particles"] == n and row["fetch_overhead_ms"] is None
    lo, hi = row["block_spread_ms_per_step"]
    assert 0 < lo <= row["step_ms"] <= hi and math.isfinite(hi)
    assert row["evals_per_sec"] == pytest.approx(n * 99 / row["step_ms"] * 1e3)
    assert len(row["block_tiers"]) == 2 and len(row["block_end_tiers"]) == 2
    if n % 1024:                             # the grouped tier needs 1024s
        assert all(t[0] != 0 for b in row["block_tiers"] for t in b)


@pytest.mark.parametrize("module", ["bench", "exp_small", "benchmark_raycast"])
def test_cli_without_a_card_exits_nonzero(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", f"mcl_3dl_tpu_torch.tools.{module}"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "metric" not in out.stdout and "num_particles" not in out.stdout
    assert "casts" not in out.stdout
