"""The slice as a whole on the CPU: an engine with every option (trilinear
sampling, the DDA raycast, the normal-weighted sampler, ``output_pcd``)
against the JAX engine over six scans, the phase-9 drive of
``tools/all_options.py`` at a small size, the trilinear Tier-3 gate, and
the replay tool.

Tolerances and why: the two engines draw from different random streams
(``jax.random`` and ``torch.Generator``), so they are compared on tier
telemetry (equal, 2/2 at every step) and on their published poses: each
within 0.05 m / 0.05 rad of the truth and within 0.05 m of the other.
The gates use the reference's thresholds (``docs/TIER3_GATE_TRILINEAR.json``).
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mcl_3dl_tpu.map.native as jnative
from mcl_3dl_tpu import MCL3DL as JMCL3DL
from mcl_3dl_tpu.config import Params as JParams

from mcl_3dl_tpu_torch import MCL3DL, convert, worlds
from mcl_3dl_tpu_torch.io.pcd import read_pcd
from mcl_3dl_tpu_torch.tools import all_options as ao
from mcl_3dl_tpu_torch.tools import run_replay, run_tier3, tier3

torch.set_num_threads(2)   # several test workers share the CPU

ROOT = Path(__file__).resolve().parents[1]
N_SCANS = 6


def _err(res):
    return ao.pose_error(res)


def test_all_options_engine_tracks_jax(monkeypatch):
    monkeypatch.setattr(jnative, "build_distance_field_native",
                        lambda *a, **k: None)
    monkeypatch.setattr(jnative, "build_occupancy_rep_native",
                        lambda *a, **k: None)
    tp = ao.params(1024)
    tp = dataclasses.replace(tp, likelihood=dataclasses.replace(
        tp.likelihood, num_points=32))
    jp = JParams.from_dict(dataclasses.asdict(tp))
    assert dataclasses.asdict(convert.params(dataclasses.asdict(jp))) == \
        dataclasses.asdict(tp)
    eng_j, eng = JMCL3DL(jp), MCL3DL(tp, device="cpu")
    # the JAX engine keeps no aux: read each step's from its jitted step
    jaux = []
    results = {}
    for name, e in (("jax", eng_j), ("port", eng)):
        e.load_map(worlds.world_map())
        if e is eng_j:
            step = e._step
            e._step = lambda *a: jaux.append(step(*a)) or jaux[-1]
        e.initial_pose(np.zeros(3), ao.IDENT, worlds.TRACKING_COV)
        rng = np.random.default_rng(0)
        out = []
        for i in range(N_SCANS + 1):
            t = 0.1 * (i + 1)
            e.odometry(np.zeros(3), ao.IDENT, t)
            res = e.push_cloud("lidar", worlds.scan(rng, 512), ao.ORIGIN, t)
            if res is not None:
                aux = jaux[-1][-1] if e is eng_j else e.last_aux
                out.append((int(aux["tier_like"]), int(aux["tier_beam"]), res))
        results[name] = out
    tiers = {k: [(a, b) for a, b, _ in v] for k, v in results.items()}
    assert tiers["port"] == tiers["jax"] == [(2, 2)] * N_SCANS
    last = {k: v[-1][2] for k, v in results.items()}
    for k, res in last.items():
        pos_err, rot_err = _err(res)
        assert pos_err < 0.05 and rot_err < 0.05, (k, res.pos, res.rot)
    assert np.linalg.norm(last["port"].pos - last["jax"].pos) < 0.05
    # the output_pcd accumulation: one map-frame scan a measurement
    assert len(eng._pc_all_accum) == N_SCANS == len(eng_j._pc_all_accum)


def test_all_options_drive_on_the_cpu(tmp_path):
    """``tools/all_options.run`` (phase 9) at 1,024 particles and 256-point
    scans: the checkpointed engine stays equal bit for bit, the map update
    grows the grid, tiers 2/2 throughout, the PCD reads back and the
    inspection calls return the JAX engine's shapes and dtypes."""
    make = lambda: ao.engine("cpu", 1024)    # noqa: E731
    eng = make()
    lines = []
    out = ao.run(eng, make, np.random.default_rng(1), 256, log=lines.append,
                 out_dir=str(tmp_path))
    assert set(out["tiers"]) == {(2, 2)}
    assert len(out["tiers"]) == ao.N_SCANS + ao.N_AFTER
    assert "equal bit for bit" in lines[0] and "update_map" in lines[1]
    assert out["pcd_points"] == out["pcd_read"] > 0
    assert read_pcd(tmp_path / "all_options_accumulated.pcd")[0].shape == (
        out["pcd_points"], 3)
    assert out["particles"] == (((1024, 3), np.float32),
                                ((1024, 4), np.float32), ((1024,), np.float32))
    assert out["beam_status"][:2] == ((64,), np.int64)
    assert out["diagnostics"].ok and len(out["matches"]) >= 3
    assert eng.map.df.shape[1] > 97 and eng.map.df.packed is not None
    # the checks of phase 9: horizontal and attitude error, z within the
    # DDA beam's bias, the raw pose back at the truth after the landmark
    assert out["xy_err"] < 0.05 and out["pose_err"][1] < 0.05
    assert abs(out["z"]) < ao.z_bias_bound(eng.params)
    assert max(out["raw_err_after_landmark"]) < 0.05


def _gate(steps):
    result = run_tier3.run_all(steps=steps, device="cpu", interp="trilinear")
    assert result["interp"] == "trilinear"
    ref = json.loads((ROOT / "docs" / "TIER3_GATE_TRILINEAR.json").read_text())
    for name in ("with_imu", "no_imu", "no_odom"):
        g = result[name]
        assert g["pose_violations"] == 0 and g["tf_violations"] == 0, (name, g)
        assert g["max_error_m"] <= ref[name]["tolerance_m"]
        assert g["max_tf_diff_m"] <= ref[name]["tf_tolerance_m"]
        assert g["pass"], (name, g)
    for name in ("with_imu", "no_imu"):
        k = result[name]["kidnap"]
        assert k["auto_expansions"] >= 1 and k["global_localization_calls"] == 1
    assert result["pass"]
    return result


def test_trilinear_gate_60_steps():
    """The three variants with ``--interp trilinear`` at 60 steps (the
    kidnap at step 24, its global-mode step sampling nearest)."""
    _gate(60)


@pytest.mark.slow
def test_trilinear_gate_full_drive():
    """The full 220-step trilinear gate on the CPU; slow only by the
    suite's budget (about half a minute)."""
    res = _gate(run_tier3.STEPS)
    assert res["with_imu"]["kidnap"]["poses_gated_after_recovery"] >= 180


def test_trilinear_gate_traces_the_sampling_choice():
    """Tier 2 (trilinear) at every tracking step, the global-mode step
    after the correlative seeding at tier 2 too (capacity 512 is not a
    tile multiple and the seeds fit no box): K1-K3 never run."""
    traces = {}
    res = run_tier3.run_all(steps=32, device="cpu", interp="trilinear",
                            traces=traces)
    tiers = {(t[0], t[1]) for t in traces["with_imu"]}
    assert tiers <= {(2, 2), (2, -1)} and (2, -1) in tiers
    assert res["with_imu"]["poses"] > 25


def test_run_replay_on_a_log(tmp_path, capsys):
    log = tier3.build_log(n_steps=12, kidnap_step=-1)
    log_path = tmp_path / "log.npz"
    log.save(log_path)
    params = tmp_path / "params.json"
    params.write_text(json.dumps(dict(tier3.TIER3_PARAMS,
                                      **{"likelihood.interp": "trilinear"})))
    out = tmp_path / "traj.npz"
    rc = run_replay.main([str(log_path), "--params", str(params), "--out",
                          str(out), "--compare", "--cpu"])
    text = capsys.readouterr().out
    assert rc == 0, text
    gate = json.loads(text.strip().splitlines()[-1])
    assert gate["pass"] and gate["violations"] == 0
    traj = np.load(out)
    assert traj["pos"].shape[1] == 3 and len(traj["times"]) >= 10
    assert run_replay.load_params(params).likelihood.interp == "trilinear"


_NO_YAML = r"""
import sys
sys.modules["yaml"] = None
from mcl_3dl_tpu_torch.tools import run_replay
try:
    run_replay.load_params(sys.argv[1])
except RuntimeError as e:
    print("RAISED:" + str(e))
"""


def test_run_replay_yaml_without_pyyaml_raises(tmp_path):
    path = tmp_path / "p.yaml"
    path.write_text("num_particles: 64\n")
    out = subprocess.run([sys.executable, "-c", _NO_YAML, str(path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert "RAISED:" in out.stdout and "PyYAML" in out.stdout, out
