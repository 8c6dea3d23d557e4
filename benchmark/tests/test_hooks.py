"""The hooks a new deployment needs, each added as new files only: a
reference step named by the configuration or the mix
(``references/<name>.py``), clouds from several sensors (a message's
``frame``, folded together as ``accum_cloud`` says) and the ``global``
message.  And with none of them in use, every existing cell compares
exactly as the single-cloud reference step always did.

Small sizes on the CPU, as ``test_harness_reference``; the new cells live
in a copy of the benchmark's folder beside a ``BENCHMARK.json`` of their
own, and the copied files are left as they were.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import cells, check, harness, run, traffic
from benchmark.reference import cloud as rc
from benchmark.reference import field as rf
from benchmark.tests.test_harness_reference import SMALL, SMALL_FLEET, SOUND

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 4242
QUIET = dict(log=lambda m: None)

ECHO = '''"""A reference step of its own: the default one, counted."""
from benchmark import check
from benchmark.reference import field as rf

CALLS = []


def build(map_points, model, device):
    CALLS.append("build")
    return rf.build(map_points, check.field_config(model), device)


def step(field, model, rec, device, dtype):
    CALLS.append(dtype)
    return check.reference_step(field, model, rec, device, dtype)
'''

# two LIDARs: each scan's cloud split into a front half and a rear half,
# the rear sensor 5 cm below the front one
DUAL = '''from benchmark import harness
from benchmark.traffic import Lap, Message

LOOP = "single"


def make(mix, cfg, seed):
    lap = harness.drive("circle").make(mix, cfg, seed)
    out = []
    for m in lap.messages:
        if m.kind != "cloud":
            out.append(m)
            continue
        half = len(m.a) // 2
        out.append(Message("cloud", m.t, m.a[:half], m.b, "front"))
        rear = m.b.copy()
        rear[2] -= 0.05
        out.append(Message("cloud", m.t, m.a[half:], rear, "rear"))
    return Lap(out, lap.duration, lap.truth)
'''

# one global-localization call just before the lap's scan ``global_at``
WITH_GLOBAL = '''from benchmark import harness
from benchmark.traffic import Lap, Message

LOOP = "single"


def make(mix, cfg, seed):
    lap = harness.drive("circle").make(mix, cfg, seed)
    out, clouds = [], 0
    for m in lap.messages:
        if m.kind == "cloud":
            if clouds == mix["global_at"]:
                out.append(Message("global", m.t, None, None))
            clouds += 1
        out.append(m)
    return Lap(out, lap.duration, lap.truth)
'''


def parent_prepare(points_base, origin_base, leaf, device):
    """``reference.cloud.prepare`` of one sensor, as it was."""
    pts = rf.voxel_downsample(points_base, leaf)
    n = pts.shape[0]
    cap = rc.bucket(max(n, 1))
    cloud = np.zeros((cap, 3), np.float32)
    cloud[:n] = pts
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return rc.Cloud(torch.as_tensor(cloud, device=device),
                    torch.zeros(cap, dtype=torch.int64, device=device),
                    torch.as_tensor(valid, device=device),
                    torch.as_tensor(np.asarray(origin_base, np.float32)
                                    .reshape(1, 3), device=device))


def parent_raw(points_base, origin_base, device):
    """``reference.cloud.raw`` of one sensor, as it was."""
    p = torch.as_tensor(np.asarray(points_base, np.float32), device=device)
    n = p.shape[0]
    return rc.Cloud(p, torch.zeros(n, dtype=torch.int64, device=device),
                    torch.ones(n, dtype=torch.bool, device=device),
                    torch.as_tensor(np.asarray(origin_base, np.float32)
                                    .reshape(1, 3), device=device))


def parent_reference_step(field, model, rec, device, dtype=torch.float32):
    """``check.reference_step`` as it was before clouds were accumulated:
    one cloud a step, ``rec["cloud"]`` that cloud."""
    lp, bp, fp = model["likelihood"], model["beam"], model["filter"]
    pts, origin, odom = rec["cloud"]
    odom_pos, odom_rot = (np.asarray(v, np.float32) for v in odom)
    base, org = rc.to_base(pts, origin, odom_pos, odom_rot)
    if model["scan_leaf"] is None:
        cl = parent_raw(base, org, device)
    else:
        cl = parent_prepare(base, org, model["scan_leaf"], device)
    like_keep, beam_keep = rc.keeps(cl, lp, bp)
    state = {k: v.to(device) for k, v in rec["state"].items()}
    cap = state["pos"].shape[0]
    d = rc.draws(rec["gen_state"], device, like_keep, beam_keep,
                 lp["num_points"], bp["num_points"], cap)
    like_valid = torch.full((lp["num_points"],), bool(like_keep.any()),
                            device=device)
    beam_valid = torch.full((bp["num_points"],), bool(beam_keep.any()),
                            device=device)
    from benchmark.reference import filter as rfl
    from benchmark.reference import models as rm
    score_l, _ = rm.likelihood(field, state["pos"], state["rot"],
                               cl.points[d.like_idx], like_valid, lp, dtype)
    score_b = rm.beam(field, state["pos"], state["rot"],
                      cl.points[d.beam_idx],
                      cl.origins[cl.labels[d.beam_idx]], beam_valid, bp,
                      sphere=rec["tier_beam"] == 2, dtype=dtype)
    answer = rfl.tail(state, score_l.double() * score_b.double(), fp,
                      torch.as_tensor(odom_pos, device=device),
                      torch.as_tensor(odom_rot, device=device),
                      rec["prev_pos"].to(device), rec["prev_rot"].to(device),
                      tuple(t.to(device) for t in rec["f_pos"]),
                      tuple(t.to(device) for t in rec["f_ang"]))
    scale = torch.tensor(fp["odom_noise_scale"], dtype=torch.float32,
                         device=device)
    noise = d.noise_normals.float() * scale
    return {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in answer.items()}, noise


def _records(monkeypatch):
    """Keep the records each run hands to ``check.compare``."""
    kept = []
    compare = check.compare

    def keeping(records, *a, **k):
        kept.append(records)
        return compare(records, *a, **k)

    monkeypatch.setattr(check, "compare", keeping)
    return kept


CELLS = {
    "flagship-1M.tracking": (SMALL, {"warmup_scans": 2}),
    "flagship-1M.relocalize": (SMALL, {"warmup_scans": 6}),
    "fleet-1024x10k.tracking": (SMALL_FLEET, {"warmup_steps": 1}),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_existing_cells_compare_as_before(cell, monkeypatch):
    """(a) No ``reference`` key: one cloud a record, the reference's cloud
    bit for bit the single-cloud step's, every compared number equal."""
    kept = _records(monkeypatch)
    small, mix = CELLS[cell]
    out, checks, _ = run.run_cell(cell, SEED, 0.5, 0, device="cpu",
                                  overrides=small, mix_overrides=mix,
                                  limits=SOUND, **QUIET)
    assert out["correct"], checks
    (records,) = kept
    assert records
    cfg = run.merge(harness.config(harness.workload(
        harness.load_benchmark(ROOT), cell)["config"]), small)
    model = cfg["model"]
    world = traffic.world_map()
    field = rf.build(world, check.field_config(model), "cpu")
    rows = []
    for rec in records:
        assert len(rec["cloud"]) == 1
        want, noise = check.reference_step(field, model, rec, "cpu")
        old, old_noise = parent_reference_step(
            field, model, dict(rec, cloud=rec["cloud"][0]), "cpu")
        assert torch.equal(noise, old_noise)
        for k in want:
            assert np.array_equal(np.asarray(want[k]), np.asarray(old[k])), k
        rows.append(check.gaps(rec["result"], old, rec["post_noise"],
                               old_noise))
    parent = check.worst(rows)
    assert {k: checks[k][0] for k in check.NUMBERS} == parent


def test_one_cloud_builds_the_same_arrays():
    """(a) The joined cloud of one sensor is the single-cloud cloud, array
    for array, downsampled or raw."""
    g = np.random.default_rng(5)
    pts = g.normal(0.0, 2.0, (700, 3))
    origin = g.normal(0.0, 1.0, 3)
    odom = (g.normal(0.0, 1.0, 3).astype(np.float32),
            np.array([0.0, 0.0, 0.38268343, 0.9238795], np.float32))
    base, org = rc.to_base(pts, origin, *odom)
    moved = [rc.to_base(pts, origin, *odom)]
    joined = np.concatenate([b for b, _ in moved])
    orgs = np.stack([o for _, o in moved])
    labels = np.zeros(len(joined), np.int64)
    for old, new in ((parent_prepare(base, org, [0.1, 0.1, 0.05], "cpu"),
                      rc.prepare(joined, orgs, [0.1, 0.1, 0.05], "cpu",
                                 labels)),
                     (parent_raw(base, org, "cpu"),
                      rc.raw(joined, orgs, "cpu", labels))):
        for a, b in zip(old, new):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.fixture
def copy(tmp_path):
    """A copy of the benchmark's folder and of ``BENCHMARK.json``, and the
    bytes of every copied file."""
    base = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    return tmp_path, base, before


def _add(root, base, cell, config, mix, files=()):
    """A new configuration, mix and cell (``<config>.<mix>``) under the
    copy, and new modules ``(kind, name, source)``."""
    cfg_name, cfg = config
    mix_name, m = mix
    (base / "configs" / f"{cfg_name}.json").write_text(json.dumps(cfg))
    (base / "traffic" / f"{mix_name}.json").write_text(json.dumps(m))
    for kind, name, src in files:
        (base / kind).mkdir(exist_ok=True)
        (base / kind / f"{name}.py").write_text(src)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name=cell, config=cfg_name,
                                   traffic=mix_name, chips=1, why="test"))
    return bench


def _unchanged(before):
    for path, data in before.items():
        assert path.read_bytes() == data, f"{path} changed"


def _loaded(monkeypatch):
    """The reference modules the harness loads, by name."""
    got = {}
    find = harness.reference

    def keeping(name, base=harness.HERE):
        got[name] = find(name, base)
        return got[name]

    monkeypatch.setattr(harness, "reference", keeping)
    return got


def test_new_reference_is_found_by_name(copy, monkeypatch):
    """(b) A configuration, a mix and reference modules added as new files
    are found by name; the mix's ``reference`` wins over the
    configuration's, and the control calls it in bfloat16."""
    root, base, before = copy
    cfg = dict(harness.config("flagship-1M"), name="tiny", reference="cfg_ref")
    mix = dict(harness.traffic("tracking"), reference="mix_ref")
    bench = _add(root, base, "tiny.tracking", ("tiny", cfg),
                 ("tiny_mix", mix), [("references", "cfg_ref", ECHO),
                                     ("references", "mix_ref", ECHO)])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    del before[root / "BENCHMARK.json"]
    got = _loaded(monkeypatch)
    out, checks, ctl = run.run_cell(
        "tiny.tracking", SEED, 0.5, 0, device="cpu", root=root, base=base,
        overrides=SMALL, mix_overrides={"warmup_scans": 2}, limits=SOUND,
        control=True, **QUIET)
    assert out["correct"], checks
    assert not ctl["correct"], ctl
    assert set(got) == {"mix_ref"}
    calls = got["mix_ref"].CALLS
    assert calls[0] == "build"
    assert calls.count(torch.float32) == calls.count(torch.bfloat16) >= 1
    del mix["reference"]
    (base / "traffic" / "tiny_mix.json").write_text(json.dumps(mix))
    run.run_cell("tiny.tracking", SEED, 0.5, 0, device="cpu", root=root,
                 base=base, overrides=SMALL,
                 mix_overrides={"warmup_scans": 2}, limits=SOUND, **QUIET)
    assert got["cfg_ref"].CALLS[0] == "build"
    _unchanged(before)


def test_two_frames_accumulated(copy, monkeypatch):
    """(c) Two LIDARs' clouds folded two periods at a time
    (``accum_cloud`` 2): each record carries every cloud the step took,
    both sensors', and the reference agrees within ``SOUND``; with the
    last cloud alone it does not."""
    root, base, before = copy
    kept = _records(monkeypatch)
    cfg = dict(harness.config("flagship-1M"), name="dual")
    cfg["params"] = dict(cfg["params"], accum_cloud=2)
    mix = dict(harness.traffic("tracking"), drive="dual")
    bench = _add(root, base, "dual.tracking", ("dual", cfg), ("dual_mix", mix),
                 [("drives", "dual", DUAL)])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    del before[root / "BENCHMARK.json"]
    out, checks, _ = run.run_cell(
        "dual.tracking", SEED, 0.5, 0, device="cpu", root=root, base=base,
        overrides=SMALL, mix_overrides={"warmup_scans": 8}, limits=SOUND,
        **QUIET)
    assert out["correct"], checks
    assert out["failed"] == 0 and out["attempted"] >= 1
    (records,) = kept
    assert records
    half = SMALL["cloud_points"] // 2
    model = run.merge(cfg, SMALL)["model"]
    field = rf.build(traffic.world_map(), check.field_config(model),
                     "cpu")
    for rec in records:
        # front, rear, front, rear: two clouds of each sensor a step
        assert [len(c[0]) for c in rec["cloud"]] == [half] * 4
        origins = [c[1][2] for c in rec["cloud"]]
        assert origins[0] - origins[1] == pytest.approx(0.05)
        assert origins[2] - origins[3] == pytest.approx(0.05)
    last_only = []
    for rec in records:
        want, noise = check.reference_step(field, model,
                                           dict(rec, cloud=rec["cloud"][-1:]),
                                           "cpu")
        last_only.append(check.gaps(rec["result"], want, rec["post_noise"],
                                    noise))
    assert not check.within(check.worst(last_only), SOUND)
    _unchanged(before)


def test_global_message_calls_the_service(copy, monkeypatch):
    """(d) A ``global`` message reaches ``global_localization`` once, inside
    a span of its own."""
    from mcl_3dl_tpu_torch.engine import MCL3DL
    root, base, before = copy
    calls = []
    monkeypatch.setattr(MCL3DL, "global_localization",
                        lambda self: calls.append(self) or 0)
    runs = []
    single = cells.single

    def keeping(*a, **k):
        runs.append(single(*a, **k))
        return runs[-1]

    monkeypatch.setattr(cells, "single", keeping)
    cfg = dict(harness.config("flagship-1M"), name="globe")
    mix = dict(harness.traffic("tracking"), drive="with_global", global_at=2)
    bench = _add(root, base, "globe.tracking", ("globe", cfg),
                 ("globe_mix", mix), [("drives", "with_global", WITH_GLOBAL)])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    del before[root / "BENCHMARK.json"]
    out, checks, _ = run.run_cell(
        "globe.tracking", SEED, 0.5, 0, device="cpu", root=root, base=base,
        overrides=SMALL, mix_overrides={"warmup_scans": 2}, limits=SOUND,
        **QUIET)
    assert out["correct"], checks
    assert len(calls) == 1
    (r,) = runs
    assert len(r.spans["global_localization"]) == 1
    _unchanged(before)


GUARD = r'''
import functools, json, sys
from pathlib import Path
root, base = Path(sys.argv[1]), Path(sys.argv[2])
sys.path.insert(0, sys.argv[3])
import torch
from benchmark import harness, run
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
load = harness.load_benchmark
harness.load_benchmark = lambda _root: load(root)
find = harness.config
harness.config = lambda name, _base=base: find(name, _base)
run.run_cell = functools.partial(
    run.run_cell, device="cpu", root=root, base=base,
    overrides=json.loads(sys.argv[4]), mix_overrides={"warmup_scans": 2})
sys.exit(run.main(["--workload", "bad.tracking", "--seed", "5",
                   "--seconds", "0.3"]))
'''


@pytest.mark.parametrize("package", ["jax", "mcl_3dl_tpu"])
def test_reference_loading_jax_fails_the_run(copy, package):
    """A reference module that loads JAX or the JAX package makes
    ``run.py`` exit 1, naming it, and print no result."""
    root, base, _ = copy
    cfg = dict(harness.config("flagship-1M"), name="bad", reference="bad")
    src = ECHO + f"\nimport {package}  # noqa: E402,F401\n"
    bench = _add(root, base, "bad.tracking", ("bad", cfg),
                 ("tracking", harness.traffic("tracking")),
                 [("references", "bad", src)])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    p = subprocess.run([sys.executable, "-c", GUARD, str(root), str(base),
                        str(ROOT), json.dumps(SMALL)],
                       capture_output=True, text=True, timeout=600,
                       cwd=root)
    assert p.returncode == 1, p.stderr[-2000:]
    assert "JAX or the JAX package was loaded" in p.stderr
    assert package in p.stderr.splitlines()[-1]
    assert '"correct"' not in p.stdout
