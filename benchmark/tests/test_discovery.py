"""The harness finds configurations, traffic mixes, the drives that
generate them, per-layer metrics and roofline counts by name from files
of their own: a new file of each
kind dropped into a copy is picked up with no edit to a file that is
there.  And ``BENCHMARK.json`` keeps to the names, units and keys the
benchmark's contract allows."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ONE_LINE = re.compile(r"^[^\t\n\r]{1,200}$")


@pytest.fixture
def copy(tmp_path):
    """A copy of the benchmark's folder with one new file of each kind."""
    base = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    cfg = json.loads((base / "configs" / "flagship-1M.json").read_text())
    cfg.update(name="flagship-64k", cloud_points=2048)
    (base / "configs" / "flagship-64k.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "tracking.json").read_text())
    mix.update(radius_m=0.8)
    (base / "traffic" / "slow_circle.json").write_text(json.dumps(mix))
    (base / "drives" / "parked.py").write_text(
        "LOOP = 'single'\n\n\ndef make(mix, cfg, seed):\n"
        "    return [mix['spot'], cfg['cloud_points'], seed]\n")
    (base / "metrics" / "scans_seen.py").write_text(
        "def read(trace):\n    return float(trace['scans']) or None\n")
    (base / "roofline" / "k2.py").write_text(
        "KERNEL = 'beam_pen_kernel'\n\n\ndef launch(shapes):\n"
        "    return shapes['particles'] * 64, 0\n")
    return base, before


def test_new_files_are_found(copy):
    base, before = copy
    assert harness.config("flagship-64k", base)["cloud_points"] == 2048
    assert harness.traffic("slow_circle", base)["radius_m"] == 0.8
    assert harness.metric_reader("scans_seen", base)({"scans": 3}) == 3.0
    parked = harness.drive("parked", base)
    assert parked.LOOP == "single"
    assert parked.make({"spot": 1}, {"cloud_points": 8}, 3) == [1, 8, 3]
    k2 = harness.roofline("k2", base)
    assert k2.launch({"particles": 2}) == (128, 0)
    for path, data in before.items():
        assert path.read_bytes() == data, f"{path} changed"


def test_new_cell_and_metric_entries_are_read(copy, tmp_path):
    base, _ = copy
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(
        name="flagship-64k.slow_circle", config="flagship-64k",
        traffic="slow_circle", chips=1, why="a later cell"))
    bench["end_to_end"].append(dict(
        name="updates_per_s.slow_circle", unit="updates/s", better="higher",
        bound=0.2, source="host_clock",
        workloads=["flagship-64k.slow_circle"]))
    bench["per_layer"].append(dict(
        name="scans_seen", unit="scans", better="higher",
        source="program_counter", layer="engine.py host shell",
        moves="updates_per_s.slow_circle",
        workloads=["flagship-64k.slow_circle"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    loaded = harness.load_benchmark(tmp_path)
    w = harness.workload(loaded, "flagship-64k.slow_circle")
    assert harness.config(w["config"], base)["name"] == "flagship-64k"
    names = [m["name"] for m in harness.per_layer_for(loaded, w["name"])]
    assert names == ["scans_seen"]
    assert [m["name"] for m in harness.end_to_end_for(loaded, w["name"])] \
        == ["setup_s", "updates_per_s.slow_circle"]


def test_a_metric_split_by_cells_takes_its_base_reader(copy):
    base, _ = copy
    assert harness.metric_reader("graph_share.slow_circle", base)(
        {"routes": {"graph": 1, "graph_front": 3}}) \
        == harness.metric_reader("graph_share", base)(
            {"routes": {"graph": 1, "graph_front": 3}})
    assert harness.metric_reader("scans_seen.slow_circle", base)(
        {"scans": 3}) == 3.0
    with pytest.raises(FileNotFoundError):
        harness.metric_reader("no_such_metric.fleet", base)


def test_every_file_the_cells_name_exists():
    for w in BENCH["workloads"]:
        assert harness.config(w["config"])["name"] == w["config"]
        drive = harness.drive(harness.traffic(w["traffic"])["drive"])
        assert drive.LOOP in ("single", "fleet") and callable(drive.make)
        assert harness.limits(w["name"])
    for m in BENCH["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end",
                                 "per_layer"])
def test_names_and_units(key):
    names = [e["name"] for e in BENCH[key]]
    assert len(names) == len(set(names))
    for e in BENCH[key]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert ONE_LINE.match(e[k]), e[k]
        if key == "configs":
            assert all(NAME.match(r) for r in e["reduced"])


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_each_metric_moves_what_its_cells_report():
    for m in BENCH["per_layer"]:
        cells = m.get("workloads", [w["name"] for w in BENCH["workloads"]])
        for cell in cells:
            reported = [e["name"] for e in harness.end_to_end_for(BENCH, cell)]
            assert m["moves"] in reported, (m["name"], cell)
    for w in BENCH["workloads"]:
        e2e = [e["name"] for e in harness.end_to_end_for(BENCH, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.per_layer_for(BENCH, w["name"])
