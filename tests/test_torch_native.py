"""The port's native map compiler (``mcl_3dl_tpu_torch/map/native.py``,
``csrc/map_builder.cpp``, built by ``ops/build.py::build_map`` with this
host's C++ compiler) on the CPU.

Tolerances and why:
* the native distance field and occupancy arrays against the port's
  numpy builds (``native=False``): byte-equal, by construction (the same
  operations in the same order, halves rounded to even, no contraction);
* against the JAX package's native builder (``native/libmcl3dl_native.so``,
  built with ``-march=native``, which contracts ``a*b + c``): within one
  code on every cell, equal on the flagship world; a cell that differs is
  the contraction's, never the port's;
* ``MapData.build`` on both paths against the JAX package's numpy build:
  byte-equal (its native builder switched off).
"""

import functools
import subprocess
import sys

import numpy as np
import pytest

import mcl_3dl_tpu.map.native as jnative
from mcl_3dl_tpu.config import BeamParams as JBeamParams
from mcl_3dl_tpu.config import Params as JParams
from mcl_3dl_tpu.map.map_data import MapData as JMapData

from mcl_3dl_tpu_torch import worlds
from mcl_3dl_tpu_torch.config import BeamParams, Params
from mcl_3dl_tpu_torch.map import distance_field, native, occupancy
from mcl_3dl_tpu_torch.map.map_data import MapData
from mcl_3dl_tpu_torch.ops import build

CELL, TRUNC = 0.1, 0.5


def _on_half_boundaries():
    """Points whose base cell ``(p - origin) / cell`` is exactly k + 0.5:
    cell 0.25, trunc 0.5, so the origin is min - 0.75 = -0.75 and every
    coordinate ``j * 0.25 + 0.125`` sits on a half (all exact in binary)."""
    j = np.arange(24, dtype=np.float64)
    pts = np.stack([j * 0.25 + 0.125, (j % 5) * 0.25 + 0.125,
                    (j % 3) * 0.25 + 0.125], axis=1)
    return np.concatenate([np.zeros((1, 3)), pts]), 0.25, 0.5


def _on_cell_centres():
    """Points on cell centres ``origin + idx * cell`` of the grid the
    build derives (origin = min - trunc - cell)."""
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 30, (300, 3))
    cell, trunc = 0.125, 0.375
    pts = idx * cell
    pts[0] = 0.0
    return pts, cell, trunc


MAPS = {
    "flagship": lambda: (worlds.world_map(), CELL, TRUNC),
    "room": lambda: (worlds.make_room(grid=0.15), CELL, TRUNC),
    "room_ceiling": lambda: (worlds.make_room(-2.0, 2.0, -2.0, 2.0, grid=0.1,
                                              with_ceiling=True), CELL, TRUNC),
    # df_cell_size 0.05 (with the z2 weights: dist_weight_z 2.0)
    "room_fine": lambda: (worlds.make_room(-2.0, 2.0, -2.0, 2.0, grid=0.1,
                                           with_ceiling=True), 0.05, 0.6),
    "random_0": lambda: (np.random.default_rng(0).uniform(-3, 3, (3000, 3)),
                         CELL, 0.4),
    "random_1": lambda: (np.random.default_rng(1).normal(0, 2, (2000, 3)),
                         0.07, 0.3),
    "negative": lambda: (np.random.default_rng(2).uniform(-9, -1, (1500, 3)),
                         CELL, TRUNC),
    "half_boundaries": _on_half_boundaries,
    "cell_centres": _on_cell_centres,
    "one_point": lambda: (np.array([[0.3, -0.2, 1.1]]), CELL, TRUNC),
    "empty": lambda: (np.zeros((0, 3)), CELL, TRUNC),
}


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0), (1.0, 1.0, 2.0)],
                         ids=["iso", "z2"])
@pytest.mark.parametrize("world", sorted(MAPS))
def test_native_field_equals_numpy_build(world, weights):
    pts, cell, trunc = MAPS[world]()
    got, got_origin = distance_field.build_field_codes(pts, cell, trunc,
                                                       weights)
    want, want_origin = distance_field.build_field_codes(
        pts, cell, trunc, weights, native=False)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_origin, want_origin)
    if len(pts):
        assert (got < 255).any()


def test_native_field_equals_numpy_build_on_a_given_grid():
    """The beam field's form: a subset of the points on the likelihood
    field's grid (``grid=``), at dist_weight_z 2 and a 0.05 cell."""
    pts = worlds.make_room(-2.0, 2.0, -2.0, 2.0, grid=0.1, with_ceiling=True)
    w = (1.0, 1.0, 2.0)
    codes, origin = distance_field.build_field_codes(pts, 0.05, 0.6, w)
    grid = (origin, codes.shape)
    sub = pts[::3]
    got, _ = distance_field.build_field_codes(sub, 0.05, 0.6, w, grid=grid)
    want, _ = distance_field.build_field_codes(sub, 0.05, 0.6, w, grid=grid,
                                               native=False)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", ["flagship", "labelled", "random", "empty"])
def test_native_occupancy_equals_numpy_build(world):
    rng = np.random.default_rng(5)
    labels = None
    if world == "flagship":
        pts = worlds.world_map()
    elif world == "labelled":
        pts = np.concatenate([worlds.world_map(),
                              rng.uniform(-3.0, 3.0, (500, 3))])
        labels = rng.integers(0, 20, len(pts)).astype(np.uint32)
    elif world == "random":
        pts = rng.normal(0.0, 1.5, (4000, 3))
        labels = rng.integers(0, 2 ** 32, len(pts), dtype=np.uint64)
    else:
        pts = np.zeros((0, 3))
    got = occupancy.build_occupancy_arrays(pts, 0.2, labels)
    want = occupancy.build_occupancy_arrays(pts, 0.2, labels, native=False)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_threads", [1, 3, 8])
def test_field_bytes_do_not_depend_on_threads(n_threads):
    pts = worlds.make_room(-3.0, 3.0, -3.0, 3.0, grid=0.1) * (1.0, 1.0, 2.0)
    codes, origin = distance_field.build_field_codes(pts, CELL, TRUNC)
    dims = codes.shape
    got = native.build_distance_field_native(pts, CELL, TRUNC, origin, dims,
                                             n_threads=n_threads)
    want = native.build_distance_field_native(pts, CELL, TRUNC, origin, dims,
                                              n_threads=2)
    assert got.dtype == np.float32 and got.shape == dims
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("world", ["flagship", "room_ceiling", "random_0",
                                   "half_boundaries"])
def test_native_field_within_one_code_of_jax_native(world):
    """JAX's committed library is built with ``-march=native`` (contracted
    ``a*b + c``): at most one code apart, equal on the flagship world."""
    if not jnative.native_available():
        pytest.skip("the JAX package's native library is not available")
    pts, cell, trunc = MAPS[world]()
    codes, origin = distance_field.build_field_codes(pts, cell, trunc)
    field = jnative.build_distance_field_native(
        np.asarray(pts, np.float64), cell, trunc, origin, codes.shape)
    jcodes = np.clip(np.round(field / trunc * 255.0), 0, 255).astype(np.uint8)
    diff = np.abs(codes.astype(np.int16) - jcodes)
    assert diff.max() <= 1
    if world == "flagship":
        np.testing.assert_array_equal(codes, jcodes)


def _numpy_port(monkeypatch):
    """Switch the port's map builds to their numpy versions."""
    monkeypatch.setattr(distance_field, "build_field_codes", functools.partial(
        distance_field.build_field_codes, native=False))
    monkeypatch.setattr(occupancy, "build_occupancy_arrays", functools.partial(
        occupancy.build_occupancy_arrays, native=False))
    monkeypatch.setattr(native, "_load", lambda: pytest.fail(
        "the numpy path reached the native library"))


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_map_data_equals_jax_numpy_build(monkeypatch, path):
    """``MapData.build`` (df, df_beam on its grid, the occupancy grid) on
    the flagship world with labels that make the beam field differ, by
    the port's native builder (its default) and by its numpy build."""
    monkeypatch.setattr(jnative, "build_distance_field_native",
                        lambda *a, **k: None)
    monkeypatch.setattr(jnative, "build_occupancy_rep_native",
                        lambda *a, **k: None)
    if path == "numpy":
        _numpy_port(monkeypatch)
    pts = worlds.world_map()
    labels = np.random.default_rng(4).integers(0, 3, len(pts)).astype(
        np.uint32)
    jm = JMapData.build(pts, JParams(beam=JBeamParams(filter_label_max=1)),
                        labels)
    tm = MapData.build(pts, Params(beam=BeamParams(filter_label_max=1)),
                       labels, device="cpu")
    assert tm.df_beam is not tm.df
    for tdf, jdf in ((tm.df, jm.df), (tm.df_beam, jm.df_beam)):
        np.testing.assert_array_equal(tdf.field.numpy(), np.asarray(jdf.field))
        np.testing.assert_array_equal(tdf.origin.numpy(),
                                      np.asarray(jdf.origin))
    np.testing.assert_array_equal(tm.df.packed.numpy().view(np.uint32),
                                  np.asarray(jm.df.packed))
    np.testing.assert_array_equal(tm.occ.occupied.numpy(),
                                  np.asarray(jm.occ.occupied))
    np.testing.assert_array_equal(tm.occ.min_label.numpy(),
                                  np.asarray(jm.occ.min_label).astype(np.int64))
    np.testing.assert_array_equal(tm.occ.rep_point.numpy(),
                                  np.asarray(jm.occ.rep_point))


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """An empty build root under ``tmp_path`` and no library bound."""
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "torch_kernels")
    monkeypatch.setattr(native, "_funcs", None)
    return tmp_path


def test_build_map_compiles_once_into_its_hash(fresh_build):
    lib = build.build_map()
    assert lib.name == "libmcl3dl_map.so"
    assert lib.parent.parent == build.BUILD_ROOT
    assert lib.parent.name.startswith("map_") and len(lib.parent.name) == 20
    assert build.seconds["map"] > 0.0
    assert list(lib.parent.iterdir()) == [lib]           # work dir gone
    assert "-ffp-contract=off" in build.MAP_FLAGS
    assert not [f for f in build.MAP_FLAGS if f.startswith("-march")]
    assert build.build_map() == lib and "map" not in build.seconds
    assert native.native_available()


_FAKE_CXX = """#!/bin/sh
if [ "$1" = "--version" ]; then echo "fake-c++ 1.0"; exit 0; fi
echo "fake-c++: error: cannot compile map_builder.cpp"
exit 1
"""


@pytest.mark.parametrize("compiler", ["false", "fails_compile"])
def test_failed_compiler_raises_and_nothing_falls_back(fresh_build,
                                                       monkeypatch, compiler):
    if compiler == "false":
        cxx, match = "/bin/false", "--version failed"
    else:
        cxx = fresh_build / "fake-c++"
        cxx.write_text(_FAKE_CXX)
        cxx.chmod(0o755)
        cxx, match = str(cxx), "cannot compile map_builder.cpp"
    monkeypatch.setattr(build, "_host_cxx", lambda: cxx)
    pts = worlds.world_map()
    with pytest.raises(RuntimeError, match=match):
        distance_field.build_field_codes(pts, CELL, TRUNC)
    with pytest.raises(RuntimeError, match=match):
        occupancy.build_occupancy_arrays(pts, 0.2)
    with pytest.raises(RuntimeError, match=match):
        MapData.build(pts, Params(), device="cpu")
    assert native._funcs is None
    assert not list(build.BUILD_ROOT.rglob("*.so"))


_CHILD = r"""
import os, pathlib, sys, time
from mcl_3dl_tpu_torch.ops import build
build.BUILD_ROOT = pathlib.Path(sys.argv[1])
go = pathlib.Path(sys.argv[2])
print("ready", flush=True)
while not go.exists():
    time.sleep(0.01)
print("LIB:" + str(build.build_map()), flush=True)
"""


def test_two_processes_build_into_an_empty_root_at_once(tmp_path):
    root, go = tmp_path / "torch_kernels", tmp_path / "go"
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(root),
                               str(go)], cwd=build.CSRC.parents[1],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    try:
        for p in procs:                       # both imported and waiting
            assert p.stdout.readline().strip() == "ready"
        go.touch()
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    libs = set()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        libs.add(out.strip().splitlines()[-1])
    assert len(libs) == 1
    lib = libs.pop()
    assert lib.startswith("LIB:") and lib.endswith("libmcl3dl_map.so")
    built = list(root.rglob("*"))
    assert [f.name for f in built if f.is_file()] == ["libmcl3dl_map.so"]


def test_native_field_equals_numpy_build_on_a_large_map_slab():
    """A 400k-point room (cell 0.1, trunc 0.3, the grid split over every
    hardware thread), byte-equal to the numpy build on a slab of it."""
    pts = worlds.make_room(-15.0, 15.0, -15.0, 15.0, grid=0.05)
    codes, origin = distance_field.build_field_codes(pts, 0.1, 0.3)
    slab = pts[pts[:, 0] < -13.0]
    grid = (origin, codes.shape)
    got, _ = distance_field.build_field_codes(slab, 0.1, 0.3, grid=grid)
    want, _ = distance_field.build_field_codes(slab, 0.1, 0.3, grid=grid,
                                               native=False)
    np.testing.assert_array_equal(got, want)
