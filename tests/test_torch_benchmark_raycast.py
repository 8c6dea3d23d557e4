"""The port's raycast harness (``tools/benchmark_raycast.py``) against the
JAX package's (``tools/benchmark_raycast.py``) on the CPU: the same walls
world and rays, and, on a 20,000-point world and 256 rays, the same maps
and casts.

Tolerances and why (the deviations ``tests/test_torch_models.py`` and
``tests/test_torch_dda.py`` accept):
* the world and the rays: equal (numpy from the same seeds);
* the distance fields and occupancy grids: equal, the port's native build
  against JAX's numpy build (its native builder switched off);
* ``raycast_df``: hit flags equal, collision points within 1e-5 m and
  incidence sines within 1e-5, on at least 99% of rays (the sphere
  trace's step ``(d - r) / |W u|`` accumulates f32 rounding along the ray,
  so a probe can cross a cell edge on one side only);
* ``raycast_occ``: hit flags equal and collision points within one f32
  ulp at the world's 40 m extent (3.8e-6 m; ``test_torch_dda`` holds an
  ulp of its 4 m world's coordinates, 1e-6 m: ``origin + (i + q / 255) *
  cell`` divides in the port where XLA may multiply by a reciprocal) on at
  least 99% of rays, and every ray that differs a boundary ray, found in
  float64 (``test_torch_dda._boundary_rays``).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcl_3dl_tpu.map.native as jnative
from mcl_3dl_tpu.map.distance_field import build_distance_field as j_build_df
from mcl_3dl_tpu.map.occupancy import build_occupancy_grid as j_build_occ
from mcl_3dl_tpu.models import beam as jbeam

from test_torch_dda import _boundary_rays

from mcl_3dl_tpu_torch.tools import benchmark_raycast as tbr

torch.set_num_threads(2)   # several test workers share the CPU

ROOT = Path(__file__).resolve().parents[1]
SMALL_WORLD, SMALL_RAYS = 20_000, 256
ULP_40M = float(np.spacing(np.float32(40.0)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_benchmark_raycast", ROOT / "tools" / "benchmark_raycast.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_rays(n_rays):
    """The rays as the JAX tool's ``main`` builds them
    (tools/benchmark_raycast.py:55-64)."""
    rng = np.random.default_rng(1)
    begins = np.stack([
        rng.uniform(-35, 35, n_rays), rng.uniform(-45, 45, n_rays),
        np.full(n_rays, 1.0),
    ], axis=1).astype(np.float32)
    az = rng.uniform(-np.pi, np.pi, n_rays)
    ends = begins + np.stack(
        [4.0 * np.cos(az), 4.0 * np.sin(az), np.zeros(n_rays)], axis=1
    ).astype(np.float32)
    return begins, ends


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(jnative, "build_occupancy_rep_native",
                        lambda *a, **k: None)
    monkeypatch.setattr(jnative, "build_distance_field_native",
                        lambda *a, **k: None)


@pytest.mark.parametrize("n_points,n_rays", [(tbr.WORLD_POINTS, tbr.N_RAYS),
                                             (SMALL_WORLD, SMALL_RAYS)])
def test_world_and_rays_match_jax(n_points, n_rays):
    np.testing.assert_array_equal(tbr.make_world(n_points),
                                  _jax_tool().make_world(n_points))
    for got, want in zip(tbr.make_rays(n_rays), _jax_rays(n_rays)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _small():
    world = tbr.make_world(SMALL_WORLD)
    begins, ends = tbr.make_rays(SMALL_RAYS)
    return world, begins, ends, torch.as_tensor(begins), torch.as_tensor(ends)


@pytest.mark.parametrize("cell", tbr.DF_CELLS)
def test_raycast_df_matches_jax(no_native, cell):
    world, begins, ends, b, e = _small()
    jdf = j_build_df(world, cell, tbr.TRUNC)
    tdf = tbr.build_distance_field(world, cell, tbr.TRUNC, device="cpu")
    np.testing.assert_array_equal(tdf.field.numpy(), np.asarray(jdf.field))
    np.testing.assert_array_equal(tdf.origin.numpy(), np.asarray(jdf.origin))
    found, cpos, sin_ang = tbr.raycast_df(tdf, b, e, cell, cell,
                                          tbr.HIT_TOLERANCE, tbr.DF_STEPS)
    jfound, jcpos, jsin = jbeam.raycast_df(
        jdf, jnp.asarray(begins), jnp.asarray(ends), cell, cell,
        tbr.HIT_TOLERANCE, tbr.DF_STEPS)
    same = ((found.numpy() == np.asarray(jfound))
            & np.all(np.abs(cpos.numpy() - np.asarray(jcpos)) <= 1e-5, -1)
            & (np.abs(sin_ang.numpy() - np.asarray(jsin)) <= 1e-5))
    assert same.mean() >= 0.99, same.mean()
    assert 0.05 < found.float().mean() < 0.95   # hits and misses both present


@pytest.mark.parametrize("cell", tbr.OCC_CELLS)
def test_raycast_occ_matches_jax(no_native, cell):
    world, begins, ends, b, e = _small()
    jocc = j_build_occ(world, cell)
    tocc = tbr.build_occupancy_grid(world, cell, device="cpu")
    np.testing.assert_array_equal(tocc.occupied.numpy(),
                                  np.asarray(jocc.occupied))
    np.testing.assert_array_equal(tocc.rep_point.numpy(),
                                  np.asarray(jocc.rep_point))
    found, cpos, _ = tbr.raycast_occ(tocc, b, e, tbr.HIT_TOLERANCE,
                                     0xFFFFFFFF, tbr.OCC_STEPS)
    jfound, jcpos, _ = jbeam.raycast_occ(
        jocc, jnp.asarray(begins), jnp.asarray(ends), tbr.HIT_TOLERANCE,
        0xFFFFFFFF, tbr.OCC_STEPS)
    same = ((found.numpy() == np.asarray(jfound))
            & np.all(np.abs(cpos.numpy() - np.asarray(jcpos)) <= ULP_40M, -1))
    assert same.mean() >= 0.99, same.mean()
    boundary = _boundary_rays(jocc, begins, ends, tbr.OCC_STEPS, 0.0, 0.0)
    assert not (~same & ~boundary).any(), np.argwhere(~same & ~boundary)
    assert 0.05 < found.float().mean() < 0.95


def test_run_rehearses_every_row_on_the_cpu():
    lines = []
    rows = tbr.run("cpu", n_points=SMALL_WORLD, n_rays=SMALL_RAYS, reps=1,
                   log=lines.append)
    assert [r["name"] for r in rows] == [
        "DF cell=0.2", "DF cell=0.4", "DDA grid=0.2", "DDA grid=0.5"]
    for r in rows:
        assert r["build_s"] > 0 and r["cast_ms"] > 0
        assert r["cast_ms_no_early_exit"] > 0 and 0 < r["hit_share"] < 1
        assert r["device"].startswith("no card")
    assert len(lines) == 5
