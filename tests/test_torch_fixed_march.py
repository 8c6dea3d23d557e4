"""The beam model's fixed march: the port's plain ``raycast_fixed`` (kernel
M1's plain version, ``models/beam.py``) against the JAX package's
``raycast_fixed`` (``lax.fori_loop``) on ``[cap, B]`` rays over the
flagship world's beam field, built from numpy-seeded particles and scan
points as the overflow rescore builds them; and the wrapper
``march_fixed``, which takes the plain version for CPU tensors.

Tolerances and why:
* rays with a probe within 1e-4 cell of a .5 rounding boundary, or a
  probe limit ``(|ray| + tol) / grid`` within 1e-4 of an integer, both
  found in float64, are left out (the standing boundary-rounding
  deviation: XLA:CPU contracts ``begin + dir * t`` into an FMA inside the
  jitted loop body, eager torch does not, so such a probe may read the
  neighbouring cell); at least 95% of the rays remain;
* on the others ``found`` is equal, and ``cpos`` and ``sin_ang`` agree
  to atol 1e-5: the unit direction comes from ``jnp.linalg.norm`` on one
  side and ``torch.linalg.vector_norm`` on the other, which may differ in
  the last ulp, and the collision point is ``begin + dir * t_hit``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mcl_3dl_tpu.map.distance_field import DistanceField as JDistanceField
from mcl_3dl_tpu.math import quat as jq
from mcl_3dl_tpu.models import beam as jbeam

from mcl_3dl_tpu_torch import Params, worlds
from mcl_3dl_tpu_torch.engine import beam_num_steps
from mcl_3dl_tpu_torch.map.map_data import MapData
from mcl_3dl_tpu_torch.models import beam as tbeam

torch.set_num_threads(2)   # several test workers share the CPU

CAP = 1024
BEAMS = 3
WINDOW = 1e-4


@pytest.fixture(scope="module")
def world():
    params = Params()
    m = MapData.build(worlds.world_map(), params, device="cpu")
    df = m.df_beam
    jdf = JDistanceField(field=jnp.asarray(df.field.numpy()),
                         origin=jnp.asarray(df.origin.numpy()),
                         cell=df.cell, trunc=df.trunc, weights=df.weights)
    rng = np.random.default_rng(3)
    pos = np.stack([rng.normal(0, 0.1, CAP), rng.normal(0, 0.1, CAP),
                    rng.normal(0, 0.05, CAP)], axis=1).astype(np.float32)
    rpy = np.stack([rng.normal(0, 0.05, CAP), rng.normal(0, 0.05, CAP),
                    rng.normal(0, 0.1, CAP)], axis=1).astype(np.float32)
    rot = np.asarray(jq.from_rpy(jnp.asarray(rpy)), np.float32)
    rmat = np.asarray(jq.rotation_matrix(jnp.asarray(rot)), np.float32)
    pts = worlds.scan(rng, 64)[:BEAMS].astype(np.float32)
    org = np.array([0.0, 0.0, worlds.SENSOR_Z], np.float32)
    begins = (np.einsum("cij,j->ci", rmat, org)[:, None, :]
              + pos[:, None, :]).astype(np.float32)
    begins = np.repeat(begins, BEAMS, axis=1)
    ends = (np.einsum("cij,bj->cbi", rmat, pts) + pos[:, None, :]).astype(
        np.float32)
    return params, df, jdf, begins, ends


def _boundary_rays(df, begins, ends, grid, tol, num_steps):
    """Rays with a probe (1 <= i < min(l_b, num_steps)) within WINDOW cell
    of a .5 boundary, or a probe limit within WINDOW of an integer, in
    float64."""
    b = begins.astype(np.float64)
    seg = ends.astype(np.float64) - b
    length = np.linalg.norm(seg, axis=-1)
    direction = seg / np.maximum(length, 1e-12)[..., None]
    lim = (length + tol) / grid
    near = np.abs(lim - np.round(lim)) < WINDOW
    w = np.asarray(df.weights, np.float64)
    org = df.origin.numpy().astype(np.float64)
    l_b = np.floor(lim)
    for i in range(1, num_steps):
        q = b + direction * (i * grid)
        u = (q * w - org) / df.cell
        on = (np.abs(u - np.floor(u) - 0.5) < WINDOW).any(axis=-1)
        near |= on & (i < l_b)
    return near


def test_plain_raycast_fixed_matches_jax(world):
    params, df, jdf, begins, ends = world
    grid, gmax = params.map_grid_min, params.map_grid_max
    tol = params.beam.hit_range
    steps = beam_num_steps(params)
    got = tbeam.raycast_fixed(df, torch.as_tensor(begins),
                              torch.as_tensor(ends), grid, gmax, tol, steps)
    want = jbeam.raycast_fixed(jdf, jnp.asarray(begins), jnp.asarray(ends),
                               grid, gmax, tol, steps)
    found, cpos, sin_ang = (g.numpy() for g in got)
    jfound, jcpos, jsin = (np.asarray(w) for w in want)
    keep = ~_boundary_rays(df, begins, ends, grid, tol, steps)
    assert keep.mean() >= 0.95, keep.mean()
    assert 0.1 < found[keep].mean() < 0.9     # hits and misses both occur
    np.testing.assert_array_equal(found[keep], jfound[keep])
    np.testing.assert_allclose(cpos[keep], jcpos[keep], atol=1e-5, rtol=0)
    np.testing.assert_allclose(sin_ang[keep], jsin[keep], atol=1e-5, rtol=0)


def test_march_fixed_takes_the_plain_version_on_the_cpu(world):
    params, df, _, begins, ends = world
    args = (df, torch.as_tensor(begins), torch.as_tensor(ends),
            params.map_grid_min, params.map_grid_max, params.beam.hit_range,
            beam_num_steps(params))
    before = tbeam.march_fixed.launches
    got = tbeam.march_fixed(*args)
    want = tbeam.raycast_fixed(*args)
    assert tbeam.march_fixed.plain is tbeam.raycast_fixed
    assert tbeam.march_fixed.launches == before     # no kernel launched
    for a, b in zip(got, want):
        assert torch.equal(a, b)
