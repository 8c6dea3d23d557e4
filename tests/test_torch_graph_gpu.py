"""Kernel M1 and the graphed step (``MCL3DL._step``, ``step_graph.py``) on
the card.

* M1 (``march_fixed``, ``csrc/beam_march.cu``) against its plain version
  ``raycast_fixed``: bit-equal on ``found``, ``cpos`` and ``sin_ang``, on
  rays of the flagship beam field (hits, misses, rays leaving the map,
  zero-length rays);
* 5 chained graphed steps against 5 eager ``_measurement_step`` steps on
  the same draws at 4,096 particles, every output bit-equal, with K1
  counted on every step at likelihood tier 0 and K2 and M1 on every step
  at beam tier 0, replayed or eager;
* ``initial_pose`` between graphed steps: ``push_cloud`` through the
  graphs against a twin engine stepping eagerly, bit-equal before and
  after the re-seed;
* 10 chained graphed steps of the tier-2 outcomes against 10 eager ones
  on the same draws, every output bit-equal, each step replaying graph B
  once its outcome has warmed up: trilinear sampling at 1,048,576
  particles (M4 with K2), 64 particles (no grouping: M4 and M2) and the
  DDA beam at 4,096 (K1 with M3), with the kernels counted.

Skipped without a CUDA device.  On the card, with no JAX installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graph_gpu.py
"""

import numpy as np
import pytest
import torch

from mcl_3dl_tpu_torch import worlds
from mcl_3dl_tpu_torch.config import BeamParams
from mcl_3dl_tpu_torch.engine import beam_num_steps
from mcl_3dl_tpu_torch.map.distance_field import sample_field
from mcl_3dl_tpu_torch.models.beam import (march_dda, march_fixed,
                                           march_sphere, raycast_fixed)
from mcl_3dl_tpu_torch.ops import grouped as og
from mcl_3dl_tpu_torch.tools import bench
from mcl_3dl_tpu_torch.tools.sharded import outputs_equal

N = 4096
STEPS = 5
IDENT = np.array([0.0, 0.0, 0.0, 1.0])
ORIGIN = np.array([0.0, 0.0, worlds.SENSOR_Z])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rays(rng, n, spread):
    """``n`` rays from about the sensor origin to scan points, poses
    spread by ``spread`` m (and 0.2 * spread rad of yaw)."""
    pts = worlds.scan(rng, n)
    yaw = rng.normal(0.0, 0.2 * spread, n)
    c, s = np.cos(yaw), np.sin(yaw)
    shift = np.stack([rng.normal(0, spread, n), rng.normal(0, spread, n),
                      np.zeros(n)], axis=1)
    ends = np.stack([c * pts[:, 0] - s * pts[:, 1],
                     s * pts[:, 0] + c * pts[:, 1], pts[:, 2]], axis=1)
    begins = ORIGIN[None] + shift
    return (begins + 0.0).astype(np.float32), (ends + shift).astype(np.float32)


@pytest.mark.parametrize("spread", [0.05, 1.0, 30.0])
def test_march_fixed_matches_plain(cuda, spread):
    eng, _, _ = bench.build(1024, cuda)
    p = eng.params
    begins, ends = _rays(np.random.default_rng(7), 3 * 65536 // 16, spread)
    ends[:7] = begins[:7]                     # zero-length rays
    b = torch.as_tensor(begins, device=cuda).reshape(-1, 3, 3)
    e = torch.as_tensor(ends, device=cuda).reshape(-1, 3, 3)
    args = (eng.map.df_beam, b, e, p.map_grid_min, p.map_grid_max,
            p.beam.hit_range, beam_num_steps(p))
    before = march_fixed.launches
    got = march_fixed(*args)
    want = raycast_fixed(*args)
    torch.cuda.synchronize()
    assert march_fixed.launches == before + 1
    for name, a, w in zip(("found", "cpos", "sin_ang"), got, want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert torch.equal(a, w), name
    if spread < 1.0:
        assert 0.1 < float(got[0].float().mean()) < 1.0


def _chain(step, state, args, draws):
    outs, args = [], list(args)
    for d in draws:
        out = step(state, *args, d)
        outs.append(out)
        state = out[0]
        args[10], args[11], args[8], args[9] = out[1], out[2], out[3], out[4]
    return outs


def test_graphed_steps_equal_eager_steps(cuda):
    eng, _, args = bench.build(N, cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    keeps = eng.keeps(args[2], args[4])
    draws = [eng.draw_step(*keeps, gen=gen) for _ in range(STEPS + 2)]
    # warm-up and capture at this key, off the compared chain
    _chain(eng._step, eng.pstate, args, draws[:2])
    counted = (og.grouped_like_score, og.grouped_beam_pen, march_fixed)
    for k in counted:
        k.launches = 0
    routes = dict(eng.step_routes)
    graphed = _chain(eng._step, eng.pstate, args, draws[2:])
    torch.cuda.synchronize()
    launches = [k.launches for k in counted]
    eager = _chain(eng._measurement_step, eng.pstate, args, draws[2:])
    torch.cuda.synchronize()
    for i, (g, e) in enumerate(zip(graphed, eager)):
        assert outputs_equal(g, e), f"step {i}"
    tiers = [(o[5]["tier_like"], o[5]["tier_beam"]) for o in eager]
    at_00 = sum(t == (0, 0) for t in tiers)
    assert at_00 >= 1, tiers
    assert eng.step_routes["graph"] - routes["graph"] == at_00
    # K1 on every grouped likelihood, K2 and M1 on every grouped beam,
    # from a replay of graph B or from the eager remainder
    like_0 = sum(t[0] == 0 for t in tiers)
    beam_0 = sum(t[1] == 0 for t in tiers)
    assert launches == [like_0, beam_0, beam_0], (launches, tiers)


def test_initial_pose_between_graphed_steps(cuda):
    rng_scans = [worlds.scan(np.random.default_rng(i), bench.CLOUD_POINTS)
                 for i in range(8)]
    engines = []
    for graphed in (True, False):
        eng, _, _ = bench.build(N, cuda)
        if not graphed:
            eng._step = eng._measurement_step
        t, results = 0.0, []
        for i, scan in enumerate(rng_scans):
            if i == 4:
                eng.initial_pose(np.array([0.3, -0.2, 0.0]), IDENT,
                                 worlds.TRACKING_COV)
                assert eng._graphs == {}
            eng.odometry(np.zeros(3), IDENT, t)
            res = eng.push_cloud("lidar", scan, ORIGIN, t)
            if res is not None:
                results.append((res.pos, res.rot, dict(eng.last_aux)))
            t += 0.1
        torch.cuda.synchronize()
        engines.append((eng, results))
    (eng_g, res_g), (eng_e, res_e) = engines
    assert eng_g.step_routes["graph"] >= 1, eng_g.step_routes
    assert len(res_g) == len(res_e) >= 6
    for (pg, rg, ag), (pe, re, ae) in zip(res_g, res_e):
        np.testing.assert_array_equal(pg, pe)
        np.testing.assert_array_equal(rg, re)
        for k in ("e_pos", "e_rot", "cov", "n_active", "tier_like",
                  "tier_beam"):
            np.testing.assert_array_equal(ag[k], ae[k])
    assert outputs_equal(tuple(eng_g.pstate), tuple(eng_e.pstate))


TIER2 = {
    # name -> (particles, bench.build keywords, kernels every step launches)
    "trilinear-1M": (1 << 20, dict(interp="trilinear"), (sample_field,)),
    "small-64": (64, {}, (sample_field, march_sphere)),
    "dda-4096": (4096, dict(beam=BeamParams(use_raycast_using_dda=True)),
                 (march_dda,)),
}


@pytest.mark.parametrize("case", sorted(TIER2))
def test_tier2_graphed_steps_equal_eager_steps(cuda, case):
    n, kw, every_step = TIER2[case]
    eng, _, args = bench.build(n, cuda, **kw)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    keeps = eng.keeps(args[2], args[4])
    draws = [eng.draw_step(*keeps, gen=gen) for _ in range(12)]
    _chain(eng._step, eng.pstate, args, draws[:2])     # warm-up, captures
    counted = (sample_field, march_sphere, march_dda, og.grouped_like_score,
               og.grouped_beam_pen)
    for k in counted:
        k.launches = 0
    routes = dict(eng.step_routes)
    graphed = _chain(eng._step, eng.pstate, args, draws[2:])
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counted}
    taken = {k: v - routes[k] for k, v in eng.step_routes.items()}
    eager = _chain(eng._measurement_step, eng.pstate, args, draws[2:])
    torch.cuda.synchronize()
    for i, (g, e) in enumerate(zip(graphed, eager)):
        assert outputs_equal(g, e), f"step {i}"
    tiers = [(o[5]["tier_like"], o[5]["tier_beam"]) for o in eager]
    # a step replays B once its outcome has run eagerly at this key; the
    # tier-2 outcomes all read nothing on the host
    assert taken["graph"] >= 8 and taken["graph"] + taken["graph_front"] == 10, (
        taken, tiers)
    for k in every_step:
        assert launches[k.__name__] == 10, (launches, tiers)
    if case == "trilinear-1M":
        assert all(t[0] == 2 for t in tiers) and (2, 0) in tiers, tiers
    elif case == "small-64":
        assert tiers == [(2, 2)] * 10, tiers
    else:
        assert all(t[1] == 2 for t in tiers) and (0, 2) in tiers, tiers
