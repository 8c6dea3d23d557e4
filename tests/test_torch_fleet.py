"""The fleet: the port's two fleet paths (``parallel.fleet_filter_step``,
the batched ``spmd_safe`` step under ``torch.func.vmap``, and
``parallel.fleet_filter_step_grouped``, each robot in turn through the
single-robot step) against the JAX package's on the flagship room world
(``__graft_entry__``) at ``test_torch_engine``'s small settings, each
robot's JAX draws injected; and the 6x1x1 pose grid of fleets against
JAX's layout.

Tolerances and why:
* ``e_pos``/``pub_pos`` atol 1e-5 against JAX (both paths): means over
  1024 weighted particles summed in another order, boundary particles
  scored differently (``test_torch_engine``'s module docstring);
* tiers: 2/2 on every robot of the batched path, 0/0 of the grouped one,
  in both packages;
* the port's grouped path against its batched path: atol 3e-4, JAX's own
  contract (``tests/test_fleet.py``): the grouped beam reproduces the
  reference's fixed march, the batched one marches the sphere trace, and
  their incidence estimates differ at grazing beams;
* a grouped robot against the single-robot step: bit for bit (the
  grouped fleet is a loop of that step);
* 6x1x1: the port's bins agree with JAX's on >= 99.9% of particles (as
  in ``test_torch_grouped``); fed JAX's bins, the layout is exactly
  JAX's; the grouped likelihood there equals the plain gather.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from mcl_3dl_tpu.parallel import fleet_filter_step as j_fleet_step
from mcl_3dl_tpu.parallel import fleet_filter_step_grouped as j_grouped_step
from mcl_3dl_tpu.parallel import make_mesh as j_make_mesh
from mcl_3dl_tpu.parallel import shard_state as j_shard_state

from mcl_3dl_tpu_torch import StepDraws, convert
from mcl_3dl_tpu_torch.parallel import (fleet_filter_step,
                                        fleet_filter_step_grouped)
from mcl_3dl_tpu_torch.tools import fleet as tfleet

from test_torch_engine import SMALL, _jax_draws, _np, _port_engine, _t

torch.set_num_threads(2)   # several test workers share the CPU

N = 1024
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _stack_draws(ds):
    return StepDraws(*(None if ds[0][k] is None
                       else torch.stack([d[k] for d in ds])
                       for k in range(len(StepDraws._fields))))


def _fleets(eng_j, args, R, mesh, odom_shift=0.0):
    """JAX's batched state on ``mesh`` and arguments (robot ``r``'s
    odometry shifted by ``r * odom_shift``, its own key), the port's (its
    state and filters converted from JAX's batched arrays), and each
    robot's JAX draws."""
    keys = jax.random.split(jax.random.PRNGKey(5), R)

    def batch(x):
        return jnp.broadcast_to(x[None], (R,) + x.shape)

    state_b = j_shard_state(jax.tree.map(batch, args[0]), mesh, batched=True)
    odom_b = jnp.stack([args[10] + r * odom_shift for r in range(R)])
    jrest = (args[2], args[3], args[4], batch(args[5]), batch(args[6]),
             batch(args[7]), batch(args[8]), batch(args[9]), odom_b,
             batch(args[11]), batch(args[12]), batch(args[13]),
             jax.tree.map(batch, args[14]), jax.tree.map(batch, args[15]),
             batch(args[16]))
    draws = []
    for r in range(R):
        a = list(args)
        a[1] = keys[r]
        draws.append(_jax_draws(eng_j, a))
    state = convert.particle_state(*(_np(x) for x in state_b))
    fp, fa = (convert.filter_state(*(_np(x) for x in f)) for f in jrest[12:14])
    port = (state, *(tfleet.tile(x, R) for x in (
        _t(args[5]), _t(args[6], np.int64), _t(args[7]), _t(args[9]))),
        _t(odom_b), *(tfleet.tile(_t(args[i]), R) for i in (11, 12, 13)),
        fp, fa, torch.zeros(R, dtype=bool))
    return state_b, keys, jrest, port, draws


def _run_port(step, eng, port, draws):
    state_b, cl, cll, clv, org, op, orot, pp, pr, fp, fa, gf = port
    return step(state_b, eng.map.df, eng.map.df_beam, cl, cll, clv, org, op,
                orot, pp, pr, fp, fa, gf, None, draws)


@pytest.mark.parametrize("R", [2, 4])
def test_batched_fleet_matches_jax(R):
    eng_j, args = ge._build_engine_and_inputs(num_particles=N, **SMALL)
    eng = _port_engine(eng_j)
    mesh = j_make_mesh(8, robots=R)
    state_b, keys, jrest, port, draws = _fleets(eng_j, args, R, mesh,
                                                odom_shift=1.0)
    jaux = jax.device_get(j_fleet_step(eng_j, mesh)(state_b, keys, *jrest)[-1])
    out = _run_port(fleet_filter_step(eng), eng, port, _stack_draws(draws))
    aux = out[-1]
    assert aux["tier_like"].tolist() == aux["tier_beam"].tolist() == [2] * R
    for k in ("e_pos", "pub_pos"):
        np.testing.assert_allclose(aux[k].numpy(), _np(jaux[k]), atol=1e-5,
                                   err_msg=k)
    pub = aux["pub_pos"].numpy()
    assert not np.allclose(pub[0], pub[1], atol=1e-3)     # robots differ
    assert out[0].pos.shape == (R, N, 3)


@pytest.fixture(scope="module")
def grouped_world():
    """``test_fleet.py``'s grouped set-up (R = 4, N = 1024, 8 likelihood
    points, converged spread): JAX's grouped outputs, the port's grouped
    and batched outputs on JAX's draws, and what they ran on."""
    R = 4
    eng_j, args = ge._build_engine_and_inputs(
        num_particles=N, cloud_points=256, fast=True, like_points=8,
        beam_clip_far=2.0, beam_clip_z=1.0)
    eng_j.initial_pose(np.zeros(3), np.asarray([0.0, 0.0, 0.0, 1.0]),
                       tfleet.CONVERGED_COV)
    args = (eng_j.pstate,) + args[1:]
    eng = _port_engine(eng_j)
    mesh = j_make_mesh(4, robots=4)
    state_b, keys, jrest, port, draws = _fleets(eng_j, args, R, mesh)
    jaux = jax.device_get(
        j_grouped_step(eng_j, mesh)(state_b, keys, *jrest)[-1])
    stacked = _stack_draws(draws)
    out_g = _run_port(fleet_filter_step_grouped(eng), eng, port, stacked)
    out_b = _run_port(fleet_filter_step(eng), eng, port, stacked)
    return dict(eng=eng, port=port, draws=draws, jaux=jaux, out_g=out_g,
                out_b=out_b)


def test_grouped_fleet_matches_jax(grouped_world):
    w = grouped_world
    aux, jaux = w["out_g"][-1], w["jaux"]
    assert (aux["tier_like"] == 0).all() and (aux["tier_beam"] == 0).all()
    assert (np.asarray(jaux["tier_like"]) == 0).all()
    assert (np.asarray(jaux["tier_beam"]) == 0).all()
    for k in ("e_pos", "pub_pos"):
        np.testing.assert_allclose(aux[k].numpy(), _np(jaux[k]), atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(aux["e_pos"].numpy(),
                               w["out_b"][-1]["e_pos"].numpy(), rtol=0,
                               atol=3e-4)


def test_grouped_robot_is_the_single_robot_step(grouped_world):
    w = grouped_world
    eng, port, out_g = w["eng"], w["port"], w["out_g"]
    thr = (eng.params.std_warn_thresh_xy, eng.params.std_warn_thresh_z,
           eng.params.std_warn_thresh_yaw)
    for i in (0, 3):
        st = tfleet.robot_state(port[0], i)
        one = eng._measurement_step(
            st, eng.map.df, eng.map.df_beam, *(x[i] for x in port[1:9]),
            tfleet.robot_filter(port[9], i), tfleet.robot_filter(port[10], i),
            False, thr, w["draws"][i])
        assert all(torch.equal(a[i], b) for a, b in zip(out_g[0], one[0]))
        for k in (1, 2):
            assert all(torch.equal(a[i], b) for a, b in zip(out_g[k], one[k]))
        assert torch.equal(out_g[3][i], one[3])
        assert torch.equal(out_g[4][i], one[4])
        for k, v in one[5].items():
            got = out_g[5][k][i]
            assert torch.equal(got, torch.as_tensor(v, dtype=got.dtype)), k


_GRID = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import torch
from mcl_3dl_tpu.math import quat as mq
from mcl_3dl_tpu.ops import grouped as jog
from mcl_3dl_tpu_torch.models.likelihood import likelihood_measure
from mcl_3dl_tpu_torch.ops import grouped as og
from test_kernel_emulation import _setup
from test_torch_grouped import port_df, port_stats, port_layout

assert (og.G_YAW, og.G_PITCH, og.G_ROLL, og.G_GROUPS) == (6, 1, 1, 7)
assert (jog.G_YAW, jog.G_PITCH, jog.G_ROLL, jog.G_GROUPS) == (6, 1, 1, 7)
rng, jdf, scan, n, pos, rot, js = _setup(seed=5, K=8)
df = port_df(jdf)
tpos, trot = torch.as_tensor(np.array(pos)), torch.as_tensor(np.array(rot))
active = torch.ones(n, dtype=torch.bool)
from mcl_3dl_tpu_torch.math import quat as tq
rmat = tq.rotation_matrix(tq.normalize(trot))
ts = og.group_stats(tpos, rmat, trot, df.weights, float(df.cell), df.origin,
                    active)
agree = float((ts.g.numpy() == np.asarray(js.g)).mean())
cap = og.default_overflow_cap(n)
jl = jog.build_layout(js, cap)
tl = og.build_layout(port_stats(js), cap)
want = port_layout(jl)
same = all(torch.equal(a, b) for a, b in
           zip((tl.dest, tl.tile_group, tl.over_idx),
               (want.dest, want.tile_group, want.over_idx)))
same = same and torch.equal(tl.A, want.A)
pts = torch.as_tensor(np.array(scan))
valid = torch.ones(pts.shape[0], dtype=torch.bool)
g = likelihood_measure(df, tpos, trot, pts, valid, 0.2, 0.05, 5.0,
                       active=active)
plain = likelihood_measure(df, tpos, trot, pts, valid, 0.2, 0.05, 5.0,
                           local_kernel=False)
print("GRID", agree, same, int(tl.tile_group.shape[0]), g[2],
      bool(torch.equal(g[0], plain[0]) and torch.equal(g[1], plain[1])))
"""


def _grid_env(**kw):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]))
    env.update(kw)
    return env


def test_fleet_grid_6x1x1_matches_jax():
    """At ``MCL_G_YAW=6 MCL_G_PITCH=1 MCL_G_ROLL=1`` (read at import, so
    in a child process) both packages bin into 7 groups; the port's bins
    agree with JAX's, its layout from JAX's bins is JAX's exactly, and its
    grouped likelihood (tier 0) equals the plain gather."""
    out = subprocess.run(
        [sys.executable, "-c", _GRID], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env=_grid_env(MCL_G_YAW="6", MCL_G_PITCH="1", MCL_G_ROLL="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    line = [s for s in out.stdout.splitlines() if s.startswith("GRID")][-1]
    _, agree, same, n_tiles, tier, equal = line.split()
    assert float(agree) >= 0.999, line
    assert same == "True" and tier == "0" and equal == "True", line
    assert int(n_tiles) >= 2, line


@pytest.mark.parametrize("grid", [dict(MCL_G_PITCH="3"), dict(MCL_G_YAW="0"),
                                  dict(MCL_G_ROLL="4")])
def test_invalid_grid_raises_as_jax(grid):
    """An invalid grid raises ``ValueError`` at import with JAX's
    message, in both packages."""
    msgs = []
    for mod in ("mcl_3dl_tpu_torch.ops.grouped", "mcl_3dl_tpu.ops.grouped"):
        out = subprocess.run(
            [sys.executable, "-c", f"import {mod}"], cwd=ROOT,
            capture_output=True, text=True, timeout=300,
            env=_grid_env(**grid))
        assert out.returncode != 0
        last = out.stderr.strip().splitlines()[-1]
        assert last.startswith("ValueError: MCL_G_YAW must be >= 1"), last
        msgs.append(last)
    assert msgs[0] == msgs[1]
