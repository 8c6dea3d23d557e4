"""The fleet and the particle split on the card: K1 and K2 at a fleet
robot's shapes (10,240 particles, at the default pose grid and, in a
child process, at the fleets' 6x1x1) against their plain versions; the
grouped fleet on the card against the same fleet on the CPU; and a
world-of-1 NCCL particle split against the plain step.

Tolerances and why: K1/K2 bit-equal on the slots the caller keeps (as in
``test_torch_kernels_gpu``); the grouped fleet's tiers equal (0/0) and
``e_pos``/``pub_pos`` within atol 1e-5 of the CPU's (the CPU tolerance of
``test_torch_fleet``: the card's reductions add in another order); the
world-of-1 split bit-equal to the plain step (its collectives over one
rank return their inputs).

Skipped without a CUDA device.  On the card, with no JAX installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fleet_gpu.py
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mcl_3dl_tpu_torch import worlds
from mcl_3dl_tpu_torch.parallel import fleet_filter_step_grouped
from mcl_3dl_tpu_torch.tools import fleet, sharded

torch.set_num_threads(2)   # several test workers share the CPU

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(like_points=8, beam_clip_far=2.0, beam_clip_z=1.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


_KERNELS = r"""
import numpy as np, torch
from mcl_3dl_tpu_torch import worlds
from mcl_3dl_tpu_torch.ops import grouped as og
from mcl_3dl_tpu_torch.tools import fleet
from mcl_3dl_tpu_torch.tools import grouped_pairs as gp
eng = fleet.engine(fleet.NUM_PARTICLES, "cuda")
inp = gp.kernel_inputs(eng, worlds.scan(np.random.default_rng(2), 1024))
like = og.grouped_like_score(*inp.like, **inp.like_kw)
like_p = og.like_score_plain(*inp.like, **inp.like_kw)
beam = og.grouped_beam_pen(*inp.beam, **inp.beam_kw)
beam_p = og.beam_pen_plain(*inp.beam, **inp.beam_kw)
torch.cuda.synchronize()
k = inp.kept
ok = all(torch.equal(a[k], b[k]) for a, b in zip(like, like_p))
ok = ok and torch.equal(beam[k], beam_p[k])
print("KERNELS", og.G_GROUPS, inp.layout.A.shape[0], int(k.numel()), ok)
"""


@pytest.mark.parametrize("grid", ["24x2x2", "6x1x1"])
def test_k1_k2_at_fleet_shapes(cuda, grid):
    yaw, pitch, roll = grid.split("x")
    env = dict(os.environ, MCL_G_YAW=yaw, MCL_G_PITCH=pitch, MCL_G_ROLL=roll,
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _KERNELS], cwd=ROOT,
                         capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [s for s in out.stdout.splitlines() if s.startswith("KERNELS")][-1]
    _, groups, tiles, kept, ok = line.split()
    assert int(groups) == int(yaw) * int(pitch) * int(roll) + 1, line
    assert int(kept) > 0.9 * fleet.NUM_PARTICLES and ok == "True", line


def _to(x, dev):
    if isinstance(x, tuple):
        return type(x)(*(_to(v, dev) for v in x))
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def test_grouped_fleet_on_the_card_matches_the_cpu(cuda):
    """Four robots apart in odometry, the same states and draws (made on
    the CPU), through the grouped fleet on the CPU and on the card."""
    outs = []
    for dev in ("cpu", cuda):
        eng = fleet.engine(1024, dev, **SMALL)
        if not outs:
            args = fleet.apart(fleet.inputs(eng, 4, worlds.scan(
                np.random.default_rng(0), 256)), 0.5)
            draws = fleet.given_draws(eng, args)
        run = [_to(a, dev) for a in args]
        run[1:3] = eng.map.df, eng.map.df_beam
        outs.append(fleet_filter_step_grouped(eng)(*run, None,
                                                   _to(draws, dev)))
    want, got = outs
    for k in ("tier_like", "tier_beam"):
        assert got[5][k].tolist() == want[5][k].tolist() == [0] * 4, k
    for k in ("e_pos", "pub_pos"):
        np.testing.assert_allclose(got[5][k].cpu().numpy(),
                                   want[5][k].numpy(), rtol=0, atol=1e-5)
    assert fleet.min_gap(got[5]["pub_pos"]) > 0.25


def test_world_of_one_nccl_split_is_the_plain_step(cuda):
    import torch.distributed as dist
    from mcl_3dl_tpu_torch.parallel import make_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        eng = fleet.engine(4096, cuda, **SMALL)
        scan = worlds.scan(np.random.default_rng(1), 256)
        _, _, equal, aux = sharded.time_split(eng, scan, make_mesh(), iters=1)
    finally:
        dist.destroy_process_group()
    assert (aux["tier_like"], aux["tier_beam"]) == (0, 0)
    assert equal
