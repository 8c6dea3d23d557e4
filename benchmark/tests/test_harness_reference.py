"""The plain reference against the port's plain (CPU) path at a tiny size,
and the bfloat16 control failing the comparison.

Piece by piece: the field (the port's native map build against the
reference's k-d tree, code for code), the likelihood scores (the port's
tier-2 plain gather), both raycasts (the port's ``raycast_fixed`` and
``raycast_df``).  Whole: a short run of each cell at 1,024 particles and
256-point scans on the CPU, each sampled update compared as the
benchmark compares it.

Tolerances and why: the field's codes equal on all but a few cells and
never more than one code apart (the port rounds float32 splat distances,
the reference float64 k-d tree distances, before coding); scores and
rays equal to float32 rounding (5e-6 relative: the same formulas in
another operation order); the whole step within ``SOUND`` (the grouped
kernels' plain versions move poses in 2^-16 fixed point, so a few
lookups fall in the next cell: a few 1e-6 of a metre on the mean at
1,024 particles), the noise column exactly.  The control (bfloat16
models, float32 draws) has to come out not correct, failing the
position, the covariance or the entropy by three times or more.
"""

import numpy as np
import pytest
import torch

from benchmark import check, harness, run, traffic
from benchmark.reference import field as rf
from benchmark.reference import models as rm

SOUND = dict(pose_gap_m=1e-4, yaw_gap_rad=1e-4, cov_gap=1e-3,
             entropy_gap=1e-3, noise_gap=0.0)
SMALL = {"params": {"num_particles": 1024}, "model": {"num_particles": 1024},
         "cloud_points": 256, "check": {"scans": 2, "from_first": 2}}
SMALL_FLEET = {"params": {"num_particles": 1024},
               "model": {"num_particles": 1024}, "robots": 2,
               "cloud_points": 256, "check": {"robots": 2}}
MODEL = harness.config("flagship-1M")["model"]
# the numbers the control's bfloat16 models move (its draws are float32)
MODELS = ("pose_gap_m", "cov_gap", "entropy_gap")


@pytest.fixture(scope="module")
def world():
    return traffic.world_map()


@pytest.fixture(scope="module")
def port_map(world):
    from mcl_3dl_tpu_torch import Params
    from mcl_3dl_tpu_torch.map.map_data import MapData
    return MapData.build(world, Params(num_particles=1024), device="cpu")


@pytest.fixture(scope="module")
def ref_field(world):
    return rf.build(world, check.field_config(MODEL), "cpu")


@pytest.fixture(scope="module")
def poses():
    g = torch.Generator().manual_seed(7)
    n = 512
    pos = torch.randn((n, 3), generator=g) * torch.tensor([0.3, 0.3, 0.05])
    yaw = torch.rand((n,), generator=g) * 2 * np.pi
    rot = torch.stack([torch.zeros(n), torch.zeros(n), torch.sin(yaw / 2),
                       torch.cos(yaw / 2)], -1)
    return pos, rot


def test_field_codes_match_the_port(port_map, ref_field):
    port = port_map.df.field.to(torch.int16)
    ref = ref_field.codes.to(torch.int16)
    assert tuple(port.shape) == ref_field.dims
    assert torch.allclose(port_map.df.origin, ref_field.origin)
    diff = (port - ref).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) < 1e-4


def test_likelihood_matches_the_port(port_map, ref_field, poses):
    from mcl_3dl_tpu_torch.models.likelihood import likelihood_measure
    pos, rot = poses
    lp = MODEL["likelihood"]
    pts = torch.as_tensor(traffic.cast(np.random.default_rng(3), 0.0, 0.0,
                                       0.0, 96, 0.01))
    valid = torch.ones(96, dtype=torch.bool)
    want, want_q, tier = likelihood_measure(
        port_map.df, pos, rot, pts, valid, lp["match_dist_min"],
        lp["match_dist_flat"], lp["match_weight"], local_kernel=False)
    got, got_q = rm.likelihood(ref_field, pos, rot, pts, valid, lp)
    assert tier == 2
    assert torch.allclose(got, want, rtol=5e-6, atol=1e-5)
    assert torch.allclose(got_q, want_q)


@pytest.mark.parametrize("sphere", [False, True])
def test_raycasts_match_the_port(port_map, ref_field, poses, sphere):
    from mcl_3dl_tpu_torch.engine import beam_num_steps, sphere_num_steps
    from mcl_3dl_tpu_torch import Params
    from mcl_3dl_tpu_torch.models import beam as mb
    pos, _ = poses
    bp = MODEL["beam"]
    g = torch.Generator().manual_seed(11)
    begin = pos + torch.tensor([0.0, 0.0, 0.5])
    ang = torch.rand(pos.shape[0], generator=g) * 2 * np.pi
    end = begin + torch.stack([3.5 * torch.cos(ang), 3.5 * torch.sin(ang),
                               -0.4 * torch.ones_like(ang)], -1)
    seg = end - begin
    length = torch.linalg.vector_norm(seg, dim=-1)
    direction = seg / length[:, None]
    p = Params(num_particles=1024)
    if sphere:
        want = mb.raycast_df(port_map.df_beam, begin, end, p.map_grid_min,
                             p.map_grid_max, bp["hit_range"],
                             sphere_num_steps(p))
        got = rm._sphere_trace(ref_field, begin, direction, length, bp,
                               torch.float32)
    else:
        assert beam_num_steps(p) == bp["fixed_steps"]
        want = mb.raycast_fixed(port_map.df_beam, begin, end, p.map_grid_min,
                                p.map_grid_max, bp["hit_range"],
                                beam_num_steps(p))
        got = rm._fixed_march(ref_field, begin, direction, length, bp,
                              torch.float32)
    assert torch.equal(got[0], want[0])
    assert torch.allclose(got[1], want[1], atol=1e-5)
    assert torch.allclose(got[2], want[2], atol=1e-5)


@pytest.mark.parametrize("cell", ["flagship-1M.tracking",
                                  "flagship-1M.relocalize",
                                  "fleet-1024x10k.tracking"])
def test_whole_step_matches_and_control_fails(cell):
    small = SMALL_FLEET if cell.startswith("fleet") else SMALL
    mix = {"warmup_steps": 1} if cell.startswith("fleet") else \
        {"warmup_scans": 6 if cell.endswith("relocalize") else 2}
    out, checks, ctl = run.run_cell(
        cell, 2 ** 31 + 12345, 0.5, 0, device="cpu", overrides=small,
        mix_overrides=mix, limits=SOUND, control=True, log=lambda m: None)
    assert out["correct"], checks
    assert out["failed"] == 0
    assert not ctl["correct"], ctl
    assert ctl["noise_gap"] == 0.0, ctl
    assert any(ctl[k] >= 3 * SOUND[k] for k in MODELS), ctl
