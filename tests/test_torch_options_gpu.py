"""The options of this slice on the card against the same functions on the
CPU: trilinear sampling (packed and unpacked), the DDA raycast, the
normal-weighted sampler's weights and draw, and a checkpoint round trip
of a CUDA engine (its CUDA generator's state).

Tolerances and why: trilinear values atol 2e-6 of ``trunc`` (eager CUDA
and CPU kernels may round the weight products differently by an ulp);
DDA hits equal and collision points within 1e-6 m on at least 99.9% of
rays (a probe at a voxel face may take the other voxel); weights rtol
1e-5 (``eigh`` in cuSOLVER and LAPACK); the draw's indices equal on the
same Gumbel draws; the checkpoint round trip equal bit for bit.

Skipped without a CUDA device.  On the card, with no JAX installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_options_gpu.py
"""

import numpy as np
import pytest
import torch

from mcl_3dl_tpu_torch import checkpoint, worlds
from mcl_3dl_tpu_torch.map.distance_field import build_distance_field
from mcl_3dl_tpu_torch.map.occupancy import build_occupancy_grid
from mcl_3dl_tpu_torch.math import quat as mq
from mcl_3dl_tpu_torch.models import beam as tbeam
from mcl_3dl_tpu_torch.models import samplers as tsamp
from mcl_3dl_tpu_torch.tools import all_options as ao

torch.set_num_threads(2)   # several test workers share the CPU


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "eight"])
def test_trilinear_on_the_card_matches_the_cpu(cuda, pack):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3.0, 3.0, (400, 3))
    q = torch.tensor(rng.uniform(-4.5, 4.5, (1 << 16, 3)), dtype=torch.float32)
    got, want = (build_distance_field(pts, 0.1, 0.6, (1.0, 1.0, 2.0),
                                      device=dev, pack_corners=pack)
                 .sample_trilinear(q.to(dev)).cpu()
                 for dev in (cuda, "cpu"))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=2e-6 * 0.6)


def test_dda_raycast_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(1)
    n = 4096
    pos = torch.tensor(rng.normal(0, 0.2, (n, 3)) * [1, 1, 0.2],
                       dtype=torch.float32)
    rot = mq.from_rpy(torch.tensor(rng.normal(0, 0.1, (n, 3)) * [0.3, 0.3, 2],
                                   dtype=torch.float32))
    pts = torch.tensor(worlds.scan(rng, 3), dtype=torch.float32)
    org = torch.tensor([0.0, 0.0, worlds.SENSOR_Z])
    r = mq.rotation_matrix(rot)
    ends = torch.einsum("bj,nij->nbi", pts, r) + pos[:, None, :]
    begins = (torch.einsum("j,nij->ni", org, r) + pos)[:, None, :].expand_as(ends)
    out = {}
    for dev in (cuda, "cpu"):
        occ = build_occupancy_grid(worlds.world_map(), 0.2, device=dev)
        found, cpos, _ = tbeam.raycast_occ(
            occ, begins.to(dev), ends.to(dev), 0.3, 0xFFFFFFFF, 45,
            ray_angle_half=0.25 * np.pi / 180.0, min_dist_thr_sq=0.03)
        out[str(dev)] = (found.cpu().numpy(), cpos.cpu().numpy())
    (fg, cg), (fc, cc) = out["cuda"], out["cpu"]
    same = (fg == fc) & (np.abs(cg - cc) <= 1e-6).all(-1)
    assert same.mean() >= 0.999 and 0.2 < fc.mean() < 1.0


def test_weighted_sampler_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(2)
    pts = worlds.scan(rng, 2048).astype(np.float32)
    normals = torch.as_tensor(tsamp.estimate_normals_host(pts, 0.4))
    valid = torch.as_tensor(rng.uniform(size=len(pts)) < 0.9)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    cov = torch.tensor(q @ np.diag([0.001, 0.01, 0.09]) @ q.T,
                       dtype=torch.float32)
    rot = mq.from_rpy(torch.tensor([0.01, -0.02, 0.3]))
    g = tsamp.draw_gumbel(len(pts), torch.Generator().manual_seed(0), "cpu")
    res = {}
    for dev in (cuda, "cpu"):
        w = tsamp.sampler_with_normal_weights(
            normals.to(dev), valid.to(dev), cov.to(dev), rot.to(dev),
            2.0, 5.0, 5.0)
        _, ok, idx = tsamp.sample_weighted_without_replacement(
            torch.as_tensor(pts).to(dev), w, 96, g.to(dev))
        res[str(dev)] = (w.cpu().numpy(), ok.cpu().numpy(), idx.cpu().numpy())
    np.testing.assert_allclose(res["cuda"][0], res["cpu"][0], rtol=1e-5)
    np.testing.assert_array_equal(res["cuda"][1], res["cpu"][1])
    np.testing.assert_array_equal(res["cuda"][2], res["cpu"][2])


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    make = lambda: ao.engine(cuda, 1 << 14)      # noqa: E731
    eng = make()
    eng.initial_pose(np.zeros(3), ao.IDENT, worlds.TRACKING_COV)
    scans = ao.Scans(np.random.default_rng(3), 1024)
    ao.measure(eng, scans, 2)
    path = tmp_path / "cuda.npz"
    checkpoint.save_checkpoint(eng, path)
    twin = make()
    checkpoint.load_checkpoint(twin, path)
    assert scans.again(twin)[0] is None
    ao.measure(eng, scans, 3, twin=twin)          # raises on a difference
    with pytest.raises(ValueError, match="cuda"):
        checkpoint.load_checkpoint(ao.engine("cpu", 1 << 10), path)
