"""CUDA kernels K1, K2, K3 against their plain PyTorch versions on the
card: bit-equal on every slot whose value the caller keeps (the kernels are
built with -fmad=false and keep the plain versions' operation order).
The lookup kernels G1-G10 (``ops/gather_bench.py``), at small sizes with
ragged block edges, must equal their plain versions everywhere.

Skipped without a CUDA device.  On the card, with no JAX installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""

import math

import numpy as np
import pytest
import torch

from mcl_3dl_tpu_torch.map.distance_field import build_distance_field
from mcl_3dl_tpu_torch.math import quat as mq
from mcl_3dl_tpu_torch.models.beam import (BeamVirtualPoints,
                                           grouped_beam_inputs)
from mcl_3dl_tpu_torch.models.likelihood import grouped_like_inputs
from mcl_3dl_tpu_torch.ops import grouped as og
from mcl_3dl_tpu_torch.ops import gather_bench as ogb
from mcl_3dl_tpu_torch.ops import local_gather as olg
from mcl_3dl_tpu_torch.tools import exp_gather, exp_gather2, exp_rowsel_shape

torch.set_num_threads(2)   # several test workers share the CPU

MDM, MDF, MW = 0.2, 0.05, 5.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cloud(dev, seed, n_tiles=4, K=8):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3.0, 3.0, (300, 3))
    df = build_distance_field(pts, 0.1, 0.6, weights=(1.0, 1.0, 2.0),
                              device=dev)
    scan = torch.tensor(rng.uniform(-1.5, 1.5, (K, 3)), dtype=torch.float32,
                        device=dev)
    n = n_tiles * og.TILE
    pos = torch.tensor(rng.normal(0, 0.04, (n, 3)), dtype=torch.float32,
                       device=dev)
    rpy = np.stack([rng.normal(0, 0.02, n), rng.normal(0, 0.02, n),
                    rng.uniform(-0.3, 0.3, n)], axis=1)
    rot = mq.from_rpy(torch.tensor(rpy, dtype=torch.float32, device=dev))
    active = torch.ones(n, dtype=torch.bool, device=dev)
    rmat = mq.rotation_matrix(mq.normalize(rot))
    stats = og.group_stats(pos, rmat, rot, df.weights, df.cell, df.origin,
                           active)
    return df, scan, stats, og.build_layout(stats, og.default_overflow_cap(n))


def _kept_slots(stats, layout):
    """Sorted slots of in-envelope particles: the overflow bin's slots
    are rescored exactly by the caller, and there the kernels' whole-point
    skip (which the plain versions do not take) is not a no-op."""
    return layout.dest[stats.g != og.G_GROUPS - 1]


def test_like_kernel_matches_plain(cuda):
    df, scan, stats, layout = _cloud(cuda, 5)
    valid = torch.ones(scan.shape[0], dtype=torch.bool, device=cuda)
    lo, fits = og.group_boxes(stats, scan, df.shape)
    assert bool(fits.all())
    args = (layout.A, layout.tile_group,
            *grouped_like_inputs(df, stats, lo, scan, valid, MDM))
    kw = dict(match_dist_min=MDM, match_dist_flat=MDF, match_weight=MW,
              trunc=df.trunc)
    n0 = og.grouped_like_score.launches
    got = og.grouped_like_score(*args, **kw)
    assert og.grouped_like_score.launches == n0 + 1
    want = og.like_score_plain(*args, **kw)
    torch.cuda.synchronize()
    keep = _kept_slots(stats, layout)
    for a, b in zip(got, want):
        assert torch.equal(a[keep], b[keep])
    assert float(got[1][keep].sum()) > 0


def test_beam_kernel_matches_plain(cuda):
    df, scan, stats, layout = _cloud(cuda, 9, K=3)
    valid = torch.ones(3, dtype=torch.bool, device=cuda)
    labels = torch.zeros(3, dtype=torch.int64, device=cuda)
    origins = torch.zeros((1, 3), device=cuda)
    vp = BeamVirtualPoints(scan, labels, valid, origins, 0.1, 0.3, 20)
    lo, fits = og.group_boxes(stats, vp.vpf, df.shape)
    assert bool((fits | ~vp.chainf[:, None]).all())
    args = (layout.A, layout.tile_group,
            *grouped_beam_inputs(df, stats, lo, vp, valid, 0.1))
    kw = dict(nprobe=vp.nprobe, trunc=df.trunc, grid_min=0.1,
              radius=2.0 ** 0.5 * 0.1 / 2.0, hit_range=0.3,
              sin_total_ref=math.sin(math.pi / 6.0), long_pen=True, tol=0.3)
    got = og.grouped_beam_pen(*args, **kw)
    want = og.beam_pen_plain(*args, **kw)
    torch.cuda.synchronize()
    keep = _kept_slots(stats, layout)
    assert torch.equal(got[keep], want[keep])
    assert float(got[keep].sum()) > 0


def test_local_kernel_matches_plain(cuda):
    rng = np.random.default_rng(3)
    K, R, N = 6, 16, 4096
    tables = torch.tensor(rng.uniform(0.0, 0.6, (K, R, 128)),
                          dtype=torch.float32, device=cuda)
    lidx = torch.tensor(rng.integers(0, R * 128, (K, N)), dtype=torch.int32,
                        device=cuda)
    kw = dict(match_dist_min=MDM, match_dist_flat=MDF, match_weight=MW)
    got = olg.local_score(tables, lidx, **kw)
    want = olg.local_score_plain(tables, lidx, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrapper_refuses_wrong_dtype(cuda):
    tables = torch.zeros((2, 1, 128), device=cuda)
    lidx = torch.zeros((2, 128), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        olg.local_score(tables, lidx, match_dist_min=MDM,
                        match_dist_flat=MDF, match_weight=MW)


# small sizes whose row counts leave partial blocks and partial grids
_LOOKUPS = {"exp_gather": lambda d: exp_gather.lookups(d, q=128 * 37,
                                                       risky=True),
            "exp_gather2": lambda d: exp_gather2.lookups(d, q=3 << 14, bq=128),
            "exp_rowsel_shape": lambda d: exp_rowsel_shape.lookups(
                d, nq=128 * 77, tiles=(8, 64))}
_TOOL_OF = dict({t: "exp_gather" for t in ("G1", "G2", "G3", "G4", "G5")},
                G6="exp_gather2", G7="exp_gather2", G8="exp_gather2",
                G9="exp_gather2", G10="exp_rowsel_shape")


@pytest.mark.parametrize("tag", list(_TOOL_OF))
def test_lookup_kernel_matches_plain(cuda, tag):
    for e in _LOOKUPS[_TOOL_OF[tag]](cuda):
        if e.tag != tag:
            continue
        n0 = e.wrapper.launches
        got = e.run()
        assert e.wrapper.launches == n0 + 1
        want = e.plain()
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want), e.name


def test_refused_lookup_launch_raises(cuda):
    """A table beyond the 227 KB of shared memory a block may have: the
    launch is refused and the wrapper raises."""
    tab = torch.zeros((1 << 16,), device=cuda)
    idx = torch.zeros((4, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        ogb.fancy_gather(tab, idx)
