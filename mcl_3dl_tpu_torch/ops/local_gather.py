"""Per-point box scoring: kernel K3 (``csrc/local_gather.cu``) and its
plain PyTorch version.

Tier 1 of the likelihood model (models/likelihood.py): converged queries
of one scan point cluster in a small axis-aligned box of field cells, so
the caller extracts one f32 table per point and this function evaluates
the ``[points, particles]`` score with one indexed load per query
(lidar_measurement_model_likelihood.cpp:124-135 scoring: matched mask,
flat-floor clamp, per-particle sum + match count).

Replaces mcl_3dl_tpu/ops/local_gather.py::_score_kernel.  A CUDA tensor
launches the kernel through its operator (``csrc/ops.cpp``); a CPU tensor
takes the plain version.
"""

from __future__ import annotations

import torch

from mcl_3dl_tpu_torch.math import f32
from mcl_3dl_tpu_torch.ops import build


def local_score_plain(tables, lidx, *, match_dist_min, match_dist_flat,
                      match_weight):
    """Vectorized restatement of the kernel: same per-element f32 ops,
    same sequential accumulation over the K points."""
    kk = tables.shape[0]
    n = lidx.shape[1]
    tab2 = tables.reshape(kk, -1)
    mdm, mdf, mw = f32(match_dist_min), f32(match_dist_flat), f32(match_weight)
    acc = torch.zeros((n,), dtype=torch.float32, device=tables.device)
    mac = torch.zeros_like(acc)
    for k in range(kk):
        d = tab2[k][lidx[k].to(torch.int64)]
        matched = d <= mdm
        contrib = torch.clamp(mw * (mdm - torch.clamp(d, min=mdf)), min=0.0)
        acc = acc + torch.where(matched, contrib, 0.0)
        mac = mac + matched.to(torch.float32)
    return acc, mac


def local_score(tables, lidx, *, match_dist_min, match_dist_flat,
                match_weight):
    """``(score [N], match_count [N])`` summed over the K points.

    ``tables`` [K, R, 128] f32 local distance tables; ``lidx`` [K, N] i32
    flat cell indices in [0, R*128).  Point validity is folded into the
    tables by the caller (invalid point => all-trunc table)."""
    kw = dict(match_dist_min=match_dist_min, match_dist_flat=match_dist_flat,
              match_weight=match_weight)
    if not tables.is_cuda:
        return local_score_plain(tables, lidx, **kw)
    score, match = build.op("local_score")(
        tables, lidx, f32(match_dist_min), f32(match_dist_flat),
        f32(match_weight))
    local_score.launches += 1
    return score, match


local_score.launches = 0
