"""The global-recovery drive of ``mcl_3dl_tpu_torch/tools/recovery.py`` (the
chip smoke's global phase) on the CPU at a small size: a 0.3 m seed grid
and 12 yaw bins (12,696 seeds instead of 122,328) and a 16,384-particle
resize.  Each episode decays 0.75x a step to ``num_particles`` (the drive
raises otherwise) and ends at the base capacity; the tiers show which
kernel a global-mode step reaches: none while the particles spread over
the map, K1 (tier 0) once they cluster at a capacity that is a multiple
of 1024, K3 (tier 1) after a pose tight in attitude."""

import numpy as np
import torch

from mcl_3dl_tpu_torch import worlds
from mcl_3dl_tpu_torch.tools import recovery
from mcl_3dl_tpu_torch.tools.grouped_pairs import COARSE_COV

torch.set_num_threads(2)   # several test workers share the CPU

EPISODES = (("global", None, None),
            ("resize", worlds.TRACKING_COV, 16384),
            ("resize-coarse", COARSE_COV, 500))


def test_recovery_drive_on_cpu():
    eng = recovery.engine("cpu", grid_lin=0.3, yaw_bins=12)
    lines = []
    out = recovery.run(eng, np.random.default_rng(0), episodes=EPISODES,
                       before_step=lambda e: e.pstate.capacity,
                       log=lines.append)
    assert lines[0] == "global: 12696 particles at capacity 16384"
    assert [out[name]["seeds"] for name, _, _ in EPISODES] == [12696, 16384,
                                                               500]
    g, r, c = (out[name]["rows"] for name, _, _ in EPISODES)
    for rows in (g, r, c):
        assert rows[-1]["n"] == 64
        assert all(row["tier_beam"] == -1 for row in rows)
        assert all(row["before"] == row["capacity"] for row in rows)
        # the slot bucket follows the ramp as the count falls
        assert [row["slots"] for row in rows] == sorted(row["slots"]
                                                        for row in rows)
        assert rows[-1]["slots"] == 96
    assert eng.pstate.capacity == 64
    assert {row["tier_like"] for row in g} == {2}
    k1 = [row for row in r if row["tier_like"] == 0]
    assert k1 and all(row["capacity"] % 1024 == 0 for row in k1)
    assert {row["slots"] for row in k1} == {8, 16}
    assert (c[0]["capacity"], c[0]["slots"], c[0]["tier_like"]) == (512, 16, 1)
    for rows in (g, r):
        assert np.linalg.norm(rows[-1]["res"].raw_pos[:2]) < 0.2
