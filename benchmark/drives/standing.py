"""Drive ``standing``: robots stand still at poses drawn in free space
(``clearance_m`` from every wall and pillar) from the mix's
``layout_seed``, so that every run holds the same poses; the seed deals
them to the robots and draws each robot's bank of ``scan_bank`` noise
draws of its own scan.  ``cells.fleet`` steps them all at once, one
fleet step a scan period over the bank.
"""

from __future__ import annotations

import numpy as np

from benchmark.traffic import PILLARS, ROOM, Fleet, cast

LOOP = "fleet"


def make(mix: dict, cfg: dict, seed: int) -> Fleet:
    """``cfg["robots"]`` robots standing in free space with their banks
    of ``cfg["cloud_points"]``-point scans."""
    robots, points = cfg["robots"], cfg["cloud_points"]
    layout = np.random.default_rng(mix["layout_seed"])
    c = mix["clearance_m"]
    poses = np.zeros((0, 3))
    while poses.shape[0] < robots:
        xy = layout.uniform(-ROOM + c, ROOM - c, (robots, 2))
        ok = np.ones(robots, bool)
        for cx, cy, r in PILLARS:
            ok &= np.hypot(xy[:, 0] - cx, xy[:, 1] - cy) > r + c
        yaw = layout.uniform(-np.pi, np.pi, robots)
        poses = np.concatenate([poses, np.column_stack([xy, yaw])[ok]])
    rng = np.random.default_rng([seed, 1])
    poses = poses[:robots][rng.permutation(robots)]
    bank = np.stack([cast(rng, poses[:, 0], poses[:, 1], poses[:, 2], points,
                          mix["scan_noise_m"])
                     for _ in range(mix["scan_bank"])])
    return Fleet(poses, bank)
