"""Drive ``recover``: the ``circle`` drive's lap (``drives/circle.py``),
with a ``global`` message (``MCL3DL.global_localization``) where that
lap re-seeds, before every ``episode_scans``-th scan; with
``episode_scans`` a divisor of ``lap_scans`` the episodes stay aligned
from lap to lap.
"""

from __future__ import annotations

from benchmark import harness
from benchmark.traffic import Lap

LOOP = "single"


def make(mix: dict, cfg: dict, seed: int) -> Lap:
    """One lap of ``circle`` with its re-seeds turned into global
    localization calls."""
    lap = harness.drive("circle").make(mix, cfg, seed)
    return lap._replace(messages=[
        m._replace(kind="global", a=None, b=None) if m.kind == "reseed"
        else m for m in lap.messages])
