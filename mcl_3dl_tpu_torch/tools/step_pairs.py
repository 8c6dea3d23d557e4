"""The main path's steady ``push_cloud`` of this checkout and of other
checkouts, each build in processes of its own, in alternating rounds on
the card.

    python -m mcl_3dl_tpu_torch.tools.step_pairs [--rounds 5] [--steps 20]
        NAME=ROOT ...

Each ``ROOT`` is another checkout's root (an older commit's ``git
archive``).  A child process of a build puts that build's root first on
its path, so it imports that checkout's ``mcl_3dl_tpu_torch`` and loads
that checkout's kernel library and nothing else: whatever loading a
library or a launch path costs the whole process is on its side alone.
The child builds the kernels (or finds them built), drives the main path
of ``chip_smoke.py`` phase 3 (``grouped_pairs.engine`` and ``drive``:
1,048,576 particles, the tracking spread to tiers 0/0) and then times
``--steps`` steady scans as phase 5 does, each on the host clock between
two synchronisations, the first left out.

A warm-up round, not counted, starts one child a build so that every
library is built before any timing.  Then each of ``--rounds`` rounds
starts one child a build, in list order in even rounds and reversed in
odd ones.  Printed per build: its rounds' medians, the median over all
its scans, the drive's last steady step, the steady scans' tiers, the
host time of ten small torch operations before and after the library
loads (medians over the processes), and in how many rounds this
checkout's median was the lower.  Every line
carries the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

THIS_ROOT = Path(__file__).resolve().parents[2]


def child(root, steps):
    """Drive the main path with ``root``'s package alone; print one JSON
    line: the steady scans' ms, the drive's steady steps' ms, the steady
    scans' tiers, the launches of K1-K3 over the whole run, and the host
    ms of ten small torch operations before and after the kernel library
    loads (``probe_ms``)."""
    sys.path[0] = str(root)      # in place of this script's directory
    import mcl_3dl_tpu_torch

    pkg = Path(mcl_3dl_tpu_torch.__file__).resolve().parent
    if pkg.parent != Path(root).resolve():
        raise RuntimeError(f"imported {pkg}, not {root}'s package")
    import numpy as np
    import torch

    from mcl_3dl_tpu_torch import worlds
    from mcl_3dl_tpu_torch.models import likelihood
    from mcl_3dl_tpu_torch.ops import build
    from mcl_3dl_tpu_torch.ops import grouped as og
    from mcl_3dl_tpu_torch.tools import grouped_pairs as gp

    from mcl_3dl_tpu_torch.tools import host_ms

    build.build()
    x = torch.zeros(1024, device="cuda")

    def small_ops():
        y = x + 1.0
        for _ in range(3):
            y = torch.where(y > 0.5, y * 2.0, y - 1.0)
        return y.sum()

    probe = [host_ms(small_ops)]
    build.library()
    probe.append(host_ms(small_ops))
    kernels = (og.grouped_like_score, og.grouped_beam_pen,
               likelihood.local_score)
    rng = np.random.default_rng(0)
    eng = gp.engine()
    drive_ms = []
    t = gp.drive(eng, rng, on_step=lambda dt, res: drive_ms.append(
        (dt * 1e3, eng.last_aux["tier_like"], eng.last_aux["tier_beam"])))
    ident = np.array([0.0, 0.0, 0.0, 1.0])
    origin = np.array([0.0, 0.0, worlds.SENSOR_Z])
    steady, tiers = [], set()
    for _ in range(steps + 1):
        eng.odometry(np.zeros(3), ident, t)
        cloud = worlds.scan(rng, gp.CLOUD_POINTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.push_cloud("lidar", cloud, origin, t)
        torch.cuda.synchronize()
        steady.append((time.perf_counter() - t0) * 1e3)
        tiers.add((eng.last_aux["tier_like"], eng.last_aux["tier_beam"]))
        t += 0.1
    print(json.dumps({
        "steady_ms": steady[1:],
        "drive_ms": [ms for ms, a, b in drive_ms if (a, b) == (0, 0)][1:],
        "tiers": sorted(tiers), "launches": [k.launches for k in kernels],
        "probe_ms": probe, "package": str(pkg)}), flush=True)


def run_child(root, steps):
    """One child process on ``root``'s package; returns its JSON line.
    Raises with the child's errors when it fails."""
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--child", str(root),
         "--steps", str(steps)], cwd=root, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"step_pairs child on {root} exited "
                           f"{out.returncode}:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def card():
    """The card's ``nvidia-smi`` name and power limit."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def compare(versions, rounds, steps, run=run_child, where=""):
    """A warm-up child a build, then ``rounds`` rounds of one child a
    build in alternating order; prints and returns ``{name: [each round's
    steady ms, ...]}``."""
    for _, root in versions:
        run(root, 1)
    got = {name: [] for name, _ in versions}
    for r in range(rounds):
        for name, root in (versions if r % 2 == 0 else versions[::-1]):
            res = run(root, steps)
            if 0 in res["launches"]:
                raise RuntimeError(f"{name}: K1-K3 launches {res['launches']}")
            got[name].append(res)
    this = [statistics.median(x["steady_ms"]) for x in got[versions[0][0]]]
    for name, _ in versions:
        meds = [statistics.median(x["steady_ms"]) for x in got[name]]
        scans = [ms for x in got[name] for ms in x["steady_ms"]]
        drives = [x["drive_ms"][-1] for x in got[name] if x["drive_ms"]]
        tiers = sorted({tuple(t) for x in got[name] for t in x["tiers"]})
        probe = [statistics.median(x["probe_ms"][i] for x in got[name])
                 for i in (0, 1)]
        wins = sum(a < b for a, b in zip(this, meds))
        vs = ("" if name == versions[0][0] else
              f", this lower in {wins} of {rounds}")
        print(f"steady push_cloud {name}: median {statistics.median(scans):.2f}"
              f" ms over {len(scans)} scans in {rounds} processes, process "
              "medians " + " ".join(f"{m:.2f}" for m in meds)
              + ", drive's last steady step "
              + " ".join(f"{m:.2f}" for m in drives)
              + f", steady tiers {tiers}, small ops' host ms {probe[0]:.4f}"
              f" before its library loads and {probe[1]:.4f} after"
              ", launches K1-K3 "
              f"{got[name][-1]['launches']}{vs} [{where}]",
              flush=True)
    return {name: [x["steady_ms"] for x in got[name]] for name, _ in versions}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--child", metavar="ROOT",
                    help="(internal) drive ROOT's package in this process")
    ap.add_argument("others", nargs="*", metavar="NAME=ROOT")
    a = ap.parse_args(argv)
    if a.child:
        child(a.child, a.steps)
        return None
    versions = [("this", THIS_ROOT)] + [
        (n, Path(p).resolve()) for n, p in
        (spec.partition("=")[::2] for spec in a.others)]
    return compare(versions, a.rounds, a.steps, where=card())


if __name__ == "__main__":
    main()
