"""Replay a converted log through the port's localizer (the offline
equivalent of launching the reference node on a bag).

    python -m mcl_3dl_tpu_torch.tools.run_replay log.npz [--params FILE]
        [--out trajectory.npz] [--compare] [--tolerance 0.3]
        [--t-end SECONDS] [--cpu]

``--params`` reads a JSON or a YAML file with the reference's parameter
names (nested ``likelihood:`` / ``beam:`` namespaces or the legacy flat
names, as ``Params.from_dict`` takes them); YAML needs PyYAML.
``--compare`` applies the compare_pose.cpp and compare_tf.cpp gates
against the log's reference trajectory and exits 1 if one fails.  The
engine runs on the CUDA device unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from mcl_3dl_tpu_torch import MCL3DL, Params
from mcl_3dl_tpu_torch.io.replay import ReplayDriver, ReplayLog


def load_params(path) -> Params:
    """``Params`` from a JSON file, or from a YAML file when PyYAML is
    installed (a ``.yaml``/``.yml`` file without it raises)."""
    with open(path) as f:
        text = f.read()
    if str(path).endswith((".yaml", ".yml")):
        try:
            import yaml
        except ImportError:
            raise RuntimeError(
                f"{path}: reading YAML needs PyYAML, which is not installed;"
                " give the parameters as JSON") from None
        return Params.from_dict(yaml.safe_load(text) or {})
    return Params.from_dict(json.loads(text) if text.strip() else {})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log")
    ap.add_argument("--params", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--tolerance", type=float, default=0.3)
    ap.add_argument("--t-end", type=float, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)

    params = load_params(args.params) if args.params else Params()
    log = ReplayLog.load(args.log)
    print(f"log: {len(log.times)} events, map {len(log.map_points)} points")

    eng = MCL3DL(params, device="cpu" if args.cpu else None)
    driver = ReplayDriver(eng, log)
    t0 = time.monotonic()
    poses = driver.run(t_end=args.t_end)
    wall = time.monotonic() - t0
    span = (log.times[-1] - log.times[0]) if len(log.times) else 0.0
    print(f"{len(poses)} pose outputs in {wall:.1f}s wall "
          f"({span / max(wall, 1e-9):.2f}x realtime) on {eng.device.type}")

    if args.out and poses:
        np.savez_compressed(
            args.out,
            times=np.asarray([p[0] for p in poses]),
            pos=np.stack([p[1] for p in poses]),
            rot=np.stack([p[2] for p in poses]),
            cov=np.stack([p[3] for p in poses]))
        print(f"wrote {args.out}")

    if args.compare:
        max_err, violations = driver.compare_to_reference(args.tolerance)
        tf_diff, tf_violations = driver.compare_tf()
        print(json.dumps({
            "max_error_m": float(max_err),
            "tolerance_m": args.tolerance,
            "violations": len(violations),
            "max_tf_diff_m": float(tf_diff),
            "tf_violations": len(tf_violations),
            "pass": not violations and not tf_violations,
        }))
        if violations or tf_violations:
            for v in (violations + tf_violations)[:10]:
                print("  violation:", v, file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
