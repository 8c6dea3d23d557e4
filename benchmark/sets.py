"""Run a cell several times, each run a process of its own, and report
each metric's spread: the tool that sets and checks the bounds.

    python3 benchmark/sets.py --workload <cell> --seeds 11,12,13 \
        [--seconds 30] [--trace 0] [--control] [--out runs.jsonl]

Each run is ``benchmark/run.py`` with one seed; its result line and the
end of its standard error go to ``--out`` (one JSON object a run).  The
last stdout line holds, for each metric, the values, their median and
the spread: the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) over the median; and for each
compared number the largest reading (with ``--control``, the control's
smallest beside it, and how many of its runs would pass as correct).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values):
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def one(workload, seed, seconds, trace, control):
    cmd = [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
           workload, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)] + (["--control"] if control else [])
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    rec = dict(seed=seed, rc=p.returncode,
               wall_s=time.perf_counter() - t0, stderr=p.stderr[-6000:])
    lines = p.stdout.strip().splitlines()
    if p.returncode == 0 and lines:
        rec["result"] = json.loads(lines[-1])
    for line in p.stderr.splitlines():
        if line.startswith("control "):
            rec["control"] = json.loads(line[len("control "):])
    return rec


def summary(recs):
    metrics, checks, control = {}, {}, {}
    for r in recs:
        res = r.get("result")
        if res is None:
            continue
        for k, v in res["metrics"].items():
            metrics.setdefault(k, []).append(v["value"])
        for k, v in res["checks"].items():
            if v["value"] is not None:
                checks[k] = max(checks.get(k, 0.0), v["value"])
        for k, v in (r.get("control") or {}).items():
            if k != "correct":
                control[k] = min(control.get(k, float("inf")), v)
    return dict(
        runs=len(recs), ok=sum(1 for r in recs if r.get("result")),
        correct=sum(1 for r in recs if (r.get("result") or {}).get("correct")),
        metrics={k: dict(values=v, median=statistics.median(v),
                         spread=spread(v)) for k, v in metrics.items()},
        largest_reading=checks, control_smallest=control or None,
        control_correct=sum(1 for r in recs
                            if (r.get("control") or {}).get("correct")))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    recs = []
    for seed in (int(s) for s in a.seeds.split(",")):
        rec = one(a.workload, seed, a.seconds, a.trace, a.control)
        recs.append(rec)
        res = rec.get("result") or {}
        print(f"sets: {a.workload} seed {seed} rc {rec['rc']} "
              f"{rec['wall_s']:.1f} s correct {res.get('correct')} "
              + json.dumps({k: v["value"] for k, v in
                            res.get("metrics", {}).items()}),
              file=sys.stderr, flush=True)
        if rec["rc"]:
            print(rec["stderr"][-3000:], file=sys.stderr, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    print(json.dumps(dict(workload=a.workload, **summary(recs))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
