"""Small-count latency of the fused measurement step on the card (the
port's ``tools/exp_small.py``).

    python -m mcl_3dl_tpu_torch.tools.exp_small [--out rows.jsonl]

The reference node's operating point is 64-500 particles at the sensor
rate (src/parameters.cpp:118: 64 by default, ~10 Hz demo).  For each
particle count the engine and the step's arguments are the bench's
(``tools.bench.build``: the flagship room world, the tracking spread, one
4,096-point scan); every step through ``MCL3DL._step`` (the counterpart of
the JAX tool's jitted step: CUDA graphs where the step is graphable); the
first step, 6 warm-up steps, then ``REPEATS``
chained blocks of ``iters`` steps, each block timed on the host clock
between two ``torch.cuda.synchronize()`` calls.  The step time is the
median block over ``iters``; the blocks' min and max give its spread.
There is no relay to subtract, so ``fetch_overhead_ms`` is null.

64 and 512 are not multiples of 1024, so the grouped tier does not apply
to them (the eligibility rule stays the JAX package's); each row records
the tiers every block ran, the tiers its last step ran and the routes its
timed steps took (``step_graph.ROUTES``): at 64 the step samples the
whole field (M4) and marches every beam (M2) and replays both graphs; at
512 its likelihood takes the box check, so the rest runs eagerly after
graph A.

One JSON line per row on stdout, with the card's ``nvidia-smi`` name and
power limit; ``--out`` also writes the rows there, one a line.  The rows
run on the card; without one the tool exits with an error (a CPU
rehearsal calls ``run_config`` with ``device="cpu"``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

from mcl_3dl_tpu_torch.engine import resolve_device
from mcl_3dl_tpu_torch.tools import card
from mcl_3dl_tpu_torch.tools.bench import build, routes_since, steps, sync

REPEATS = 7
ITERS = 50
WARMUP = 6
SIZES = (64, 512, 16384)


def run_config(n_particles, device=None, iters=ITERS, repeats=REPEATS,
               warmup=WARMUP):
    """One row: the step at ``n_particles`` as the module docstring says."""
    dev = resolve_device(device)
    eng, _, args = build(n_particles, dev)
    out, first_ms, _, _ = steps(eng, eng.pstate, args, 1)
    state = steps(eng, out[0], args, warmup)[0][0]
    blocks, block_tiers, block_end = [], [], []
    before = dict(eng.step_routes)
    for _ in range(repeats):
        tiers = set()
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = eng._step(state, *args)
            state = out[0]
            tiers.add((out[5]["tier_like"], out[5]["tier_beam"]))
        sync(dev)
        blocks.append(time.perf_counter() - t0)
        block_tiers.append(sorted(tiers))
        block_end.append([out[5]["tier_like"], out[5]["tier_beam"]])
    dt = statistics.median(blocks) / iters
    p = eng.params
    points = p.likelihood.num_points + p.beam.num_points
    return {
        "num_particles": n_particles,
        "step_ms": dt * 1e3,
        "updates_per_sec": 1.0 / dt,
        "evals_per_sec": n_particles * points / dt,
        "tier_like": out[5]["tier_like"],
        "tier_beam": out[5]["tier_beam"],
        "compile_s": first_ms[0] / 1e3,      # the first step: no compile
        "iters": iters,
        "repeats": repeats,
        "fetch_overhead_ms": None,
        "block_spread_ms_per_step": [min(blocks) / iters * 1e3,
                                     max(blocks) / iters * 1e3],
        "block_end_tiers": block_end,
        "block_tiers": block_tiers,
        "routes": routes_since(eng, before),
        "device": card(dev),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the rows here, one a line")
    a = ap.parse_args(argv)
    rows = []
    for n in SIZES:
        rows.append(run_config(n))
        print(json.dumps(rows[-1]), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return rows


if __name__ == "__main__":
    main()
