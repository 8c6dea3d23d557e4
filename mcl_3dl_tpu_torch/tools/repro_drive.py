"""Whether the main path's drive is reproducible on the card: the same
seeded drive on fresh engines, compared bit for bit.

    python -m mcl_3dl_tpu_torch.tools.repro_drive [--drives 3] [--ops]
        [--scan rows|torch] [--drive main|recovery|all-options]

Each drive is ``grouped_pairs.engine()`` and ``grouped_pairs.drive`` from
``numpy.random.default_rng(0)``, the drive of ``chip_smoke.py``: 1,048,576
particles, a coarse initial pose, then the tracking spread and ten scans.
Per measurement it prints the tiers, the overflow bin's particles
against its cap, both ``fits`` flags, the raw z and a fingerprint of the
particle poses; then, for each later drive, the first measurement whose
particles differ from the first drive's (none: reproducible).

``--ops`` runs two more drives under an op log (every aten op and every
kernel's torch operator, with fingerprints of its tensor inputs and
outputs) and prints the first op whose outputs differ: with equal inputs
it is the op that is not reproducible; with other inputs they were
written outside the log or read before they were written.
Outputs of ``empty`` allocations are not compared.

``--drive recovery`` compares the global-mode drive instead: the three
episodes of ``tools/recovery.py`` (``global_localization`` from 122,328
seeds and two ``resize_particles`` decays to 64 particles), per
measurement the episode, tiers, particle count and a fingerprint of the
particle poses the step started from.

``--drive all-options`` compares the drive of ``tools/all_options.py``
(``chip_smoke.py``'s phase 9: trilinear sampling, the DDA raycast and
the normal-weighted sampler at 1,048,576 particles, ``N_SCANS``
measurements from the tracking spread), per measurement the tiers, the
raw z and a fingerprint of the particle poses.

``--scan torch`` puts ``torch.cumsum`` back in place of ``math.cumsum``
in resampling and point sampling (the device-wide scan, whose float sums
depend on block timing), to show what the fixed-order scan changes.
Every line carries the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from mcl_3dl_tpu_torch import pf, worlds
from mcl_3dl_tpu_torch.engine import resolve_device
from mcl_3dl_tpu_torch.models import samplers
from mcl_3dl_tpu_torch.ops import build
from mcl_3dl_tpu_torch.ops import grouped as og
from mcl_3dl_tpu_torch.tools import all_options, card
from mcl_3dl_tpu_torch.tools import grouped_pairs as gp
from mcl_3dl_tpu_torch.tools import recovery


def fingerprint(t):
    """``(shape, dtype, n)`` of a tensor, ``n`` an integer of its bytes
    (each byte weighted by its position): equal bits, equal prints."""
    b = t.detach().reshape(-1).contiguous().view(torch.uint8).to(torch.int64)
    w = torch.arange(b.numel(), device=b.device) % 1000003 + 1
    return tuple(t.shape), str(t.dtype), int((b * w).sum())


class OpLog(TorchDispatchMode):
    """Records ``(op, input prints, output prints, caller)`` of every aten
    op run inside it, in order, in ``records``; ``caller`` is the
    innermost ``file:line`` of this package outside this tool."""

    def __init__(self):
        super().__init__()
        self.records = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [fingerprint(x) for x in tree_flatten((args, kwargs))[0]
               if isinstance(x, torch.Tensor)]
        out = func(*args, **kwargs)
        outs = [fingerprint(x) for x in tree_flatten(out)[0]
                if isinstance(x, torch.Tensor)]
        caller = next((f"{f.filename.rsplit('mcl_3dl_tpu_torch/', 1)[-1]}:"
                       f"{f.lineno}" for f in reversed(traceback.extract_stack())
                       if "mcl_3dl_tpu_torch" in f.filename
                       and not f.filename.endswith("repro_drive.py")), "")
        self.records.append((str(func), ins, outs, caller))
        return out


def first_difference(a, b):
    """``(index, what)`` of the first op whose outputs differ between two
    op logs, or None.  Outputs of ``empty`` allocations are not compared,
    nor are inputs alone (an op that overwrites a fresh allocation reads
    its garbage and still writes equal bits); ``what`` says whether that
    op's inputs were equal."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x[0] != y[0]:
            return i, "another op"
        if "empty" in x[0] or x[2] == y[2]:
            continue
        if x[1] == y[1]:
            return i, "equal inputs, other outputs: not reproducible"
        return i, ("other inputs and outputs (inputs written outside the "
                   "log, or read before they were written)")
    if len(a) != len(b):
        return min(len(a), len(b)), "one log is longer"
    return None


def record_drive(log_ops=False):
    """One drive on a fresh engine: ``(steps, op records or None)``, a
    step being ``(tier_like, tier_beam, n_over, cap, fits_like,
    fits_beam, raw z, particle print)``."""
    eng = gp.engine()
    groups = []
    group = eng.group

    def spy(*args):
        out = group(*args)
        stats = out[1][0]
        groups.append((int(stats.n_over), og.default_overflow_cap(args[0].shape[0]),
                       out[1][3], out[2][3]))
        return out

    eng.group = spy
    steps = []

    def on_step(_, res):
        aux = eng.last_aux
        steps.append((aux["tier_like"], aux["tier_beam"], *groups[-1],
                      float(res.raw_pos[2]), fingerprint(eng.pstate.pos)[2]))

    log = OpLog() if log_ops else None
    if log is None:
        gp.drive(eng, np.random.default_rng(0), on_step=on_step)
    else:
        with log:
            gp.drive(eng, np.random.default_rng(0), on_step=on_step)
    return steps, (log.records if log is not None else None)


def record_recovery(log_ops=False):
    """One global-recovery drive on a fresh engine: ``(steps, op records or
    None)``, a step being ``(episode, tier_like, tier_beam, n_active,
    print of the poses it started from)``."""
    eng = recovery.engine()
    log = OpLog() if log_ops else None
    kw = dict(before_step=lambda e: fingerprint(e.pstate.pos)[2],
              log=lambda s: None)
    if log is None:
        out = recovery.run(eng, np.random.default_rng(0), **kw)
    else:
        with log:
            out = recovery.run(eng, np.random.default_rng(0), **kw)
    steps = [(name, r["tier_like"], r["tier_beam"], r["n"], r["before"])
             for name, ep in out.items() for r in ep["rows"]]
    steps.append(("end", None, None, eng._n_active_host,
                  fingerprint(eng.pstate.pos)[2]))
    return steps, (log.records if log is not None else None)


def record_all_options(log_ops=False):
    """One all-options drive on a fresh engine: ``(steps, op records or
    None)``, a step being ``(tier_like, tier_beam, raw z, particle
    print)``."""
    eng = all_options.engine()
    eng.initial_pose(np.zeros(3), all_options.IDENT, worlds.TRACKING_COV)
    scans = all_options.Scans(np.random.default_rng(0),
                              all_options.CLOUD_POINTS)
    steps = []

    def on_step(_, res):
        aux = eng.last_aux
        steps.append((aux["tier_like"], aux["tier_beam"],
                      float(res.raw_pos[2]), fingerprint(eng.pstate.pos)[2]))

    log = OpLog() if log_ops else None
    with log if log is not None else contextlib.nullcontext():
        all_options.measure(eng, scans, all_options.N_SCANS, on_step)
    return steps, (log.records if log is not None else None)


RECORDS = {"main": record_drive, "recovery": record_recovery,
           "all-options": record_all_options}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--drives", type=int, default=3)
    ap.add_argument("--ops", action="store_true")
    ap.add_argument("--scan", choices=("rows", "torch"), default="rows")
    ap.add_argument("--drive", choices=sorted(RECORDS), default="main")
    a = ap.parse_args(argv)
    record = RECORDS[a.drive]
    device = resolve_device()
    if a.scan == "torch":
        for mod in (pf, samplers):
            mod.cumsum = lambda x: torch.cumsum(x, dim=0)
    build.build()
    where = card(device)
    runs = []
    for k in range(a.drives):
        steps, _ = record()
        runs.append(steps)
        for i, s in enumerate(steps):
            if a.drive == "main":
                what = (f"tiers {s[0]},{s[1]}, overflow {s[2]} of cap {s[3]}, "
                        f"fits {s[4]}/{s[5]}, raw z {s[6]:.6f}, particles "
                        f"{s[7]:x}")
            elif a.drive == "all-options":
                what = (f"tiers {s[0]},{s[1]}, raw z {s[2]:.6f}, particles "
                        f"{s[3]:x}")
            else:
                what = (f"{s[0]}, tiers {s[1]},{s[2]}, {s[3]} particles, "
                        f"from particles {s[4]:x}")
            print(f"drive {k} measurement {i}: {what}, scan {a.scan} "
                  f"[{where}]", flush=True)
    for k in range(1, a.drives):
        diff = next((i for i, (x, y) in enumerate(zip(runs[0], runs[k]))
                     if x[-1] != y[-1]), None)
        print(f"drive {k} against drive 0, scan {a.scan}: first measurement"
              f" with other particles: {diff} [{where}]", flush=True)
    if a.ops:
        logs = [record(log_ops=True)[1] for _ in range(2)]
        diff = first_difference(*logs)
        if diff is None:
            print(f"op logs, scan {a.scan}: {len(logs[0])} ops, equal "
                  f"[{where}]", flush=True)
        else:
            i, what = diff
            print(f"op logs, scan {a.scan}: {len(logs[0])} ops, first "
                  f"difference at op {i} {logs[0][i][0]} ({logs[0][i][3]}): "
                  f"{what} [{where}]",
                  flush=True)
    return runs


if __name__ == "__main__":
    main()
