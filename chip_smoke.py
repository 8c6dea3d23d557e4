#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each, the card's name and power limit beside every
time):

1. device facts: GPU, power limit, CUDA runtime, nvcc, triton;
2. build of the CUDA kernels with nvcc (first use), with its seconds;
3. the main path (``tools/grouped_pairs.engine`` and ``drive``):
   ``MCL3DL(Params(num_particles=1<<20), device="cuda")`` on the
   flagship room world, stationary odometry and scans through
   ``push_cloud``.  A first ``initial_pose`` spread wide in x/y (0.2 m)
   and tight in attitude is measured once, through the likelihood
   model's tier-1 box kernel K3; then ``initial_pose`` with the tracking
   spread and 10 more scans, which must end at tiers 0/0 (kernels K1 and
   K2) with a published pose within 0.05 m / 0.05 rad of the truth.  Kernel launch
   counts are zeroed right before the drive and read right after it;
4. each kernel against its plain PyTorch version on the card at the main
   path's shapes (inputs from the drive's last state): bit-equal on every
   slot whose value the caller keeps, then timed beside its bound;
5. where a steady step's time goes: each layer timed on the final state,
   ``push_cloud`` over 20 more scans, and one step under
   ``torch.profiler`` for the device-busy share;
6. the lookup microbenchmarks (kernels G1-G10, ``mcl_3dl_tpu_torch/tools``)
   at the JAX scripts' sizes: launch counts zeroed, the three tools run
   (``exp_gather`` with ``--risky``; each times its kernels and PyTorch
   library calls over 25 launches), counts read; then each kernel's whole
   output held equal (``torch.equal``) to its plain version, and the plain
   version timed.

Times are medians of CUDA-event timings (``tools.time_ms``); bounds are
``tools.bound``: bytes over 3.35 TB/s or f32 operations over 67 TFLOP/s,
whichever is longer.

The second-to-last line is the card's ``nvidia-smi`` name and power
limit, the one before it the kernel JSON; the last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises (exit code
1); without a CUDA device the script exits 1 before any phase.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

STEADY_STEPS = 20              # extra scans timed at steady state


def sh(cmd):
    out = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, check=False)
    return out.stdout.strip()


def profile_step(eng, scan, origin, card):
    """One steady measurement under ``torch.profiler``: the device-busy
    share of its wall time; the op table goes to
    chiprun_out/profile_step.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    labels = np.zeros(len(scan), np.int64)
    orig = origin[None].astype(np.float32)
    eng.measure_direct(scan, orig, labels, 100.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.measure_direct(scan, orig, labels, 100.1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/profile_step.txt", "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=40))
    print(f"phase 5 profile: step wall {wall * 1e3:.2f} ms, device busy "
          f"{dev_us / 1e3:.2f} ms ({100.0 * dev_us / 1e3 / (wall * 1e3):.1f}%),"
          f" {len(events)} distinct ops {card}", flush=True)


def lookup_phase(card):
    """Phase 6: drive the three lookup tools with the launch counts zeroed
    (each times its kernels and library calls, 25 launches a median),
    then hold every kernel's whole output against its plain version and
    time the plain version.  Returns the kernels' JSON rows (G10 at S=8,
    the grouped kernels' tile height)."""
    import torch
    from mcl_3dl_tpu_torch.ops import gather_bench as ogb
    from mcl_3dl_tpu_torch.tools import (exp_gather, exp_gather2,
                                         exp_rowsel_shape, time_ms)

    for w in ogb.WRAPPERS:
        w.launches = 0
    lookups = (exp_gather.main(risky=True) + exp_gather2.main()
               + exp_rowsel_shape.main())
    launches = {w.__name__: w.launches for w in ogb.WRAPPERS}
    assert all(n > 0 for n in launches.values()), launches
    rows, seen = [], set()
    for e in lookups:
        if e.wrapper is None:
            continue                 # a library row: its line is the tool's
        got, want = e.run(), e.plain()
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want), (
            f"{e.tag} {e.name} {e.note}: kernel != plain")
        err = float((got.double() - want.double()).abs().max())
        plain_ms = time_ms(e.plain, 3)
        lib = (f", {e.library_label} {e.library_ms:.4f} ms"
               if e.library_ms is not None else "")
        print(f"phase 6 {e.tag} {e.name}{' (' + e.note + ')' if e.note else ''}:"
              f" equal on {got.numel()} outputs, {e.ms:.4f} ms, "
              f"{e.lookups / e.ms / 1e6:.3f} G lookups/s (bound {e.bound_ms:.4f}"
              f" ms by {e.bound_by}), plain {plain_ms:.3f} ms{lib}, launches "
              f"{launches[e.name]} {card}", flush=True)
        if e.name in seen:
            continue
        seen.add(e.name)
        rows.append(dict(name=e.name, route="cuda",
                         source="mcl_3dl_tpu_torch/csrc/gather_bench.cu",
                         replaces=e.replaces, launches=launches[e.name],
                         max_abs_err=err, ms=e.ms, plain_ms=plain_ms,
                         bound_ms=e.bound_ms, bound_by=e.bound_by,
                         library_ms=e.library_ms))
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mcl_3dl_tpu_torch import worlds
    from mcl_3dl_tpu_torch.models.beam import grouped_beam_inputs
    from mcl_3dl_tpu_torch.models.likelihood import (box_queries, box_tables,
                                                     grouped_like_inputs)
    from mcl_3dl_tpu_torch.ops import build
    from mcl_3dl_tpu_torch.ops import grouped as og
    from mcl_3dl_tpu_torch.ops import local_gather as olg
    from mcl_3dl_tpu_torch.tools import bound, time_ms
    from mcl_3dl_tpu_torch.tools import grouped_pairs as gp

    # ---- phase 1: device facts
    name = torch.cuda.get_device_name(0)
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    nvcc = sh([build._nvcc(), "--version"]).splitlines()[-1]
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    card = f"[{smi}]"
    print(f"phase 1 device: {name} | nvidia-smi: {smi} | torch {torch.__version__}"
          f" cuda {torch.version.cuda} | nvcc: {nvcc} | triton: {triton_v}",
          flush=True)

    # ---- phase 2: build
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.library()
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s (nvcc, "
          f"{len(build.SOURCES)} sources in parallel + link)", flush=True)

    # ---- phase 3: the main path through the public entry points
    eng = gp.engine()
    rng = np.random.default_rng(0)
    origin = np.array([0.0, 0.0, worlds.SENSOR_Z])
    ident = np.array([0.0, 0.0, 0.0, 1.0])
    kernels = {"like": og.grouped_like_score, "beam": og.grouped_beam_pen,
               "local": olg.local_score}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    steps = []
    t = gp.drive(eng, rng, on_step=lambda dt, res: steps.append(
        (dt, eng.last_aux["tier_like"], eng.last_aux["tier_beam"], res)))
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    print("phase 3 per step (tier_like, tier_beam, raw z): "
          + " ".join(f"{a},{b},{r.raw_pos[2]:.4f}" for _, a, b, r in steps),
          flush=True)
    last = steps[-1][3]
    assert (steps[-1][1], steps[-1][2]) == (0, 0), "not at tiers 0/0"
    assert all(n > 0 for n in launches.values()), launches
    for key in ("e_pos", "e_rot", "pub_pos", "pub_rot", "cov", "entropy",
                "match_ratio_min", "match_ratio_max"):
        assert np.isfinite(np.asarray(eng.last_aux[key], np.float64)).all(), key
    # the published pose (TF-smoothed, what a user of the node reads)
    pos_err = float(np.linalg.norm(last.pos))
    w = abs(float(last.rot[3])) / float(np.linalg.norm(last.rot))
    rot_err = 2.0 * float(np.arccos(min(w, 1.0)))       # rotation angle
    assert pos_err < 0.05 and rot_err < 0.05, (last.pos, last.rot)
    raw_err = float(np.linalg.norm(last.raw_pos))
    steady = [dt for dt, a, b, _ in steps if (a, b) == (0, 0)][1:]
    step_s = statistics.median(steady)
    print(f"phase 3 main path: {gp.NUM_PARTICLES} particles, {len(steps)} "
          f"measurements, launches {launches}, published pose err {pos_err:.4f} m"
          f" / {rot_err:.4f} rad (raw mean {raw_err:.4f} m), push_cloud median {step_s * 1e3:.2f} ms over "
          f"{len(steady)} steady steps, "
          f"{gp.NUM_PARTICLES * (96 + 3) / step_s:.4e} particle-point evals/s, "
          f"peak memory {peak / 2**30:.2f} GiB {card}", flush=True)

    # ---- phase 4: each kernel against its plain version, main-path shapes
    p = eng.params
    lp, bp = p.likelihood, p.beam
    scan = worlds.scan(rng, gp.CLOUD_POINTS)
    inp = gp.kernel_inputs(eng, scan)
    st = eng.pstate
    df = eng.map.df
    stats, layout, vp = inp.stats, inp.layout, inp.vp
    like_pts, like_valid = inp.like_pts, inp.like_valid
    results = []

    def report(kname, src, replaces, kernel, plain, bytes_, ops, launches_n,
               sel):
        """Hold ``kernel`` against ``plain`` on the slots ``sel`` (an index
        tensor), time both, and record the kernel's line."""
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        err = 0.0
        for a, b in zip(got, want):
            a, b = a[sel], b[sel]
            assert torch.equal(a, b), f"{kname}: kernel != plain"
            err = max(err, float((a - b).abs().max()))
        ms = time_ms(kernel, 25)
        plain_ms = time_ms(plain, 3)
        bound_ms, by = bound(bytes_, ops)
        results.append(dict(name=kname, route="cuda", source=src,
                            replaces=replaces, launches=launches_n,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=by, library_ms=None))
        print(f"phase 4 {kname}: bit-equal on {sel.numel()} slots, {ms:.4f} ms (bound {bound_ms:.4f} ms by {by}), plain "
              f"{plain_ms:.2f} ms {card}", flush=True)

    # K1 at [nt, 12, 1024] x 96 points x 97 bins
    report("like_score", "mcl_3dl_tpu_torch/csrc/grouped.cu",
           "mcl_3dl_tpu/ops/grouped.py:778 (_like_kernel)",
           lambda: og.grouped_like_score(*inp.like, **inp.like_kw),
           lambda: og.like_score_plain(*inp.like, **inp.like_kw),
           *inp.like_bound, launches["like"], inp.kept)

    # K2 at 3 beams x 61 probes x 97 bins
    report("beam_pen", "mcl_3dl_tpu_torch/csrc/grouped.cu",
           "mcl_3dl_tpu/ops/grouped.py:918 (_beam_kernel)",
           lambda: (og.grouped_beam_pen(*inp.beam, **inp.beam_kw),),
           lambda: (og.beam_pen_plain(*inp.beam, **inp.beam_kw),),
           *inp.beam_bound, launches["beam"], inp.kept)

    # K3 at 96 points x 1M particles (tier-1 box tables of this state)
    iq, lo3, ext = box_queries(df, st.pos, inp.rmat, like_pts)
    ltab, lidx = box_tables(df, iq, lo3, like_valid)
    del iq
    kw3 = dict(match_dist_min=lp.match_dist_min,
               match_dist_flat=lp.match_dist_flat, match_weight=lp.match_weight)
    n = lidx.shape[1]
    k3_bytes = ltab.numel() * 4 + lidx.numel() * 4 + 2 * n * 4
    report("local_score", "mcl_3dl_tpu_torch/csrc/local_gather.cu",
           "mcl_3dl_tpu/ops/local_gather.py:44 (_score_kernel)",
           lambda: olg.local_score(ltab, lidx, **kw3),
           lambda: olg.local_score_plain(ltab, lidx, **kw3),
           k3_bytes, lidx.numel() * 8, launches["local"],
           torch.arange(n, device=lidx.device))

    del ltab, lidx

    # ---- phase 5: per-layer split of a steady step (CUDA events, 5 runs)
    from mcl_3dl_tpu_torch.models.beam import _overflow_beam_pen
    from mcl_3dl_tpu_torch.models.likelihood import _score_from_dist

    over = layout.over_idx
    kms = {r["name"]: r["ms"] for r in results}

    def like_rescore():
        q = og.overflow_transform(stats.A, over, like_pts)
        d = og.overflow_field_lookup(df.field, q).to(torch.float32) * (df.trunc / 255.0)
        return _score_from_dist(d, like_valid[None, :], lp.match_dist_min,
                                lp.match_dist_flat, lp.match_weight, dim=1)

    def beam_rescore():
        return _overflow_beam_pen(
            eng.map.df_beam, st.pos, st.rot, over, inp.beam_pts,
            inp.beam_labels, inp.beam_valid, inp.cloud[3],
            map_grid_min=p.map_grid_min, map_grid_max=p.map_grid_max,
            hit_range=bp.hit_range,
            sin_total_ref=inp.beam_kw["sin_total_ref"],
            long_pen=inp.beam_kw["long_pen"], num_steps=vp.nprobe - 1)

    group_args = inp.group_args
    split = {
        "group stats + boxes + layout": time_ms(lambda: eng.group(*group_args), 5),
        "like tables + skip words": time_ms(lambda: grouped_like_inputs(
            df, stats, inp.lo_l, like_pts, like_valid, lp.match_dist_min), 5),
        "K1 like_score": kms["like_score"],
        "like overflow rescore": time_ms(like_rescore, 5),
        "beam tables + skip words": time_ms(lambda: grouped_beam_inputs(
            eng.map.df_beam, stats, inp.lo_b, vp, inp.beam_valid,
            p.map_grid_max), 5),
        "K2 beam_pen": kms["beam_pen"],
        "beam overflow rescore": time_ms(beam_rescore, 5),
    }
    models_ms = time_ms(lambda: eng._measure_models(*group_args), 5)
    split["measure_models total"] = models_ms
    split["rest of push_cloud (sampling, PF tail, host)"] = step_s * 1e3 - models_ms
    print("phase 5 split (ms): " + "; ".join(
        f"{k} {v:.3f}" for k, v in split.items()) + f" {card}", flush=True)

    # steady-state push_cloud time over STEADY_STEPS more scans
    times, tiers = [], set()
    for _ in range(STEADY_STEPS + 1):
        eng.odometry(np.zeros(3), ident, t)
        cloud = worlds.scan(rng, gp.CLOUD_POINTS)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = eng.push_cloud("lidar", cloud, origin, t)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        tiers.add((eng.last_aux["tier_like"], eng.last_aux["tier_beam"]))
        t += 0.1
    times = sorted(times[1:])
    print(f"phase 5 steady push_cloud over {len(times)} scans, tiers {tiers}:"
          f" median {statistics.median(times) * 1e3:.2f} ms, max "
          f"{times[-1] * 1e3:.2f} ms, {gp.NUM_PARTICLES * (96 + 3) / statistics.median(times):.4e}"
          f" particle-point evals/s {card}", flush=True)
    profile_step(eng, scan, origin, card)

    # ---- phase 6: the lookup microbenchmarks at the JAX scripts' sizes
    results += lookup_phase(card)

    print(json.dumps({"kernels": results}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
