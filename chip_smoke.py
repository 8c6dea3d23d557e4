#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each, the card's name and power limit beside every
time):

1. device facts: GPU, power limit, CUDA runtime, nvcc, triton;
2. build of the CUDA kernels with nvcc and of their torch operators with
   the host compiler (first use), with the seconds of each; then the map
   build on the host (``map_phase``): the native map compiler
   (``csrc/map_builder.cpp``, g++ at first use) against its numpy plain
   version, on the flagship world through ``MapData.build`` (the fields,
   the corner pack and the occupancy arrays byte-equal) and on one field
   of a 2.8M-point room, with the seconds of each and the host CPU;
3. the main path (``tools/grouped_pairs.engine`` and ``drive``):
   ``MCL3DL(Params(num_particles=1<<20), device="cuda")`` on the
   flagship room world, stationary odometry and scans through
   ``push_cloud``.  A first ``initial_pose`` spread wide in x/y (0.2 m)
   and tight in attitude is measured once, through the likelihood
   model's tier-1 box kernel K3; then ``initial_pose`` with the tracking
   spread and 10 more scans, which must end at tiers 0/0 (kernels K1 and
   K2) with a published pose within 0.05 m / 0.05 rad of the truth.  Each
   measurement goes through ``MCL3DL._step`` (``step_graph.py``: CUDA
   graphs of the step, replayed at tiers 0/0; the other steps run the rest
   eagerly), and the route of each is printed.  Kernel launch counts (K1,
   K2, K3 and M1, the fixed march; M2-M4 beside them) are zeroed right
   before the drive and read right after it;
4. each kernel against its plain PyTorch version on the card at the main
   path's shapes (inputs from the drive's last state): bit-equal on every
   slot whose value the caller keeps, then timed beside its bound, with
   a call split into device time (a CUDA graph's replay) and host time
   (1000 back-to-back calls); K3 also at the edges of its forms (N 128
   with K 1, N 384 with K 96, and the 1M case through a lidx view that
   is not 16-byte aligned), bit-equal; M1 on the 65,536 x 3 overflow rays
   of the drive's last state; the tier-2 kernels on the last state's
   whole tier-2 working set (``tools/grouped_pairs.tier2_cases``): M4 at
   1,048,576 x 96 queries, trilinear and nearest, beside
   ``torch.nn.functional.grid_sample``, and M2 and M3 on the 1,048,576 x
   3 beam rays (their launches are phases 8-10's, below);
5. where a steady step's time goes: each layer timed on the final state
   (and the likelihood's tier 1 around K3: box queries, box tables, K3);
   the graphed step (``_step``) and the eager ``_measurement_step``, 20
   steady steps each in turns (median, max), the device time of each
   graph's replay and the busy share it gives; 10 chained graphed steps
   held bit-equal to 10 eager ones on the same draws; the tier-2 graphs:
   trilinear sampling at 1,048,576 particles and the 64-particle step
   (no grouping), each on an engine of its own, 10 chained graphed steps
   held bit-equal to 10 eager ones with their routes, tiers and
   launches; the bench's fallback step (the wide spread) split into the
   front, the box check and its tier, and the beam's M2 march;
   ``push_cloud`` over 20 more scans; and a graphed and an eager step
   under ``torch.profiler`` for the device-busy share (run last);
6. the lookup microbenchmarks (kernels G1-G10, ``mcl_3dl_tpu_torch/tools``)
   at the JAX scripts' sizes: launch counts zeroed, the three tools run
   (``exp_gather`` with ``--risky``; each times its kernels and PyTorch
   library calls over 25 launches and splits a call into device time, from
   a CUDA graph's replay, and host time, from 1000 back-to-back calls),
   counts read; then each kernel's whole output held equal
   (``torch.equal``) to its plain version, and the plain version timed.
7. global recovery (``tools/recovery.py``): ``MCL3DL(Params(num_particles=64))``
   on the flagship room world, ``global_localization()`` from 122,328
   seeds decaying 0.75x a step to 64 particles (the box check scores
   the spread particles), then ``initial_pose`` + ``resize_particles``
   twice (clustered particles: K1 at 8 and 16 slots on capacities down to
   1024; a pose tight in attitude: K3 at capacity 512).  Every step must
   follow ``max(floor(0.75 n), 64)`` and capacity must end at the base
   bucket; launch counts are zeroed before and read after.  Then K1 at
   the largest-capacity step it scored and K3 at its 512-capacity step,
   each against its plain version as in phase 4;
8. the Tier-3 gate through the port (``tools/run_tier3.py``: with-imu,
   no-imu and no-odom at 220 steps, the reference's gate math), launch
   counts zeroed before and read after (the beam at tier 2: M2); a failed
   gate raises;
9. every option at full width (``tools/all_options.py``): 1,048,576
   particles on the flagship room world with trilinear sampling, the DDA
   raycast, the normal-weighted sampler, ``output_pcd`` and an
   ``on_match_clouds`` callback; 10 scans (a checkpoint saved after the
   fifth and loaded into a fresh engine, which must stay equal bit for
   bit over the next five), ``landmark`` at the truth, ``update_map``
   with a small wall, 5 more scans, at tiers 2/2 with no K1-K3 launch
   and M3 and M4 launched (counts zeroed before, read after).  The published pose must end
   within 0.05 m of the truth in x and y and 0.05 rad in rotation, its
   z above the truth by less than the DDA beam's bias bound
   (``all_options.z_bias_bound``: the DDA beam lifts z in this world, in
   the JAX engine alike); the raw pose of the first scan after the
   landmark within 0.05 m / 0.05 rad.  The PCD dump must read back, the
   inspection calls return the JAX engine's shapes.  Then the split of a
   step: normals on the host, the weighted draws, the trilinear
   likelihood and M4 in it, the DDA beam and M3 in it;
10. the trilinear Tier-3 gate (``tools/run_tier3.py --interp
   trilinear``, the three variants at 220 steps), beside the JAX
   package's record ``docs/TIER3_GATE_TRILINEAR.json``; launch counts
   zeroed before and read after (M4 and M2, both graphs replayed at
   capacity 512); a failed gate raises;
11. the fleet at full width (BASELINE config 5, ``tools/fleet.py``), in a
   child process at the 6x1x1 pose grid (``MCL_G_*``, read at import):
   1024 robots x 10,240 particles sharing the flagship map, 96 likelihood
   points + 3 beams on a 1024-point scan, through
   ``parallel.fleet_filter_step_grouped`` (launch counts zeroed before,
   read after), robot ``i``'s odometry moved by ``i * APART_M`` in x so
   that the robots publish distinct poses: a warm-up fleet step on given
   per-robot draws, then ``FLEET_STEPS`` timed steps on the robots' own
   generators, every robot through the engine's CUDA graphs (one pair
   serves them all; the routes are printed, and each graph's replay is
   timed alone for the card's busy share).  At least 99% of robots at tiers 0/0, every published pose
   finite, neighbours' published poses apart, two robots
   (chosen by seed) bit-equal to the single-robot step on the warm-up's
   state and draws; K1 and K2 at one robot's fleet shapes against their
   plain versions as in phase 4, and the split of a robot's step as in
   phase 5.  Then ``parallel.fleet_filter_step``
   (``torch.func.vmap`` of the ``spmd_safe`` step, tiers 2/2: M4 and M2
   through their vmap rules, one launch each a fleet step) at 128 x
   10,240 (robots apart as above), its peak memory, two robots within
   atol 1e-5 of the single-robot ``spmd_safe`` step, then one step at
   1024 robots (its time and peak memory, or that it ran out of memory);
   last, eight robots' grouped steps
   under ``torch.profiler`` for the fleet's device-busy share;
12. the particle split on the card: ``parallel.sharded_filter_step`` over
   NCCL with a world of 1 on the main path's 1,048,576-particle state
   (launch counts zeroed before, read after), against the plain step on
   the same draws (tiers 0/0, every output bit-equal), and the
   machinery's cost in ms (the two timed in turns).  Its launch counts go
   on phase 4's K1-K3 rows as ``split_launches`` (the same kernels at the
   same shapes, timed once).
13. the port's tools, each in a child process (its lines echoed, a
   non-zero exit fails the smoke): the bench (``tools/bench.py
   --processes 3``, every row: steady (graphed), steady_eager,
   ``push_cloud``, fallback, trilinear, global mode, each with its routes;
   its steady steps must run K1 and K2 at tiers 0/0 from both graphs, its
   trilinear steps replay both graphs at tiers 2/0, and its launch counts
   go on phase 4's K1-K3 rows as
   ``bench_launches``), the small-count sweep (``tools/exp_small.py``, 64
   / 512 / 16,384 particles, rows also in ``chiprun_out/exp_small.jsonl``;
   the 64-particle step replays both graphs) and the raycast harness
   (``tools/benchmark_raycast.py``: each march as kernel and plain loop,
   the kernel bit-equal to it).  It runs
   after the profiled step: the children are processes of their own.

Phase 6 ends with where a lone call of G3 and G4 spends its ``time_ms``
(the kernel alone on an idle card, and what the host adds before it
starts).

Times are medians of CUDA-event timings (``tools.time_ms``); bounds are
``tools.bound``: bytes over 3.35 TB/s or f32 operations over 67 TFLOP/s,
whichever is longer.

Standard output is copied to chiprun_out/chip_smoke.log.  The
second-to-last line is the card's ``nvidia-smi`` name and power
limit, the one before it the kernel JSON; the last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises (exit code
1); without a CUDA device the script exits 1 before any phase.
"""

import contextlib
import json
import os
import platform
import shutil
import signal
import statistics
import subprocess
import sys
import time

import numpy as np

STEADY_STEPS = 20              # extra scans timed at steady state
CHAIN_STEPS = 10               # graphed steps held bit-equal to eager ones
SEEDS_MIN = 100_000            # global localization: a ~100k-seed search
FLEET_ROBOTS = 1024            # BASELINE config 5: 1024 robots x 10,240
BATCHED_ROBOTS = 128
FLEET_STEPS = 1                # timed grouped fleet steps after the warm-up
FLEET_GRID = dict(MCL_G_YAW="6", MCL_G_PITCH="1", MCL_G_ROLL="1")
PROFILED_ROBOTS = 8            # the fleet's device-busy share, profiled
APART_M = 0.01                 # robot i's odometry offset in x: i * APART_M


def sh(cmd):
    out = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, check=False)
    return out.stdout.strip()


def routes_since(eng, before):
    """The routes ``_step`` took since the snapshot ``before`` (a copy of
    ``eng.step_routes``), the zeros left out."""
    return {k: v - before[k] for k, v in eng.step_routes.items()
            if v != before[k]}


def profile_step(eng, scan, origin, card):
    """One steady measurement under ``torch.profiler``, graphed (``_step``,
    after three unprofiled ones, so that it replays both graphs) and then
    eager (``_measurement_step``): the device-busy share of each one's
    wall time, returned by kind; the graphed step's op table goes to
    chiprun_out/profile_step.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    labels = np.zeros(len(scan), np.int64)
    orig = origin[None].astype(np.float32)
    t = 100.0
    for _ in range(3):
        eng.measure_direct(scan, orig, labels, t)
        t += 0.1
    torch.cuda.synchronize()
    shares, tables = {}, {}
    for kind in ("graphed", "eager"):
        if kind == "eager":
            eng._step = eng._measurement_step
        before = dict(eng.step_routes)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.measure_direct(scan, orig, labels, t)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        t += 0.1
        events = prof.key_averages()
        dev_us = sum(e.self_device_time_total for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        if kind == "eager":
            del eng._step
        tables[kind] = events.table(sort_by="self_device_time_total",
                                    row_limit=40)
        shares[kind] = dev_us / 1e3 / (wall * 1e3)
        print(f"phase 5 profile ({kind}, route {routes_since(eng, before)}):"
              f" step wall {wall * 1e3:.2f} ms, device busy "
              f"{dev_us / 1e3:.2f} ms ({100.0 * shares[kind]:.1f}%), "
              f"{len(events)} distinct ops {card}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/profile_step.txt", "w") as f:
        f.write(tables["graphed"])
    return shares


def graph_phase(eng, scan, card, steps=STEADY_STEPS, chain=CHAIN_STEPS):
    """Phase 5's graphed step on the engine's state, from fresh graphs:
    ``steps`` chained steps through ``_step`` and as many through the eager
    ``_measurement_step``, in turns, each timed on the host clock between
    two syncs; each graph's replay timed alone with CUDA events (its device
    time: the host enqueues a replay in one call); then ``chain`` chained
    graphed steps held bit-equal, every output, to as many eager steps on
    the same draws.  Returns ``(graphed ms list, eager ms list, A ms, B ms)``."""
    import torch
    from mcl_3dl_tpu_torch.tools import sharded, time_ms

    args = list(sharded.step_args(eng, scan))
    eng.drop_step_graphs()

    def advance(step, state, a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(state, *a)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        a[10], a[11], a[8], a[9] = out[1], out[2], out[3], out[4]
        return out[0], dt

    g_args, e_args = list(args), list(args)
    g_state = e_state = eng.pstate
    for _ in range(3):                 # warm-up, then the captures
        g_state, _ = advance(eng._step, g_state, g_args)
    before = dict(eng.step_routes)
    g_ms, e_ms = [], []
    for _ in range(steps):
        g_state, dt = advance(eng._step, g_state, g_args)
        g_ms.append(dt)
        e_state, dt = advance(eng._measurement_step, e_state, e_args)
        e_ms.append(dt)
    routes = routes_since(eng, before)
    entry = next(iter(eng._graphs.values()))
    a_ms = time_ms(entry.graph_a.replay, 5)
    b_ms = time_ms(entry.backs[(True, True)].graph.replay, 5)
    med = statistics.median
    print(f"phase 5 graphed step (_step): median {med(g_ms):.2f} ms, max "
          f"{max(g_ms):.2f} ms over {steps} steps, routes {routes}; eager "
          f"(_measurement_step), in turns: median {med(e_ms):.2f} ms, max "
          f"{max(e_ms):.2f} ms; device time of a replay: graph A "
          f"{a_ms:.3f} ms + graph B {b_ms:.3f} ms = "
          f"{100.0 * (a_ms + b_ms) / med(g_ms):.1f}% of the graphed step "
          f"{card}", flush=True)
    # every step replays graph A; B where both flags fit (tiers 0/0)
    assert set(routes) <= {"graph", "graph_front"}, routes
    assert routes.get("graph", 0) >= steps // 2, routes

    gen = torch.Generator(device=eng.device)
    gen.manual_seed(5)
    keeps = eng.keeps(args[2], args[4])
    draws = [eng.draw_step(*keeps, gen=gen) for _ in range(chain)]
    g_args, g_state, graphed = list(args), eng.pstate, []
    before = dict(eng.step_routes)
    for d in draws:
        out = eng._step(g_state, *g_args, d)
        graphed.append(out)
        g_state = out[0]
        g_args[10], g_args[11], g_args[8], g_args[9] = out[1:5]
    routes = routes_since(eng, before)
    e_args, e_state, tiers = list(args), eng.pstate, []
    for i, d in enumerate(draws):
        out = eng._measurement_step(e_state, *e_args, d)
        same = sharded.outputs_equal(graphed[i], out)
        assert same, f"graphed step {i} differs from the eager step"
        tiers.append((out[5]["tier_like"], out[5]["tier_beam"]))
        e_state = out[0]
        e_args[10], e_args[11], e_args[8], e_args[9] = out[1:5]
        graphed[i] = None
    print(f"phase 5 {chain} chained graphed steps at "
          f"{eng.pstate.capacity} particles bit-equal to {chain} eager steps "
          f"on the same draws: True (routes {routes}, tiers {tiers}) {card}",
          flush=True)
    return g_ms, e_ms, a_ms, b_ms


TIER2_GRAPHS = {
    # name -> (particles, tools.bench.build keywords, the tiers it runs)
    "trilinear-1M": (1 << 20, dict(interp="trilinear"), {(2, 0)}),
    "small-64": (64, {}, {(2, 2)}),
}


def tier2_graph_phase(card, chain=CHAIN_STEPS, device="cuda"):
    """Phase 5's tier-2 graphs: for each of ``TIER2_GRAPHS`` an engine of
    its own (``tools.bench.build``), two steps through ``_step`` (the
    warm-up and the captures), then ``chain`` chained graphed steps and as
    many eager ``_measurement_step`` steps on the same draws, each timed on
    the host between two syncs: every output bit-equal, every graphed step
    replaying both graphs at the expected tiers.  M2-M4, K1 and K2 counted
    over the graphed chain (zeroed just before it, read just after).
    Returns the launches by name."""
    import torch
    from mcl_3dl_tpu_torch.ops import grouped as og
    from mcl_3dl_tpu_torch.tools import bench, sharded

    counted = dict(tier2_kernels(), like=og.grouped_like_score,
                   beam=og.grouped_beam_pen)
    out = {}
    for name, (n, kw, want_tiers) in TIER2_GRAPHS.items():
        eng, _, args = bench.build(n, device, **kw)
        gen = torch.Generator(device=device)
        gen.manual_seed(6)
        keeps = eng.keeps(args[2], args[4])
        draws = [eng.draw_step(*keeps, gen=gen) for _ in range(chain + 2)]
        runs = {}
        for kind, step in (("warm", eng._step), ("graphed", eng._step),
                           ("eager", eng._measurement_step)):
            sel = draws[:2] if kind == "warm" else draws[2:]
            if kind == "graphed":
                for k in counted.values():
                    k.launches = 0
                before = dict(eng.step_routes)
            a, st, outs, ms = list(args), eng.pstate, [], []
            for d in sel:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                o = step(st, *a, d)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                outs.append(o)
                st = o[0]
                a[10], a[11], a[8], a[9] = o[1:5]
            if kind == "graphed":
                launches = {k: f.launches for k, f in counted.items()}
                routes = routes_since(eng, before)
            runs[kind] = (outs, ms)
        same = all(sharded.outputs_equal(g, e) for g, e in
                   zip(runs["graphed"][0], runs["eager"][0]))
        tiers = {(o[5]["tier_like"], o[5]["tier_beam"])
                 for o in runs["eager"][0]}
        med = statistics.median
        print(f"phase 5 tier-2 graphs {name}: {n} particles, {chain} chained "
              f"graphed steps bit-equal to {chain} eager ones on the same "
              f"draws {same}, routes {routes}, tiers {sorted(tiers)}, "
              f"launches {launches}; graphed median "
              f"{med(runs['graphed'][1]):.3f} ms (max "
              f"{max(runs['graphed'][1]):.3f}), eager median "
              f"{med(runs['eager'][1]):.3f} ms (max "
              f"{max(runs['eager'][1]):.3f}) {card}", flush=True)
        assert same, f"{name}: a graphed step differs from the eager step"
        assert routes == {"graph": chain}, routes
        assert tiers == want_tiers, tiers
        assert launches["field"] == chain, launches
        out[name] = launches
        del eng, args, draws, runs
        torch.cuda.empty_cache()
    return out


def fallback_split(card, device="cuda", n=1 << 20, steps=5):
    """Phase 5's split of the bench's fallback row (``tools/bench.py``):
    an engine of its own at ``n`` particles put at the wide ``initial_pose``
    (``bench.WIDE_COV``), the step on that state through ``_step``
    ``steps`` times after one warm-up (host clock between syncs; graph A
    replayed, the rest eagerly after the box check), then each layer of
    the remainder timed alone on the front's outputs (``time_ms``, 5
    runs).  Returns the layers' ms."""
    import torch
    from mcl_3dl_tpu_torch.engine import sphere_num_steps
    from mcl_3dl_tpu_torch.models.beam import beam_measure, march_sphere
    from mcl_3dl_tpu_torch.models.likelihood import (box_queries,
                                                     likelihood_measure)
    from mcl_3dl_tpu_torch.tools import bench, time_ms

    eng, _, args = bench.build(n, device)
    eng.initial_pose(np.zeros(3), bench.IDENT, bench.WIDE_COV)
    st = eng.pstate
    bench.steps(eng, st, args, 1, chain=False)            # the warm-up
    before = dict(eng.step_routes)
    _, times, tiers, _ = bench.steps(eng, st, args, steps, chain=False)
    routes = routes_since(eng, before)
    p = eng.params
    lp, bp = p.likelihood, p.beam
    df, df_beam = eng.map.df, eng.map.df_beam
    origins = args[5]
    fr = eng._step_front(st, df, df_beam, *args[2:6])
    fits = fr.fits()
    grouped = eng.group_layout(fr.group, fits)
    rmat = grouped[0]
    like = (df, st.pos, st.rot, fr.like_pts, fr.like_valid,
            lp.match_dist_min, lp.match_dist_flat, lp.match_weight)
    kw = dict(map_grid_min=p.map_grid_min, map_grid_max=p.map_grid_max,
              hit_range=bp.hit_range, beam_likelihood_min=bp.beam_likelihood,
              num_points_default=bp.num_points,
              sin_total_ref=float(np.sin(bp.ang_total_ref)),
              add_penalty_short_only_mode=bp.add_penalty_short_only_mode,
              num_steps=sphere_num_steps(p))
    ends = torch.einsum("bj,nij->nbi", fr.beam_pts, rmat) + st.pos[:, None]
    begins = (torch.einsum("bj,nij->nbi", origins[fr.beam_labels], rmat)
              + st.pos[:, None])
    layers = {
        "front (graph A's work, eager)": time_ms(
            lambda: eng._step_front(st, df, df_beam, *args[2:6]), 5,
            device),
        "fits read + layout": time_ms(
            lambda: eng.group_layout(fr.group, fr.fits()), 5, device),
        "likelihood (box check, then its tier)": time_ms(
            lambda: likelihood_measure(*like, active=fr.mask, rmat=rmat,
                                       grouped=grouped[1]), 5, device),
        "of it box_queries": time_ms(
            lambda: box_queries(df, st.pos, rmat, fr.like_pts), 5, device),
        "beam at tier 2": time_ms(lambda: beam_measure(
            df_beam, st.pos, st.rot, fr.beam_pts, fr.beam_labels,
            fr.beam_valid, origins, **kw), 5, device),
        "of it M2 march_sphere": time_ms(lambda: march_sphere(
            df_beam, begins, ends, p.map_grid_min, p.map_grid_max,
            bp.hit_range, kw["num_steps"]), 5, device),
    }
    tier = likelihood_measure(*like, active=fr.mask, rmat=rmat,
                              grouped=grouped[1])[2]
    print(f"phase 5 fallback split at {n} particles (the wide spread): "
          f"fits {fits}, likelihood tier {tier}, step tiers {tiers}, routes "
          f"{routes}, _step median {statistics.median(times):.3f} ms (max "
          f"{max(times):.3f}) over {steps}; layers (ms): " + "; ".join(
              f"{k} {v:.3f}" for k, v in layers.items()) + f" {card}",
          flush=True)
    del eng, args, fr, grouped, begins, ends
    if device == "cuda":
        torch.cuda.empty_cache()
    return layers


def lone_calls(where):
    """Phase 6's G3 and G4 at the JAX script's size: where a lone call's
    ``time_ms`` goes (the kernel alone on an idle card, and what the host
    adds before it starts; ``gather_pairs.lone_calls``)."""
    import torch
    from mcl_3dl_tpu_torch.tools import exp_gather, gather_pairs

    rows = [e for e in exp_gather.lookups(torch.device("cuda"), risky=True)
            if e.tag in ("G3", "G4")]
    print("phase 6 lone calls:", flush=True)
    gather_pairs.lone_calls(rows, {}, where, tags=("G3", "G4"))


def report(results, card, kname, src, replaces, kernel, plain, bytes_, ops,
           launches_n, sel, phase=4, library=None):
    """Hold ``kernel`` against ``plain`` on the slots ``sel`` (an index
    tensor), time both (and ``library``, one PyTorch call for the same
    function, where given), and record the kernel's line in
    ``results``."""
    import torch
    from mcl_3dl_tpu_torch.tools import bound, split, time_ms

    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    err = 0.0
    for a, b in zip(got, want):
        a, b = a[sel], b[sel]
        assert torch.equal(a, b), f"{kname}: kernel != plain"
        err = max(err, float((a.double() - b.double()).abs().max()))
    ms = time_ms(kernel, 25)
    dev_ms, host_ms = split(kernel)
    plain_ms = time_ms(plain, 3)
    lib_ms = time_ms(library, 25) if library is not None else None
    bound_ms, by = bound(bytes_, ops)
    results.append(dict(name=kname, route="cuda", source=src,
                        replaces=replaces, launches=launches_n,
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=by, library_ms=lib_ms))
    lib = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
    print(f"phase {phase} {kname}: bit-equal on {sel.numel()} slots, {ms:.4f} ms "
          f"(device {dev_ms:.4f} + host {host_ms:.4f} a call; bound "
          f"{bound_ms:.4f} ms by {by}), plain {plain_ms:.2f} ms{lib} {card}",
          flush=True)


def host_cpu():
    """The host CPU's model name (``/proc/cpuinfo``, else ``lscpu``, else
    the machine type) and its logical core count."""
    model = None
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.split(":")[0].strip() in ("model name", "Model name"):
                model = line.split(":", 1)[1].strip()
                break
    if model is None and shutil.which("lscpu"):
        for line in sh(["lscpu"]).splitlines():
            if line.startswith("Model name:"):
                model = line.split(":", 1)[1].strip()
                break
    return f"{model or platform.machine()}, {os.cpu_count()} cores"


@contextlib.contextmanager
def numpy_map_builds():
    """``MapData.build`` through the numpy map builds (the native map
    compiler's plain versions) inside the block."""
    import functools
    from mcl_3dl_tpu_torch.map import distance_field, occupancy

    saved = distance_field.build_field_codes, occupancy.build_occupancy_arrays
    distance_field.build_field_codes = functools.partial(saved[0],
                                                         native=False)
    occupancy.build_occupancy_arrays = functools.partial(saved[1],
                                                         native=False)
    try:
        yield
    finally:
        distance_field.build_field_codes, occupancy.build_occupancy_arrays = saved


def map_phase(card):
    """Phase 2's map build: the native map compiler (g++ at first use)
    against its numpy plain version, on the host.  The flagship world
    through ``MapData.build`` (labels 0-2 from a seed with
    ``filter_label_max`` 1, so the beam field is a second build; the
    occupancy grid at the default DDA cell), native and numpy: ``df``,
    ``df_beam`` and the occupancy arrays byte-equal.  Then one field of
    ``worlds.make_room(-40, 40, -40, 40, grid=0.05)`` (cell 0.1, trunc
    0.3), native and numpy (timed once): bytes equal."""
    import torch
    from mcl_3dl_tpu_torch import worlds
    from mcl_3dl_tpu_torch.config import BeamParams, Params
    from mcl_3dl_tpu_torch.map.distance_field import build_field_codes
    from mcl_3dl_tpu_torch.map.map_data import MapData
    from mcl_3dl_tpu_torch.ops import build

    lib = build.build_map(verbose=True)
    built = (f"built by g++ in {build.seconds['map']:.2f} s"
             if "map" in build.seconds else "already built")
    print(f"phase 2 map builder: {lib.parent.name}/{lib.name} {built}, on "
          f"{host_cpu()} {card}", flush=True)
    pts = worlds.world_map()
    labels = np.random.default_rng(7).integers(0, 3, len(pts)).astype(
        np.uint32)
    params = Params(beam=BeamParams(filter_label_max=1))
    maps, secs = {}, {}
    for name in ("native", "numpy", "native"):
        with (numpy_map_builds() if name == "numpy"
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            m = MapData.build(pts, params, labels, device="cuda")
            torch.cuda.synchronize()
            secs.setdefault(name, []).append(time.perf_counter() - t0)
        maps[name] = m
    a, b = maps["native"], maps["numpy"]
    assert a.df_beam is not a.df and b.df_beam is not b.df
    for x, y, what in ((a.df.field, b.df.field, "df"),
                       (a.df_beam.field, b.df_beam.field, "df_beam"),
                       (a.df.packed, b.df.packed, "df corner pack"),
                       (a.occ.occupied, b.occ.occupied, "occupied"),
                       (a.occ.min_label, b.occ.min_label, "min_label"),
                       (a.occ.rep_point, b.occ.rep_point, "rep_point")):
        assert torch.equal(x, y), f"map build: native {what} != numpy"
    print(f"phase 2 map flagship: {len(pts)} points -> {len(a.points)} after "
          f"the voxel grid, df {tuple(a.df.shape)}, occupancy "
          f"{tuple(a.occ.shape)}; MapData.build native "
          f"{secs['native'][0]:.3f} s (then {secs['native'][1]:.3f} s), numpy "
          f"{secs['numpy'][0]:.3f} s; df, df_beam, corner pack and occupancy "
          f"arrays byte-equal on {host_cpu()} {card}", flush=True)
    del maps, a, b

    room = worlds.make_room(-40.0, 40.0, -40.0, 40.0, grid=0.05)
    t0 = time.perf_counter()
    got, origin = build_field_codes(room, 0.1, 0.3)
    t1 = time.perf_counter()
    want, want_origin = build_field_codes(room, 0.1, 0.3, native=False)
    t2 = time.perf_counter()
    assert np.array_equal(got, want) and np.array_equal(origin, want_origin), \
        "large map: native field != numpy"
    print(f"phase 2 map large room: {len(room)} points, one field "
          f"{got.shape} (cell 0.1, trunc 0.3): native {t1 - t0:.3f} s, numpy "
          f"{t2 - t1:.3f} s, byte-equal, on {host_cpu()} {card}", flush=True)


def local_edges(card, k3):
    """K3 held bit-equal to its plain version at the edges of its forms:
    N 128 with K 1 and N 384 with K 96 (the tiled form), and the 1M case
    ``k3`` (a ``local_case``) through a lidx view that is not 16-byte
    aligned (the scalar form).  These launches are not counted."""
    import torch
    from mcl_3dl_tpu_torch.ops import local_gather as olg

    (tables, lidx), kw, _, _ = k3
    rng = np.random.default_rng(11)
    cases = {}
    for n, k in ((128, 1), (384, 96)):
        cases[f"N {n} K {k}"] = (tables[:k], torch.tensor(
            rng.integers(0, tables[0].numel(), (k, n)), dtype=torch.int32,
            device=lidx.device))
    flat = torch.empty(lidx.numel() + 1, dtype=torch.int32,
                       device=lidx.device)
    flat[1:] = lidx.reshape(-1)
    unaligned = flat[1:].view(lidx.shape)
    assert unaligned.data_ptr() % 16 != 0
    cases[f"N {lidx.shape[1]} K {lidx.shape[0]} unaligned"] = (tables,
                                                               unaligned)
    for name, (tab, idx) in cases.items():
        got = olg.local_score(tab, idx, **kw)
        want = olg.local_score_plain(tab, idx, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), \
            f"K3 at {name}: kernel != plain"
        print(f"phase 4 local_score at {name}: bit-equal to plain, "
              f"{int((got[1] > 0).sum())} particles matched {card}",
              flush=True)
    del flat, unaligned


K1_SRC = ("mcl_3dl_tpu_torch/csrc/grouped.cu",
          "mcl_3dl_tpu/ops/grouped.py:778 (_like_kernel)")
K2_SRC = ("mcl_3dl_tpu_torch/csrc/grouped.cu",
          "mcl_3dl_tpu/ops/grouped.py:918 (_beam_kernel)")
M1_SRC = ("mcl_3dl_tpu_torch/csrc/beam_march.cu",
          "none: XLA lax.fori_loop, mcl_3dl_tpu/models/beam.py:269-331 "
          "(raycast_fixed, called at :488)")
T2_CU = "mcl_3dl_tpu_torch/csrc/tier2.cu"
TIER2_SRC = {
    "march_sphere": (T2_CU, "none: XLA lax.while_loop, mcl_3dl_tpu/models/"
                     "beam.py:132 (raycast_df, :43-156)"),
    "march_dda": (T2_CU, "none: XLA lax.while_loop, mcl_3dl_tpu/models/"
                  "beam.py:259 (raycast_occ, :159-266)"),
    "sample_field": (T2_CU, "none: the gather XLA fuses into the tier-2 "
                     "likelihood, mcl_3dl_tpu/models/likelihood.py:170-187"),
}
TIER2_SRC["sample_field_nearest"] = TIER2_SRC["sample_field"]
# the drive that gives each tier-2 row its launches (counts zeroed just
# before it, read just after) and the row's count there: the trilinear
# gate's tier-2 beam (phase 10), the DDA and trilinear all-options drive
# at 1M (phase 9), the 64-particle graphed chain (phase 5)
TIER2_PATH = {"march_sphere": ("phase 10", "sphere"),
              "march_dda": ("phase 9", "dda"),
              "sample_field": ("phase 9", "field"),
              "sample_field_nearest": ("phase 5 small-64", "field")}


def tier2_kernels():
    """M2-M4's wrappers by their launch-count key."""
    from mcl_3dl_tpu_torch.map.distance_field import sample_field
    from mcl_3dl_tpu_torch.models.beam import march_dda, march_sphere

    return {"sphere": march_sphere, "dda": march_dda, "field": sample_field}


def model_layers(eng, inp, k1_ms, k2_ms):
    """Each layer of ``_measure_models`` timed alone on the engine's state
    (``time_ms``, 5 runs; ``inp`` from ``grouped_pairs.kernel_inputs``),
    K1's and K2's times given: ms by layer name, the total last."""
    import torch
    from mcl_3dl_tpu_torch.models.beam import (_overflow_beam_pen,
                                               grouped_beam_inputs)
    from mcl_3dl_tpu_torch.models.likelihood import (_score_from_dist,
                                                     grouped_like_inputs)
    from mcl_3dl_tpu_torch.ops import grouped as og
    from mcl_3dl_tpu_torch.tools import time_ms

    p = eng.params
    lp, bp = p.likelihood, p.beam
    st, df = eng.pstate, eng.map.df
    stats, vp, over = inp.stats, inp.vp, inp.layout.over_idx
    like_pts, like_valid = inp.like_pts, inp.like_valid

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
    return {
        "group stats + boxes + layout": time_ms(lambda: eng.group(*group_args), 5),
        "like tables + skip words": time_ms(lambda: grouped_like_inputs(
            df, stats, inp.lo_l, like_pts, like_valid, lp.match_dist_min), 5),
        "K1 like_score": k1_ms,
        "like overflow rescore": time_ms(like_rescore, 5),
        "beam tables + skip words": time_ms(lambda: grouped_beam_inputs(
            eng.map.df_beam, stats, inp.lo_b, vp, inp.beam_valid,
            p.map_grid_max), 5),
        "K2 beam_pen": k2_ms,
        "beam overflow rescore": time_ms(beam_rescore, 5),
        "measure_models total": time_ms(
            lambda: eng._measure_models(*group_args), 5),
    }


def tier1_split(eng, inp, k3_ms):
    """The likelihood's tier 1 at the main path's final state, each piece
    timed alone (``time_ms``, 5 runs; K3's time given): ms by piece."""
    from mcl_3dl_tpu_torch.models.likelihood import box_queries, box_tables
    from mcl_3dl_tpu_torch.tools import time_ms

    df, pos = eng.map.df, eng.pstate.pos
    iq, lo, _ = box_queries(df, pos, inp.rmat, inp.like_pts)
    return {
        "box_queries": time_ms(
            lambda: box_queries(df, pos, inp.rmat, inp.like_pts), 5),
        "box_tables": time_ms(
            lambda: box_tables(df, iq, lo, inp.like_valid), 5),
        "K3 local_score": k3_ms,
    }


def kernel_rows(report_fn, inp, launches, suffix, phase):
    """K1 and K2 held against their plain versions at ``inp``
    (``grouped_pairs.kernel_inputs``)."""
    from mcl_3dl_tpu_torch.ops import grouped as og

    report_fn(f"like_score{suffix}", *K1_SRC,
              lambda: og.grouped_like_score(*inp.like, **inp.like_kw),
              lambda: og.like_score_plain(*inp.like, **inp.like_kw),
              *inp.like_bound, launches["like"], inp.kept, phase=phase)
    report_fn(f"beam_pen{suffix}", *K2_SRC,
              lambda: (og.grouped_beam_pen(*inp.beam, **inp.beam_kw),),
              lambda: (og.beam_pen_plain(*inp.beam, **inp.beam_kw),),
              *inp.beam_bound, launches["beam"], inp.kept, phase=phase)


def fleet_child(robots=FLEET_ROBOTS, batched=BATCHED_ROBOTS,
                steps=FLEET_STEPS):
    """Phase 11, in a child process whose environment holds the fleet's
    pose grid: the grouped fleet, its checks and K1/K2 at its shapes,
    then the batched fleet.  Prints its lines and, last, ``FLEET_ROWS``
    and the kernels' JSON rows."""
    import torch
    from mcl_3dl_tpu_torch import worlds
    from mcl_3dl_tpu_torch.models.beam import march_fixed
    from mcl_3dl_tpu_torch.ops import build
    from mcl_3dl_tpu_torch.ops import grouped as og
    from mcl_3dl_tpu_torch.ops import local_gather as olg
    from mcl_3dl_tpu_torch.parallel import (fleet_filter_step,
                                            fleet_filter_step_grouped)
    from mcl_3dl_tpu_torch.tools import fleet, sharded, time_ms
    from mcl_3dl_tpu_torch.tools import grouped_pairs as gp

    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    card = f"[{smi}]"
    grid = f"{og.G_YAW}x{og.G_PITCH}x{og.G_ROLL}"
    build.library()
    results = []
    eng = fleet.engine(fleet.NUM_PARTICLES, "cuda")
    start = eng.pstate
    cap = start.capacity
    scan = worlds.scan(np.random.default_rng(0), fleet.CLOUD_POINTS)

    kernels = {"like": og.grouped_like_score, "beam": og.grouped_beam_pen,
               "local": olg.local_score, "march": march_fixed}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    routes0 = dict(eng.step_routes)
    t0 = time.perf_counter()
    step = fleet_filter_step_grouped(eng)
    args = fleet.apart(fleet.inputs(eng, robots, scan), APART_M)
    draws = fleet.given_draws(eng, args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    warm = step(*args, None, draws)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    times, out = [], warm
    for _ in range(steps):
        nxt = fleet.advance(args, out)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = step(*nxt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    launches = {k: fn.launches for k, fn in kernels.items()}
    routes = {k: v - routes0[k] for k, v in eng.step_routes.items()
              if v != routes0[k]}
    peak = torch.cuda.max_memory_allocated()
    aux = out[5]
    t0_like = float((aux["tier_like"] == 0).float().mean())
    t0_beam = float((aux["tier_beam"] == 0).float().mean())
    t0_both = float(((aux["tier_like"] == 0) & (aux["tier_beam"] == 0))
                    .float().mean())
    finite = bool(torch.isfinite(aux["pub_pos"]).all()
                  and torch.isfinite(aux["pub_rot"]).all())
    gap = fleet.min_gap(aux["pub_pos"])
    ms = statistics.median(times) * 1e3
    print(f"phase 11 grouped fleet {robots}x{cap} (grid {grid}): warm-up "
          f"{warm_s * 1e3:.1f} ms, step {ms:.1f} ms (median of {steps}: "
          f"{[round(t * 1e3, 1) for t in times]}), {robots / (ms / 1e3):.2f} "
          f"robot-updates/s, {robots * cap * 99 / (ms / 1e3):.4e} "
          f"particle-point evals/s, tiers 0/0 on {t0_both:.4f} of robots "
          f"(like {t0_like:.4f}, beam {t0_beam:.4f}), launches {launches}, "
          f"routes of the robots' steps {routes}, "
          f"robots apart by {APART_M} m in odometry, published {gap:.4f} m "
          f"apart at least, peak memory {peak / 2**30:.2f} GiB, set-up {setup_s:.1f} s "
          f"{card}", flush=True)
    assert t0_both >= 0.99, (t0_like, t0_beam)
    assert finite, "non-finite published pose"
    assert gap > APART_M / 2, gap
    assert launches["like"] > 0 and launches["beam"] > 0, launches
    assert routes.get("graph", 0) >= 0.99 * robots * steps, routes
    # the device time of a robot's graphs, each replay timed alone
    entry = next(e for e in eng._graphs.values() if (True, True) in e.backs)
    a_ms = time_ms(entry.graph_a.replay, 5)
    b_ms = time_ms(entry.backs[(True, True)].graph.replay, 5)
    print(f"phase 11 a robot's graphs: A {a_ms:.3f} ms + B {b_ms:.3f} ms of "
          f"device time against {ms / robots:.3f} ms a robot in the timed "
          f"fleet step: the card busy {100.0 * (a_ms + b_ms) * robots / ms:.1f}%"
          f" {card}", flush=True)

    # two robots against the single-robot step on the warm-up's inputs
    thr = (eng.params.std_warn_thresh_xy, eng.params.std_warn_thresh_z,
           eng.params.std_warn_thresh_yaw)
    picks = sorted(np.random.default_rng(11).choice(robots, 2, replace=False))
    for i in picks:
        i = int(i)
        one = eng._measurement_step(
            fleet.robot_state(args[0], i), args[1], args[2],
            *(a[i] for a in args[3:11]), fleet.robot_filter(args[11], i),
            fleet.robot_filter(args[12], i), False, thr,
            type(draws)(*(None if d is None else d[i] for d in draws)))
        same = sharded.outputs_equal(
            one, (fleet.robot_state(warm[0], i), fleet.robot_filter(warm[1], i),
                  fleet.robot_filter(warm[2], i), warm[3][i], warm[4][i],
                  {k: (v[i] if isinstance(one[5][k], torch.Tensor)
                       else v[i].item()) for k, v in warm[5].items()}))
        print(f"phase 11 robot {i}: bit-equal to the single-robot eager "
              f"step {same} {card}", flush=True)
        assert same, f"robot {i} differs from the single-robot step"

    # K1 and K2 at one robot's fleet shapes (its state after the warm-up)
    eng.pstate = fleet.robot_state(warm[0], int(picks[0]))
    inp = gp.kernel_inputs(eng, worlds.scan(np.random.default_rng(2),
                                            fleet.CLOUD_POINTS))
    print(f"phase 11 K1/K2 at {cap} particles, {inp.layout.A.shape[0]} "
          f"tiles, {og.G_GROUPS} groups {card}", flush=True)
    kernel_rows(lambda *a, **k: report(results, card, *a, **k), inp,
                launches, "_fleet", 11)
    layers = model_layers(eng, inp, results[-2]["ms"], results[-1]["ms"])
    print("phase 11 split of a robot's eager step (ms): " + "; ".join(
        f"{k} {v:.3f}" for k, v in layers.items()) + f" {card}", flush=True)
    del inp, warm, out, nxt, args, draws
    eng.pstate = start

    # the batched fleet (tier 2) at BATCHED_ROBOTS x 10,240: M4 and M2
    # through their vmap rules, one launch each a fleet step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bstep = fleet_filter_step(eng)
    args = fleet.apart(fleet.inputs(eng, batched, scan), APART_M)
    draws = fleet.given_draws(eng, args)
    tier2 = tier2_kernels()
    torch.cuda.synchronize()
    for fn in tier2.values():
        fn.launches = 0
    t1 = time.perf_counter()
    bout = bstep(*args, None, draws)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    bnext = bstep(*fleet.advance(args, bout))
    torch.cuda.synchronize()
    b_ms = (time.perf_counter() - t1) * 1e3
    bpeak = torch.cuda.max_memory_allocated()
    b_launches = {k: fn.launches for k, fn in tier2.items()}
    baux = bout[5]
    tiers = sorted(set(zip(baux["tier_like"].tolist(),
                           baux["tier_beam"].tolist())))
    errs = []
    for i in sorted(np.random.default_rng(12).choice(batched, 2,
                                                     replace=False)):
        i = int(i)
        one = eng._measurement_step(
            fleet.robot_state(args[0], i), args[1], args[2],
            *(a[i] for a in args[3:11]), fleet.robot_filter(args[11], i),
            fleet.robot_filter(args[12], i), False, thr,
            type(draws)(*(None if d is None else d[i] for d in draws)),
            spmd_safe=True)
        errs.append(max(float((one[5][k] - baux[k][i]).abs().max())
                        for k in ("e_pos", "pub_pos")))
    b_gap = fleet.min_gap(baux["pub_pos"])
    print(f"phase 11 batched fleet {batched}x{cap}: warm-up {warm_s * 1e3:.1f}"
          f" ms, step {b_ms:.1f} ms, {batched / (b_ms / 1e3):.2f} "
          f"robot-updates/s, tiers {tiers}, published poses {b_gap:.4f} m "
          f"apart at least, peak memory "
          f"{bpeak / 2**30:.2f} GiB, launches over the two fleet steps "
          f"{b_launches}, two robots against the single-robot "
          f"spmd_safe step: max |e_pos, pub_pos| diff {max(errs):.3e} "
          f"{card}", flush=True)
    assert tiers == [(2, 2)], tiers
    assert b_launches["field"] == 2 and b_launches["sphere"] == 2, b_launches
    assert bool(torch.isfinite(bnext[5]["pub_pos"]).all())
    assert max(errs) <= 1e-5, errs
    assert b_gap > APART_M / 2, b_gap
    del args, draws, bout, bnext

    # one batched fleet step at FLEET_ROBOTS robots: does it fit now?
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        args = fleet.apart(fleet.inputs(eng, robots, scan), APART_M)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        big = bstep(*args)
        torch.cuda.synchronize()
        big_ms = (time.perf_counter() - t1) * 1e3
        fits = bool(torch.isfinite(big[5]["pub_pos"]).all())
        note = (f"step {big_ms:.1f} ms (the first at this size), "
                f"{robots / (big_ms / 1e3):.2f} robot-updates/s, published "
                f"poses finite {fits}")
        del big
    except torch.OutOfMemoryError as e:
        note = f"out of memory ({str(e).splitlines()[0]})"
    print(f"phase 11 batched fleet {robots}x{cap}: {note}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}",
          flush=True)
    args = None
    torch.cuda.empty_cache()

    # the grouped fleet's device-busy share: PROFILED_ROBOTS robots'
    # steps under torch.profiler (last: once the profiler has run, later
    # launches read slower)
    from torch.profiler import ProfilerActivity, profile
    args = fleet.inputs(eng, PROFILED_ROBOTS, scan)
    step(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"phase 11 profile: {PROFILED_ROBOTS} robots' grouped steps "
          f"(graphed), wall "
          f"{wall * 1e3:.1f} ms, device busy {dev_us / 1e3:.2f} ms "
          f"({100.0 * dev_us / 1e3 / (wall * 1e3):.1f}%) {card}", flush=True)
    print("FLEET_ROWS " + json.dumps(results), flush=True)


def fleet_phase(card):
    """Phase 11: ``fleet_child`` in a child process at ``FLEET_GRID``; its
    lines are echoed, its kernel rows returned.  A failed child raises."""
    env = dict(os.environ, **FLEET_GRID)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--fleet-phase"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    rows = None
    for line in proc.stdout:
        if line.startswith("FLEET_ROWS "):
            rows = json.loads(line[len("FLEET_ROWS "):])
        else:
            print(line, end="", flush=True)
    if proc.wait() != 0 or rows is None:
        raise RuntimeError(f"phase 11 failed (exit {proc.returncode})")
    return rows


def split_phase(eng, scan, card):
    """Phase 12: ``sharded_filter_step`` over NCCL with a world of 1 on
    the engine's state against the plain step (same draws), launch counts
    zeroed before and read after and returned."""
    import socket

    import torch
    import torch.distributed as dist
    from mcl_3dl_tpu_torch.ops import grouped as og
    from mcl_3dl_tpu_torch.ops import local_gather as olg
    from mcl_3dl_tpu_torch.parallel import make_mesh
    from mcl_3dl_tpu_torch.tools import sharded

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh()
        kernels = {"like": og.grouped_like_score,
                   "beam": og.grouped_beam_pen, "local": olg.local_score}
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        plain_ms, split_ms, equal, aux = sharded.time_split(eng, scan, mesh,
                                                            iters=5)
        launches = {k: fn.launches for k, fn in kernels.items()}
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    tiers = (aux["tier_like"], aux["tier_beam"])
    print(f"phase 12 particle split, world 1 over {backend}: "
          f"{eng.pstate.capacity} particles, tiers {tiers}, outputs bit-equal "
          f"to the plain step {equal}, step {split_ms:.2f} ms against plain "
          f"{plain_ms:.2f} ms (median of 5 each, in turns): machinery "
          f"{split_ms - plain_ms:.2f} ms, launches {launches} {card}",
          flush=True)
    assert tiers == (0, 0), tiers
    assert equal, "the split step differs from the plain step"
    assert launches["like"] > 0 and launches["beam"] > 0, launches
    return launches


TOOLS = (
    ("bench", ("mcl_3dl_tpu_torch.tools.bench", "--processes", "3"), 600),
    ("exp_small", ("mcl_3dl_tpu_torch.tools.exp_small", "--out",
                   "chiprun_out/exp_small.jsonl"), 300),
    ("benchmark_raycast", ("mcl_3dl_tpu_torch.tools.benchmark_raycast",),
     300),
)


def tools_phase(card):
    """Phase 13: each of ``TOOLS`` in a child process (``python -m``, with
    its time limit in seconds); every line it writes is echoed, and a
    child that exits non-zero raises.  Returns the bench's metric line."""
    root = os.path.dirname(os.path.abspath(__file__))
    stdout = {}
    for name, args, limit in TOOLS:
        t0 = time.perf_counter()
        # a session of its own: on a timeout the bench's children go too
        proc = subprocess.Popen([sys.executable, "-m", *args], cwd=root,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        try:
            out, err = proc.communicate(timeout=limit)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise
        for stream, tag in ((err, " (stderr)"), (out, "")):
            for line in stream.splitlines():
                print(f"phase 13 {name}{tag}: {line}", flush=True)
        print(f"phase 13 {name}: exit {proc.returncode} after "
              f"{time.perf_counter() - t0:.1f} s {card}", flush=True)
        if proc.returncode:
            raise RuntimeError(f"phase 13 {name} exited {proc.returncode}")
        stdout[name] = out.splitlines()
    bench = json.loads(stdout["bench"][-1])
    ex = bench["extra"]
    assert bench["metric"] == "particle_likelihood_evals_per_sec_chip", bench
    assert (ex["tier_like"], ex["tier_beam"]) == (0, 0), ex["steady_tiers"]
    for launches in ex["launches_steady"]:
        assert launches["like"] > 0 and launches["beam"] > 0, launches
    for routes in ex["routes_steady"]:
        assert set(routes) == {"graph"} or not any(
            n for k, n in routes.items() if k != "graph"), routes
    # the trilinear row replays both graphs at tiers 2/0
    assert ex["trilinear_tiers"] == [[2, 0]], ex["trilinear_tiers"]
    for routes in ex["trilinear_routes"]:
        assert set(routes) == {"graph"}, routes
    rows = [json.loads(line) for line in stdout["exp_small"]]
    assert [r["num_particles"] for r in rows] == [64, 512, 16384], rows
    assert set(rows[0]["routes"]) == {"graph"}, rows[0]["routes"]
    casts = [line for line in stdout["benchmark_raycast"] if "casts" in line]
    assert len(casts) == 4 and all("bit-equal to plain True" in line
                                   for line in casts), casts
    return bench


def lookup_phase(card):
    """Phase 6: drive the three lookup tools with the launch counts zeroed
    (each times its kernels and library calls, 25 launches a median, and
    splits a call into device and host time),
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
        lib = (f", {e.library_label} {e.library_ms:.4f} ms (device "
               f"{e.library_device_ms:.4f} + host {e.library_host_ms:.4f})"
               if e.library_ms is not None else "")
        print(f"phase 6 {e.tag} {e.name}{' (' + e.note + ')' if e.note else ''}:"
              f" equal on {got.numel()} outputs, {e.ms:.4f} ms (device "
              f"{e.device_ms:.4f} + host {e.host_ms:.4f} a call), "
              f"{e.lookups / e.ms / 1e6:.3f} G lookups/s ({e.bound_text}), "
              f"plain {plain_ms:.3f} ms{lib}, launches "
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


def global_phase(card, report):
    """Phase 7: the three global-recovery episodes of ``tools/recovery.py``
    (``global_localization`` from 122,328 seeds, then two
    ``resize_particles`` episodes) with the launch counts zeroed before
    and read after; the decay and the final capacity are checked by the
    drive.  Then K1 at the largest-capacity step it scored and K3 at the
    512-capacity step it scored, each against its plain version on the
    step's state with a fresh scan."""
    import torch
    from mcl_3dl_tpu_torch.ops import grouped as og
    from mcl_3dl_tpu_torch.ops import local_gather as olg
    from mcl_3dl_tpu_torch.tools import grouped_pairs as gp
    from mcl_3dl_tpu_torch.tools import recovery

    eng = recovery.engine("cuda")
    kernels = {"like": og.grouped_like_score, "local": olg.local_score}
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = recovery.run(eng, np.random.default_rng(1),
                       before_step=lambda e: e.pstate,
                       log=lambda s: print(f"phase 7 {s} {card}", flush=True))
    launches = {k: fn.launches for k, fn in kernels.items()}
    secs = time.perf_counter() - t0
    rows = [r for ep in out.values() for r in ep["rows"]]
    print(f"phase 7 global recovery: {len(rows)} measurements in {secs:.2f}"
          f" s, launches {launches}, tiers "
          f"{sorted({(r['tier_like'], r['tier_beam']) for r in rows})} {card}",
          flush=True)
    assert out["global"]["seeds"] >= SEEDS_MIN, out["global"]["seeds"]
    assert all(n > 0 for n in launches.values()), launches

    lp = eng.params.likelihood
    df = eng.map.df
    cloud = gp.recovery_cloud(eng)
    k1_row = max((r for r in rows if r["tier_like"] == 0),
                 key=lambda r: r["capacity"])
    st, pts, valid, _, (stats, layout, lo, _) = gp.recovery_step_inputs(
        eng, k1_row, cloud)
    if layout is None:
        layout = og.build_layout(stats, og.default_overflow_cap(st.capacity))
    args, kw, bnd, kept = gp.like_case(df, lp, stats, layout, lo, pts, valid)
    print(f"phase 7 K1 at capacity {st.capacity}, {int(st.n_active)} active,"
          f" {k1_row['slots']} slots {card}", flush=True)
    report("like_score_global", "mcl_3dl_tpu_torch/csrc/grouped.cu",
           "mcl_3dl_tpu/ops/grouped.py:778 (_like_kernel)",
           lambda: og.grouped_like_score(*args, **kw),
           lambda: og.like_score_plain(*args, **kw), *bnd, launches["like"],
           kept, phase=7)
    del args, layout, stats

    (args, kw, bnd, kept), k3_row = gp.global_local_case(eng, rows, cloud)
    st = k3_row["before"]
    print(f"phase 7 K3 at capacity {st.capacity}, {int(st.n_active)} active,"
          f" {k3_row['slots']} slots {card}", flush=True)
    report("local_score_global", "mcl_3dl_tpu_torch/csrc/local_gather.cu",
           "mcl_3dl_tpu/ops/local_gather.py:44 (_score_kernel)",
           lambda: olg.local_score(*args, **kw),
           lambda: olg.local_score_plain(*args, **kw), *bnd,
           launches["local"], kept, phase=7)


def gate_phase(card):
    """Phase 8: the Tier-3 gate (with-imu, no-imu, no-odom at 220 steps)
    through the port on the card, launch counts zeroed before and read
    after; a failed gate raises.  The result goes to
    chiprun_out/tier3_gate.json.  Returns M2-M4's launches."""
    import torch
    from mcl_3dl_tpu_torch.ops import grouped as og
    from mcl_3dl_tpu_torch.ops import local_gather as olg
    from mcl_3dl_tpu_torch.tools import run_tier3

    kernels = {"like": og.grouped_like_score, "beam": og.grouped_beam_pen,
               "local": olg.local_score, **tier2_kernels()}
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    traces = {}
    result = run_tier3.run_all(device="cuda", traces=traces)
    launches = {k: fn.launches for k, fn in kernels.items()}
    result["device"] = "cuda"
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/tier3_gate.json", "w") as f:
        json.dump(result, f, indent=1)
    for name, trace in traces.items():
        g = result[name]
        tiers = {}
        for t in trace:
            tiers[f"{t[0]},{t[1]}"] = tiers.get(f"{t[0]},{t[1]}", 0) + 1
        print(f"phase 8 gate {name}: pass {g['pass']}, {g['poses']} poses, max"
              f" error {g['max_error_m']} m ({g['pose_violations']} "
              f"violations), max tf diff {g['max_tf_diff_m']} m "
              f"({g['tf_violations']} violations), kidnap {g.get('kidnap')}, "
              f"{g['seconds']:.2f} s, tiers (like,beam): {tiers} {card}",
              flush=True)
    print(f"phase 8 gate launches {launches} {card}", flush=True)
    assert result["pass"], result
    assert launches["sphere"] > 0, launches        # the beam at tier 2
    return {k: launches[k] for k in tier2_kernels()}


def all_options_phase(card):
    """Phase 9: the all-options drive of ``tools/all_options.py`` at
    1,048,576 particles with the launch counts zeroed before and read
    after, its checks, then the split of a step on the final state.
    Returns M2-M4's launches."""
    import torch
    from mcl_3dl_tpu_torch import worlds
    from mcl_3dl_tpu_torch.engine import dda_num_steps
    from mcl_3dl_tpu_torch.map.distance_field import sample_field
    from mcl_3dl_tpu_torch.math import quat as mq
    from mcl_3dl_tpu_torch.models.beam import beam_measure, march_dda
    from mcl_3dl_tpu_torch.models.likelihood import likelihood_measure
    from mcl_3dl_tpu_torch.ops import grouped as og
    from mcl_3dl_tpu_torch.ops import local_gather as olg
    from mcl_3dl_tpu_torch.tools import all_options as ao
    from mcl_3dl_tpu_torch.tools import time_ms

    kernels = {"like": og.grouped_like_score, "beam": og.grouped_beam_pen,
               "local": olg.local_score}
    tier2 = tier2_kernels()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in tier2.values():
        fn.launches = 0
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    eng = ao.engine("cuda")
    times = []
    out = ao.run(eng, lambda: ao.engine("cuda"), np.random.default_rng(3),
                 on_step=lambda dt, res: times.append(dt),
                 log=lambda s: print(f"phase 9 {s} {card}", flush=True),
                 out_dir="chiprun_out")
    launches = {k: fn.launches for k, fn in kernels.items()}
    t2_launches = {k: fn.launches for k, fn in tier2.items()}
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    pos_err, rot_err = out["pose_err"]
    raw_err = out["raw_err_after_landmark"]
    steady = sorted(times[1:])
    print(f"phase 9 all options: {ao.NUM_PARTICLES} particles, {len(times)} "
          f"measurements in {secs:.2f} s, tiers {sorted(set(out['tiers']))}, "
          f"launches {launches} (tier 2: {t2_launches}), published pose "
          f"err {pos_err:.4f} m (x-y "
          f"{out['xy_err']:.4f} m, z {out['z']:.4f} m) / {rot_err:.4f} rad "
          f"(raw z {out['raw_z']:.4f} m), raw pose after the landmark "
          f"{raw_err[0]:.4f} m / {raw_err[1]:.4f} rad, push_cloud median "
          f"{statistics.median(steady) * 1e3:.2f} ms, max "
          f"{steady[-1] * 1e3:.2f} ms over {len(steady)} steps, peak memory "
          f"{peak / 2**30:.2f} GiB {card}", flush=True)
    print(f"phase 9 outputs: PCD {out['pcd_points']} points written, "
          f"{out['pcd_read']} read back; match clouds {out['matches']}; "
          f"get_particles {out['particles']}; debug_beam_status "
          f"{out['beam_status']}; {out['diagnostics']} {card}", flush=True)
    assert set(out["tiers"]) == {(2, 2)}, out["tiers"]
    assert all(n == 0 for n in launches.values()), launches
    assert t2_launches["dda"] > 0 and t2_launches["field"] > 0, t2_launches
    assert out["xy_err"] < 0.05 and rot_err < 0.05, out["pose_err"]
    assert abs(out["z"]) < ao.z_bias_bound(eng.params), out["z"]
    assert raw_err[0] < 0.05 and raw_err[1] < 0.05, raw_err
    assert out["pcd_points"] == out["pcd_read"] > 0, out
    n = int(eng.pstate.n_active)
    assert out["particles"] == (((n, 3), np.float32), ((n, 4), np.float32),
                                ((n,), np.float32)), out["particles"]
    assert out["beam_status"][:2] == ((64,), np.int64), out["beam_status"]
    assert out["matches"] and out["diagnostics"].ok, out

    # the split of a step on the final state
    p = eng.params
    lp, bp = p.likelihood, p.beam
    st = eng.pstate
    scan = worlds.scan(np.random.default_rng(4), ao.CLOUD_POINTS)
    pts_ds, cloud = eng.prepare_cloud(scan, np.zeros(len(scan), np.int64),
                                      ao.ORIGIN[None].astype(np.float32))
    normals = eng.scan_normals(pts_ds, cloud[0].shape[0])
    draws = eng.draw_step(cloud[2], cloud[2])

    def sample():
        return eng.sample_points(*cloud[:3], draws, state=st, normals=normals)

    (like_pts, like_valid, beam_pts, beam_labels, beam_valid, _,
     _) = sample()
    kw = dict(map_grid_min=p.map_grid_min, map_grid_max=p.map_grid_max,
              hit_range=bp.hit_range, beam_likelihood_min=bp.beam_likelihood,
              num_points_default=bp.num_points,
              sin_total_ref=float(np.sin(bp.ang_total_ref)),
              add_penalty_short_only_mode=bp.add_penalty_short_only_mode,
              num_steps=dda_num_steps(p), use_dda=True, occ=eng.map.occ,
              filter_label_max=bp.filter_label_max,
              ray_angle_half=bp.ray_angle_half,
              min_dist_thr_sq=p.min_dist_thr_sq)
    args = (st.pos, st.rot, st.active_mask(), eng.map.df, eng.map.df_beam,
            like_pts, like_valid, beam_pts, beam_labels, beam_valid, cloud[3])
    rmat = mq.rotation_matrix(mq.normalize(st.rot))
    queries = torch.einsum("kj,nij->nki", like_pts, rmat) + st.pos[:, None]
    ends = torch.einsum("bj,nij->nbi", beam_pts, rmat) + st.pos[:, None]
    begins = (torch.einsum("bj,nij->nbi", cloud[3][beam_labels], rmat)
              + st.pos[:, None])
    dda = (bp.hit_range, bp.filter_label_max, dda_num_steps(p),
           bp.ray_angle_half, p.min_dist_thr_sq)
    layers = {
        "normals on the host": time_ms(
            lambda: eng.scan_normals(pts_ds, cloud[0].shape[0]), 5),
        "weighted draws (moments, eigh, top-k)": time_ms(sample, 5),
        "trilinear likelihood": time_ms(lambda: likelihood_measure(
            eng.map.df, st.pos, st.rot, like_pts, like_valid,
            lp.match_dist_min, lp.match_dist_flat, lp.match_weight,
            trilinear=True), 5),
        "of it M4 sample_field": time_ms(
            lambda: sample_field(eng.map.df, queries, True), 5),
        "DDA beam model": time_ms(lambda: beam_measure(
            eng.map.df_beam, st.pos, st.rot, beam_pts, beam_labels,
            beam_valid, cloud[3], **kw), 5),
        "of it M3 march_dda": time_ms(
            lambda: march_dda(eng.map.occ, begins, ends, *dda), 5),
        "measure_models total": time_ms(lambda: eng._measure_models(*args), 5),
    }
    layers["rest of push_cloud (PF tail, host)"] = (
        statistics.median(steady) * 1e3 - layers["normals on the host"]
        - layers["weighted draws (moments, eigh, top-k)"]
        - layers["measure_models total"])
    print("phase 9 split (ms): " + "; ".join(
        f"{k} {v:.3f}" for k, v in layers.items()) + f" {card}", flush=True)
    return t2_launches


def trilinear_gate_phase(card):
    """Phase 10: the Tier-3 gate with ``--interp trilinear`` (three
    variants, 220 steps), launch counts zeroed before and read after,
    each variant beside the JAX package's record; a failed gate raises.
    The result goes to chiprun_out/tier3_gate_trilinear.json.  Returns
    M2-M4's launches."""
    import torch
    from mcl_3dl_tpu_torch.ops import grouped as og
    from mcl_3dl_tpu_torch.ops import local_gather as olg
    from mcl_3dl_tpu_torch.tools import run_tier3

    kernels = {"like": og.grouped_like_score, "beam": og.grouped_beam_pen,
               "local": olg.local_score, **tier2_kernels()}
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    traces = {}
    result = run_tier3.run_all(device="cuda", traces=traces,
                               interp="trilinear")
    launches = {k: fn.launches for k, fn in kernels.items()}
    result["device"] = "cuda"
    with open("chiprun_out/tier3_gate_trilinear.json", "w") as f:
        json.dump(result, f, indent=1)
    with open("docs/TIER3_GATE_TRILINEAR.json") as f:
        ref = json.load(f)
    for name, trace in traces.items():
        g, r = result[name], ref[name]
        tiers = {}
        for t in trace:
            tiers[f"{t[0]},{t[1]}"] = tiers.get(f"{t[0]},{t[1]}", 0) + 1
        print(f"phase 10 trilinear gate {name}: pass {g['pass']}, "
              f"{g['poses']} poses, max error {g['max_error_m']} m [JAX "
              f"record {r['max_error_m']}] ({g['pose_violations']} "
              f"violations), max tf diff {g['max_tf_diff_m']} m [JAX record "
              f"{r['max_tf_diff_m']}] ({g['tf_violations']} violations), "
              f"kidnap {g.get('kidnap')}, {g['seconds']:.2f} s, tiers "
              f"(like,beam): {tiers} {card}", flush=True)
    print(f"phase 10 trilinear gate launches {launches} {card}", flush=True)
    assert result["pass"] and result["interp"] == "trilinear", result
    assert launches["like"] == 0 and launches["beam"] == 0, launches
    assert launches["field"] > 0 and launches["sphere"] > 0, launches
    return {k: launches[k] for k in tier2_kernels()}


class Tee:
    """Standard output, copied line for line to a log file, so a runner
    that returns only the end of the output still leaves the whole
    log."""

    def __init__(self, stream, path):
        self.stream = stream
        self.file = open(path, "w")

    def write(self, text):
        self.file.write(text)
        return self.stream.write(text)

    def flush(self):
        self.file.flush()
        self.stream.flush()


def main() -> int:
    import torch

    if "--fleet-phase" in sys.argv:          # phase 11's child process
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        fleet_child()
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    os.makedirs("chiprun_out", exist_ok=True)
    sys.stdout = Tee(sys.stdout, "chiprun_out/chip_smoke.log")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mcl_3dl_tpu_torch import worlds
    from mcl_3dl_tpu_torch.models.beam import march_fixed
    from mcl_3dl_tpu_torch.ops import build
    from mcl_3dl_tpu_torch.ops import grouped as og
    from mcl_3dl_tpu_torch.ops import local_gather as olg
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
    secs = dict(build.seconds)
    build.library()
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{secs.get('nvcc', 0.0):.2f} s for {len(build.SOURCES)} sources, "
          f"host compiler {secs.get('host', 0.0):.2f} s for the binding "
          f"{build.BINDING}, in parallel; link {secs.get('link', 0.0):.2f} s;"
          f" operators torch.ops.{build.namespace()})", flush=True)
    map_phase(card)

    # ---- phase 3: the main path through the public entry points
    eng = gp.engine()
    rng = np.random.default_rng(0)
    origin = np.array([0.0, 0.0, worlds.SENSOR_Z])
    ident = np.array([0.0, 0.0, 0.0, 1.0])
    kernels = {"like": og.grouped_like_score, "beam": og.grouped_beam_pen,
               "local": olg.local_score, "march": march_fixed}
    tier2 = tier2_kernels()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in (*kernels.values(), *tier2.values()):
        fn.launches = 0
    steps, seen = [], [dict(eng.step_routes)]

    def on_step(dt, res):
        steps.append((dt, eng.last_aux["tier_like"],
                      eng.last_aux["tier_beam"], res,
                      ",".join(routes_since(eng, seen[0]))))
        seen[0] = dict(eng.step_routes)

    t = gp.drive(eng, rng, on_step=on_step)
    launches = {k: fn.launches for k, fn in kernels.items()}
    tier2_drive = {k: fn.launches for k, fn in tier2.items()}
    peak = torch.cuda.max_memory_allocated()
    print("phase 3 per step (tier_like, tier_beam, raw z, route of _step): "
          + " ".join(f"{a},{b},{r.raw_pos[2]:.4f},{rt}"
                     for _, a, b, r, rt in steps), flush=True)
    last = steps[-1][3]
    assert (steps[-1][1], steps[-1][2]) == (0, 0), "not at tiers 0/0"
    assert steps[-1][4] == "graph", "the last step did not replay both graphs"
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
    steady = [dt for dt, a, b, _, _ in steps if (a, b) == (0, 0)][1:]
    step_s = statistics.median(steady)
    print(f"phase 3 main path: {gp.NUM_PARTICLES} particles, {len(steps)} "
          f"measurements, launches {launches} (tier 2: {tier2_drive}), "
          f"published pose err {pos_err:.4f} m"
          f" / {rot_err:.4f} rad (raw mean {raw_err:.4f} m), push_cloud median {step_s * 1e3:.2f} ms over "
          f"{len(steady)} steady steps, "
          f"{gp.NUM_PARTICLES * (96 + 3) / step_s:.4e} particle-point evals/s, "
          f"peak memory {peak / 2**30:.2f} GiB {card}", flush=True)

    # ---- phase 4: each kernel against its plain version, main-path shapes
    lp = eng.params.likelihood
    scan = worlds.scan(rng, gp.CLOUD_POINTS)
    inp = gp.kernel_inputs(eng, scan)
    results = []

    def report_here(*a, **kw):
        report(results, card, *a, **kw)

    # K1 at [nt, 12, 1024] x 96 points x 97 bins, K2 at 3 beams x 61
    # probes x 97 bins
    kernel_rows(report_here, inp, launches, "", 4)

    # K3 at 96 points x 1M particles (tier-1 box tables of this state)
    k3, kw3, k3_bound, k3_kept = gp.local_case(
        eng.map.df, lp, eng.pstate.pos, inp.rmat, inp.like_pts,
        inp.like_valid)
    report_here("local_score", "mcl_3dl_tpu_torch/csrc/local_gather.cu",
                "mcl_3dl_tpu/ops/local_gather.py:44 (_score_kernel)",
                lambda: olg.local_score(*k3, **kw3),
                lambda: olg.local_score_plain(*k3, **kw3),
                *k3_bound, launches["local"], k3_kept)
    local_edges(card, (k3, kw3, k3_bound, k3_kept))
    del k3

    # M1 at the 65,536 x 3 overflow rays of this state's layout
    m1_args, m1_bound, m1_kept = gp.march_case(eng, inp)
    report_here("march_fixed", *M1_SRC,
                lambda: march_fixed(*m1_args),
                lambda: march_fixed.plain(*m1_args), *m1_bound,
                launches["march"], m1_kept)
    del m1_args

    # M2-M4 on the last state's whole tier-2 working set: 1M x 96 queries,
    # 1M x 3 rays (launches set from their drives' counts below)
    cases = gp.tier2_cases(eng, inp)
    for kname in ("sample_field", "sample_field_nearest", "march_sphere",
                  "march_dda"):
        kernel, plain, (nb, ops), kept, library = cases.pop(kname)
        report_here(kname, *TIER2_SRC[kname], kernel, plain, nb, ops, None,
                    kept, library=library)
    del cases

    # ---- phase 5: per-layer split of a steady step (CUDA events, 5 runs)
    kms = {r["name"]: r["ms"] for r in results}
    layers = model_layers(eng, inp, kms["like_score"], kms["beam_pen"])
    tier1 = tier1_split(eng, inp, kms["local_score"])
    del inp
    _, e_ms, _, _ = graph_phase(eng, scan, card)
    layers["rest of the eager step (sampling, PF tail)"] = (
        statistics.median(e_ms) - layers["measure_models total"])
    print("phase 5 split of the eager step (ms): " + "; ".join(
        f"{k} {v:.3f}" for k, v in layers.items()) + f" {card}", flush=True)
    print("phase 5 tier-1 split at 1M x 96 (ms): " + "; ".join(
        f"{k} {v:.3f}" for k, v in tier1.items()) + f" {card}", flush=True)
    tier2_launches = {f"phase 5 {k}": v
                      for k, v in tier2_graph_phase(card).items()}
    fallback_split(card)

    # steady-state push_cloud time over STEADY_STEPS more scans
    times, tiers, before = [], set(), dict(eng.step_routes)
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
    print(f"phase 5 steady push_cloud over {len(times)} scans, routes "
          f"{routes_since(eng, before)}, tiers {tiers}:"
          f" median {statistics.median(times) * 1e3:.2f} ms, max "
          f"{times[-1] * 1e3:.2f} ms, {gp.NUM_PARTICLES * (96 + 3) / statistics.median(times):.4e}"
          f" particle-point evals/s {card}", flush=True)

    # ---- phase 6: the lookup microbenchmarks at the JAX scripts' sizes
    results += lookup_phase(card)
    lone_calls(smi)

    # ---- phase 7: global recovery; K1 and K3 at its shapes
    global_phase(card, report_here)

    # ---- phase 8: the Tier-3 gate through the port
    tier2_launches["phase 8"] = gate_phase(card)

    # ---- phase 9: every option at full width
    tier2_launches["phase 9"] = all_options_phase(card)

    # ---- phase 10: the trilinear Tier-3 gate
    tier2_launches["phase 10"] = trilinear_gate_phase(card)
    for r in results:          # M2-M4's rows: their drives' launches
        if r["name"] in TIER2_PATH:
            path, key = TIER2_PATH[r["name"]]
            r["launches"] = tier2_launches[path][key]
            r["launches_path"] = path
    print(f"phases 3-10 tier-2 launches: drive {tier2_drive}, "
          f"{tier2_launches} {card}", flush=True)

    # ---- phase 11: the fleet at full width (a child at the fleet's grid)
    results += fleet_phase(card)

    # ---- phase 12: the particle split over NCCL, a world of 1
    split = split_phase(eng, scan, card)
    for r in results:          # phase 4's rows: the same kernels, shapes
        key = {"like_score": "like", "beam_pen": "beam",
               "local_score": "local"}.get(r["name"])
        if key:
            r["split_launches"] = split[key]

    # phase 5's profiled step comes last: after a torch.profiler session
    # the host path of every later launch reads slower, phase 6's included
    shares = profile_step(eng, scan, origin, card)
    assert shares["graphed"] > 0.0, shares

    # ---- phase 13: the bench, the small-count sweep, the raycast harness
    bench = tools_phase(card)
    for r in results:          # the bench's steady steps, first process
        key = {"like_score": "like", "beam_pen": "beam",
               "local_score": "local"}.get(r["name"])
        if key:
            r["bench_launches"] = bench["extra"]["launches_steady"][0][key]

    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s {card}", flush=True)
    print(json.dumps({"kernels": results}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
