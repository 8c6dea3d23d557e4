"""The lookup kernels G1-G10 of this package against other builds of
them, timed in turns on the card at the JAX scripts' sizes.

    python -m mcl_3dl_tpu_torch.tools.gather_pairs [--pairs 5] [--variants]
        [NAME=DIR ...]

Each ``DIR`` is another copy of the ``mcl_3dl_tpu_torch`` package (an
older commit's, or one with an edited ``csrc/gather_bench.cu``).  Its
kernels are built from its own sources by its own ``ops/build.py`` and
launched through its own wrappers (``grouped_pairs.load_copy``), so each
build's whole launch path is timed, not only its kernels: an older
copy's ctypes calls, this one's torch operators.  ``--variants [NAME
...]`` adds the copies of ``VARIANTS`` (all, when none is named), this
package with other block shapes for G3, G4, G6 and G10 and G3 through
its ring of bulk-copied index tiles (the designs that are macros):
``#define`` lines in front of the copy's
``csrc/gather_bench.cu``, under the git-ignored ``build/variants/``.

The inputs are the three lookup tools' (``exp_gather.lookups(risky=True)``,
``exp_gather2.lookups``, ``exp_rowsel_shape.lookups``), built once,
followed by G5 at larger query counts (``SUB_SWEEP``, up to G7's 2^24)
and G10 at S=8 with fewer passes (``PASS_SWEEP``: with 0 passes it only
copies its table and streams its queries).

In each of ``--pairs`` rounds every build's kernel is timed once
(``time_ms``, the median of 25 launches, and ``tools.device_ms``, a
captured graph of 25 launches), in list order in even rounds and
reversed in odd ones, and the kernel's PyTorch library call once beside
them.  Printed per kernel and build: the median and quartiles of
``time_ms`` over the rounds, the ratio to the byte bound (with G10's
lookup-rate bound beside it), in how many rounds this package's build
was faster, the median device time of a call and in how many rounds this
build's was shorter, the host time of a call (``tools.host_ms``, once),
and whether the whole output is ``torch.equal`` to the plain version;
after each kernel, the SM clock ``nvidia-smi`` reads.  First it prints
the host time of G5's launch path, piece by piece, in every build
(``launch_path``) and the device time of a plain 64 MiB copy
(``copy_ceiling``); ``--only G3,G4`` keeps those rows; with ``--lone``
it ends with where a lone call of G3, G4 and G5 spends its time
(``lone_calls``).  Every line carries the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import shutil
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from mcl_3dl_tpu_torch.engine import resolve_device
from mcl_3dl_tpu_torch.ops import build
from mcl_3dl_tpu_torch.ops import gather_bench as ogb
from mcl_3dl_tpu_torch.tools import (card, device_ms, exp_gather, exp_gather2,
                                     exp_rowsel_shape, host_ms, kernel_lookup,
                                     nbytes, time_ms, to_device)
from mcl_3dl_tpu_torch.tools.grouped_pairs import (_quartiles, load_copy,
                                                   round_order, this_copy)

L = ogb.LANES
SUB_SWEEP = (1 << 17, 1 << 20, 1 << 23)    # G5 query counts beyond the script's
PASS_SWEEP = (0, 4)                        # G10 passes besides the script's 16
# block shapes besides this package's, as the macros at the top of
# csrc/gather_bench.cu name them.  G6 and G10: threads a block and the
# most blocks an SM holds, against one 768-thread block an SM.
VARIANTS = {f"{per_sm}x{threads}": dict(
    MCL_FLAT_THREADS=threads, MCL_FLAT_PER_SM=per_sm,
    MCL_ROWSEL_THREADS=threads, MCL_ROWSEL_PER_SM=per_sm)
    for per_sm, threads in ((1, 1024), (2, 512), (3, 256))}
# G3's int4 index groups a thread (against 2), G3 through the ring of
# bulk-copied index tiles (16-byte or bulk stores) and G4's rows a block
# (against 32)
VARIANTS.update({
    "g3_4groups": dict(MCL_G3_GROUPS=4),
    "g3_8groups": dict(MCL_G3_GROUPS=8),
    "g3_ring": dict(MCL_G3_RING=1),
    "g3_ring_bulk": dict(MCL_G3_RING=2),
    "g4_64rows": dict(MCL_U8_ROWS=64),
})


def variant(name, defines):
    """The build module of a copy of this package under
    ``build/variants/<name>/`` whose ``csrc/gather_bench.cu`` starts with
    ``#define`` lines for ``defines``.  Raises ``ValueError`` for a macro
    the source does not guard with ``#ifndef``: the copy would build this
    package's kernels unchanged, and their times would pass for another
    design's."""
    pkg = Path(build.__file__).resolve().parents[1]
    source = (pkg / "csrc" / "gather_bench.cu").read_text()
    unknown = [k for k in defines if f"#ifndef {k}\n" not in source]
    if unknown:
        raise ValueError(f"csrc/gather_bench.cu has no #ifndef for {unknown}")
    dst = pkg.parent / "build" / "variants" / name / pkg.name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(pkg, dst, ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "csrc" / "gather_bench.cu"
    cu.write_text("".join(f"#define {k} {v}\n" for k, v in defines.items())
                  + source)
    return load_copy(dst)


def sub_sweep(device, counts=SUB_SWEEP):
    """G5 (``sub_gather``) on the script's [128, 128] table with
    ``n // 128`` query rows for each ``n`` in ``counts``."""
    rng = np.random.default_rng(5)
    dev = to_device(device)
    tab = dev(rng.standard_normal((L, L)).astype(np.float32))
    out = []
    for n in counts:
        idx = dev(rng.integers(0, L, (n // L, L), dtype=np.int32))
        i64 = torch.remainder(idx + exp_gather.OFF, L).long()
        out.append(kernel_lookup(
            "G5", "tools/exp_gather.py:234 (sub_kernel :229)", ogb.sub_gather,
            (tab, idx, exp_gather.OFF), lookups=n,
            nbytes=nbytes(tab, idx) + 4 * n,
            library=lambda i64=i64: torch.gather(tab, 0, i64),
            library_label="torch.gather", note=f"{n} queries"))
    return out


def pass_sweep(device, passes=PASS_SWEEP):
    """G10 (``rowsel_accumulate``) at the script's size and S=8 with each
    number of ``passes``: its time against the passes splits the table
    copy and query stream from the lookups."""
    rows = []
    for k in passes:
        e, = exp_rowsel_shape.lookups(device, tiles=(8,), passes=k)
        e.note = f"S=8, {k} passes"
        rows.append(e)
    return rows


def lookups(device):
    """Every G kernel's experiment at the JAX scripts' sizes, then the G5
    and G10 sweeps; the tools' library-only rows (A, B) are left out."""
    rows = (exp_gather.lookups(device, risky=True) + exp_gather2.lookups(device)
            + exp_rowsel_shape.lookups(device))
    return ([e for e in rows if e.wrapper is not None] + sub_sweep(device)
            + pass_sweep(device))


def sm_clock():
    """The SM clock and its maximum as ``nvidia-smi`` reads them now."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def launch_path(device, others, where):
    """Print the host time a call of G5's launch path, piece by piece, on
    the script's inputs: the whole wrapper, the operator alone (its
    checks, its output's allocation and the launch), the operator with
    its overload looked up on every call, a ``torch.empty`` of the
    output; for each other build its whole wrapper and, where it launches
    through ctypes (``build.launch``), its two argument checks and its C
    call (the launch included); and ``torch.gather`` beside them."""
    rng = np.random.default_rng(5)
    dev = to_device(device)
    tab = dev(rng.standard_normal((L, L)).astype(np.float32))
    idx = dev(rng.integers(0, L, (L, L), dtype=np.int32))
    out = torch.empty_like(tab)
    i64 = torch.remainder(idx + 1, L).long()
    ns = build.library()
    pieces = {
        "sub_gather": lambda: ogb.sub_gather(tab, idx, 1),
        "op col_gather": lambda: build.op("col_gather")(tab, idx, 1, 0),
        "torch.ops lookup + call": lambda: ns.col_gather(tab, idx, 1, 0),
        "torch.empty": lambda: torch.empty((L, L), dtype=torch.float32,
                                           device=device),
    }
    ptrs = (tab.data_ptr(), idx.data_ptr(), out.data_ptr(), L, L * L, 1, 0)
    for name, copy in others.items():
        pieces[f"{name} sub_gather"] = (
            lambda copy=copy: copy.gather_bench.sub_gather(tab, idx, 1))
        b = copy.build
        if hasattr(b, "launch"):        # a ctypes build
            pieces[f"{name} build.check x2"] = (lambda b=b: (
                b.check(tab, "tab", torch.float32, None, tab.device),
                b.check(idx, "idx", torch.int32, None, tab.device)))
            pieces[f"{name} build.launch"] = (
                lambda b=b: b.launch("mcl_col_gather", *ptrs))
    pieces["torch.gather"] = lambda: torch.gather(tab, 0, i64)
    print("G5 launch path, host ms a call: " + "; ".join(
        f"{k} {host_ms(f):.4f}" for k, f in pieces.items()) + f" [{where}]",
        flush=True)


def compare(rows, others, pairs, where, clock=sm_clock):
    """Time each experiment of each build in ``pairs`` rounds; print and
    return ``[(experiment, {build: [ms, ...]}, {build: [device ms, ...]})]``
    (the library call's times under ``"library"``)."""
    versions = [("this", this_copy())] + list(others.items())
    out = []
    for e in rows:
        label = f"{e.tag} {e.name}" + (f" ({e.note})" if e.note else "")
        want = e.plain()
        equal, host = {}, {}
        run = {name: (lambda m=copy.gather_bench: e.run_in(m))
               for name, copy in versions}
        for name, _ in versions:
            equal[name] = torch.equal(run[name](), want)
            host[name] = host_ms(run[name])
        times = {name: [] for name, _ in versions + [("library", None)]}
        dev = {name: [] for name, _ in versions}
        for r in range(pairs):
            for name, _ in round_order(versions, r):
                times[name].append(time_ms(run[name], 25))
                dev[name].append(device_ms(run[name]))
            if e.library is not None:
                times["library"].append(time_ms(e.library, 25))
        for name, _ in versions:
            xs, ds = times[name], dev[name]
            q1, q3 = _quartiles(xs)
            med = statistics.median(xs)
            wins = sum(a < b for a, b in zip(times["this"], xs))
            dwins = sum(a < b for a, b in zip(dev["this"], ds))
            vs = "" if name == "this" else f", this faster in {wins} of {pairs}"
            dvs = "" if name == "this" else f", this shorter in {dwins} of {pairs}"
            print(f"{label} {name}: median {med:.4f} ms [q1 {q1:.4f}, q3 "
                  f"{q3:.4f}] over {pairs} rounds, {med / e.bound_ms:.2f}x the "
                  f"{e.bound_text}{vs}, device "
                  f"{statistics.median(ds):.4f} ms a call{dvs}, host "
                  f"{host[name]:.4f} ms a call, equal to plain: {equal[name]} "
                  f"[{where}]", flush=True)
        if times["library"]:
            xs = times["library"]
            q1, q3 = _quartiles(xs)
            print(f"{label} {e.library_label}: median {statistics.median(xs):.4f}"
                  f" ms [q1 {q1:.4f}, q3 {q3:.4f}] over {pairs} rounds "
                  f"(library call) [{where}]", flush=True)
        print(f"{label}: SM clock, max after the rounds: {clock()}", flush=True)
        out.append((e, times, dev))
    return out


TRACED = ("G3", "G4", "G5")    # kernels ``lone_calls`` follows


def held_ms(fn, calls=25, sleep_cycles=200_000):
    """Median device time of a lone call of ``fn``: the stream is held by
    a ``torch.cuda._sleep`` (~0.1 ms) while the host issues the call
    between two CUDA events, so the events time the kernel alone on an
    otherwise idle card, without the host's path to the launch."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def lone_calls(rows, others, where, tags=TRACED):
    """Where a lone call's ``time_ms`` goes, per kernel and build:
    ``time_ms`` (the start event on an idle card, then the call), the
    kernel alone (``held_ms``), the kernel inside a graph of 25
    (``device_ms``) and the host's time a call (``host_ms``).  ``time_ms``
    less the kernel alone is what the host adds before the kernel starts:
    its path to the launch and the launch's own latency."""
    versions = [("this", this_copy())] + list(others.items())
    for e in rows:
        if e.tag not in tags or e.note:
            continue
        for name, copy in versions:
            run = (lambda m=copy.gather_bench: e.run_in(m))
            lone, alone = time_ms(run, 25), held_ms(run)
            graph, host = device_ms(run), host_ms(run)
            print(f"{e.tag} {e.name} {name}: lone call {lone:.4f} ms = kernel "
                  f"alone {alone:.4f} + {lone - alone:.4f} before it starts "
                  f"(host {host:.4f} a call; kernel in a graph {graph:.4f}) "
                  f"[{where}]", flush=True)


def copy_ceiling(device, where, mib=64):
    """Print the device time of a device-to-device copy of ``mib`` MiB
    (``Tensor.copy_``, a captured graph of 25): G3's bytes at the rate the
    card reaches when it only streams, the practical floor under G3."""
    src = torch.empty(mib << 18, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    ms = device_ms(lambda: dst.copy_(src))
    moved = 2 * src.numel() * 4
    print(f"copy of {mib} MiB (reads and writes {moved} B): device {ms:.4f} "
          f"ms, {moved / ms / 1e9:.3f} TB/s [{where}]", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--variants", nargs="*", metavar="NAME",
                    help="also time these block-shape variants (``VARIANTS``;"
                    " all of them when none is named)")
    ap.add_argument("--only", default="",
                    help="comma-separated tags (G3,G4): time only these rows")
    ap.add_argument("--lone", action="store_true",
                    help="end with ``lone_calls`` of G3, G4 and G5")
    ap.add_argument("others", nargs="*", metavar="NAME=DIR")
    a = ap.parse_args(argv)
    device = resolve_device()
    others = {}
    for spec in a.others:
        name, _, path = spec.partition("=")
        others[name] = load_copy(path)
    if a.variants is not None:
        for n in a.variants or VARIANTS:
            others[n] = variant(n, VARIANTS[n])
    # every build compiles its own sources; the compilers run in subprocesses
    with ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(lambda m: m.build(), [build, *(c.build for c in
                                                   others.values())]))
    where = card(device)
    launch_path(device, others, where)
    copy_ceiling(device, where)
    rows = lookups(device)
    if a.only:
        rows = [e for e in rows if e.tag in a.only.split(",")]
    out = compare(rows, others, a.pairs, where)
    if a.lone:
        lone_calls(rows, others, where)
    return out


if __name__ == "__main__":
    main()
