"""The lookup kernels G1-G10 of this package against other builds of
them, timed in turns on the card at the JAX scripts' sizes.

    python -m mcl_3dl_tpu_torch.tools.gather_pairs [--pairs 5] [--variants]
        [NAME=DIR ...]

Each ``DIR`` is another copy of the ``mcl_3dl_tpu_torch`` package (an
older commit's, or one with an edited ``csrc/gather_bench.cu``).  Its
kernels are built from its own sources by its own ``ops/build.py`` and
launched through this package's wrappers (``ops/gather_bench.py``) with
that build's ``check`` and ``launch``, so each build's whole launch path
is timed, not only its kernels.  ``--variants`` adds the copies of
``VARIANTS``, this package with other block shapes for G6 and G10 (the
only kernels whose shapes are macros): ``#define`` lines in front of the
copy's ``csrc/gather_bench.cu``, under the git-ignored
``build/variants/``.

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
after each kernel, the SM clock ``nvidia-smi`` reads.  First it prints the host time of G5's launch
path, piece by piece (``launch_path``).  Every line carries the card's
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
from mcl_3dl_tpu_torch.tools.grouped_pairs import (_quartiles, launching,
                                                   load_build, round_order)

L = ogb.LANES
SUB_SWEEP = (1 << 17, 1 << 20, 1 << 23)    # G5 query counts beyond the script's
PASS_SWEEP = (0, 4)                        # G10 passes besides the script's 16
# block shapes of G6 and G10 besides this package's one 768-thread
# block an SM: threads a block and the most blocks an SM holds, as the
# macros at the top of csrc/gather_bench.cu name them
VARIANTS = {f"{per_sm}x{threads}": dict(
    MCL_FLAT_THREADS=threads, MCL_FLAT_PER_SM=per_sm,
    MCL_ROWSEL_THREADS=threads, MCL_ROWSEL_PER_SM=per_sm)
    for per_sm, threads in ((1, 1024), (2, 512), (3, 256))}


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
    return load_build(dst)


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
    the script's inputs: the whole wrapper, its output's allocation, its
    two argument checks, the C entry through each build's ``launch`` (the
    kernel launch included), the raw stream handle alone, and
    ``torch.gather`` beside them."""
    rng = np.random.default_rng(5)
    dev = to_device(device)
    tab = dev(rng.standard_normal((L, L)).astype(np.float32))
    idx = dev(rng.integers(0, L, (L, L), dtype=np.int32))
    out = torch.empty_like(tab)
    i64 = torch.remainder(idx + 1, L).long()
    args = (tab.data_ptr(), idx.data_ptr(), out.data_ptr(), L, L * L, 1, 0)
    pieces = {
        "sub_gather": lambda: ogb.sub_gather(tab, idx, 1),
        "torch.empty": lambda: torch.empty((L, L), dtype=torch.float32,
                                           device=device),
        "build.check x2": lambda: (
            build.check(tab, "tab", torch.float32, None, tab.device),
            build.check(idx, "idx", torch.int32, None, tab.device)),
        "build.launch": lambda: build.launch("mcl_col_gather", *args),
        **{f"{name} launch": (lambda lib=lib: lib.launch("mcl_col_gather", *args))
           for name, lib in others.items()},
        "build.current_stream": build.current_stream,
        "torch.gather": lambda: torch.gather(tab, 0, i64),
    }
    print("G5 launch path, host ms a call: " + "; ".join(
        f"{k} {host_ms(f):.4f}" for k, f in pieces.items()) + f" [{where}]",
        flush=True)


def compare(rows, others, pairs, where, clock=sm_clock):
    """Time each experiment of each build in ``pairs`` rounds; print and
    return ``[(experiment, {build: [ms, ...]}, {build: [device ms, ...]})]``
    (the library call's times under ``"library"``)."""
    versions = [("this", None)] + list(others.items())
    out = []
    for e in rows:
        label = f"{e.tag} {e.name}" + (f" ({e.note})" if e.note else "")
        want = e.plain()
        equal, host = {}, {}
        for name, lib in versions:
            with launching(lib, ogb):
                equal[name] = torch.equal(e.run(), want)
                host[name] = host_ms(e.run)
        times = {name: [] for name, _ in versions + [("library", None)]}
        dev = {name: [] for name, _ in versions}
        for r in range(pairs):
            for name, lib in round_order(versions, r):
                with launching(lib, ogb):
                    times[name].append(time_ms(e.run, 25))
                    dev[name].append(device_ms(e.run))
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--variants", action="store_true",
                    help="also time the block-shape variants of G6 and G10")
    ap.add_argument("others", nargs="*", metavar="NAME=DIR")
    a = ap.parse_args(argv)
    device = resolve_device()
    others = {}
    for spec in a.others:
        name, _, path = spec.partition("=")
        others[name] = load_build(path)
    if a.variants:
        others.update((n, variant(n, d)) for n, d in VARIANTS.items())
    # every build compiles its own sources; nvcc runs in subprocesses
    with ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(lambda m: m.build(), [build, *others.values()]))
    where = card(device)
    launch_path(device, others, where)
    return compare(lookups(device), others, a.pairs, where)


if __name__ == "__main__":
    main()
