"""Build and load the hand-written CUDA kernels (``csrc/*.cu``) and their
binding to PyTorch (``csrc/ops.cpp``).

Each kernel source is compiled by ``nvcc`` for ``sm_90a`` into an object,
and the binding by the host C++ compiler against torch's headers, all in
parallel.  The objects are linked into one shared library against torch's
libraries and loaded with ``torch.ops.load_library``: its operators (one
per C entry point of the kernels) are registered with torch's dispatcher
under the namespace ``mcl3dl_<hash>``, so two builds of the package can be
loaded into one process.  The library lives under
``build/torch_kernels/<hash>/`` at the repository root, keyed by a hash of
the sources, the flags and torch's version, and is built at first use.
It needs ``nvcc``, a host C++ compiler and a CUDA build of torch; without
them, or when the library does not load, ``build``/``library`` raise.
Operators that are elementwise over the rays or queries of their leading
arguments (``VMAP_FOLDS``) get a vmap rule at their first lookup
(``op``, ``fold_rule``): under ``torch.func.vmap`` the robots axis is
folded into those rays or queries and the kernel launches once.

``build_map`` builds the host map compiler (``csrc/map_builder.cpp``, a
plain C library loaded with ctypes by ``map/native.py``) with the host
compiler alone, into ``build/torch_kernels/map_<hash>/``, keyed by the
source, the flags and the compiler's version; a failed build raises with
the compiler's output.

``-fmad=false`` keeps every ``a*b + c`` unfused, so the kernels evaluate
the affine query and the score with the same roundings as the plain
PyTorch versions (eager torch never contracts across operations).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("grouped.cu", "local_gather.cu", "beam_march.cu", "tier2.cu",
           "group_stats.cu", "gather_bench.cu")
HEADERS = ("field.cuh",)
BINDING = "ops.cpp"
# operator -> how many leading tensor arguments hold its rays or queries
VMAP_FOLDS = {"sample_field": 1, "march_sphere": 4, "march_dda": 5}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")
# the standard torch's own extension builder compiles its headers with
HOST_FLAGS = ("-std=c++20", "-O2", "-fPIC")
TORCH_LIBS = ("torch", "torch_cpu", "torch_cuda", "c10", "c10_cuda")
MAP_SOURCE = "map_builder.cpp"
# no -march and no contraction: the map builder's roundings are the numpy
# build's on every host (csrc/map_builder.cpp)
MAP_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-pthread", "-ffp-contract=off",
             "-shared")

_lib = None          # the loaded namespace, set by ``library``
_ops = {}            # operator name -> its OpOverload, filled by ``op``
# the last build's wall seconds: "nvcc", "host", "link" (``build``) and
# "map" (``build_map``)
seconds = {}


def _find(tool: str, default: str, what: str) -> str:
    found = shutil.which(tool)
    if found:
        return found
    if os.path.exists(default):
        return default
    raise RuntimeError(f"{tool} not found: {what}")


def _nvcc() -> str:
    return _find("nvcc", "/usr/local/cuda/bin/nvcc",
                 "the CUDA kernels cannot be built")


def _host_cxx() -> str:
    return _find("g++", "/usr/bin/g++", "the kernels' binding cannot be built")


def _abi() -> int:
    return int(torch._C._GLIBCXX_USE_CXX11_ABI)


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + HOST_FLAGS + TORCH_LIBS).encode())
    h.update(f"torch {torch.__version__} abi {_abi()}".encode())
    for name in SOURCES + HEADERS + (BINDING,):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def namespace() -> str:
    """The operators' namespace: ``torch.ops.<namespace()>``."""
    return f"mcl3dl_{_digest()}"


def _torch_paths():
    """``(include dirs, library dirs)`` of torch's CUDA build."""
    from torch.utils import cpp_extension

    return (cpp_extension.include_paths(device_type="cuda"),
            cpp_extension.library_paths(device_type="cuda"))


def commands(work: Path, lib: Path):
    """``(compiles, link)``: one ``(label, argv)`` a source, the kernels
    by nvcc and the binding by the host compiler, and the link's argv."""
    nvcc = _nvcc()
    includes, libdirs = _torch_paths()
    compiles = []
    for name in SOURCES:
        obj = work / (Path(name).stem + ".o")
        compiles.append((f"nvcc {name}", [
            nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / name),
            "-o", str(obj)]))
    compiles.append((f"host {BINDING}", [
        _host_cxx(), *HOST_FLAGS, *(f"-I{d}" for d in includes),
        f"-D_GLIBCXX_USE_CXX11_ABI={_abi()}", f"-DMCL_OPS_NS={namespace()}",
        "-c", str(CSRC / BINDING), "-o", str(work / "ops.o")]))
    objs = [argv[-1] for _, argv in compiles]
    # -Bsymbolic: each build's operators call its own C entry points, even
    # with another build's library (the same names) loaded in the process
    link = [nvcc, "-shared", "-Xcompiler", "-fPIC", "-Xlinker", "-Bsymbolic",
            *objs, "-o", str(lib), *(f"-L{d}" for d in libdirs),
            *(a for d in libdirs for a in ("-Xlinker", f"-rpath,{d}")),
            *(f"-l{name}" for name in TORCH_LIBS)]
    return compiles, link


def _run(cmds, verbose):
    """Run the labelled argvs in parallel; returns each label's wall
    seconds; raises with the output of every one that failed."""
    def one(cmd):
        label, argv = cmd
        t0 = time.perf_counter()
        out = subprocess.run(argv, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        return label, time.perf_counter() - t0, out

    with ThreadPoolExecutor(max_workers=len(cmds)) as ex:
        runs = list(ex.map(one, cmds))
    failed = []
    for label, _, out in runs:
        if verbose or out.returncode:
            print(f"[{label}]\n{out.stdout}", flush=True)
        if out.returncode:
            failed.append(f"{label}:\n{out.stdout}")
    if failed:
        raise RuntimeError("build failed: " + "\n".join(failed))
    return {label: secs for label, secs, _ in runs}


def build(verbose: bool = False) -> Path:
    """Compile the kernels and the binding unless this hash is already
    built; returns the library path.  Sets ``seconds`` (empty when the
    library was there)."""
    for key in ("nvcc", "host", "link"):
        seconds.pop(key, None)
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libmcl3dl_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out_dir))
    tmp_lib = work / lib.name
    compiles, link = commands(work, tmp_lib)
    done = _run(compiles, verbose)
    seconds["nvcc"] = max(s for k, s in done.items() if k.startswith("nvcc"))
    seconds["host"] = done[f"host {BINDING}"]
    seconds["link"] = _run([("link", link)], verbose)["link"]
    os.replace(tmp_lib, lib)
    shutil.rmtree(work, ignore_errors=True)
    return lib


def library():
    """The operators' namespace object, ``torch.ops.mcl3dl_<hash>`` (the
    library built and loaded on first use)."""
    global _lib
    if _lib is None:
        torch.ops.load_library(str(build()))
        _lib = getattr(torch.ops, namespace())
    return _lib


def fold_rule(get_op, n_folded: int):
    """A ``torch.library.register_vmap`` rule for an operator that is
    elementwise over the leading dimension of its first ``n_folded``
    arguments (its rays or queries): each is moved to ``[B, R, ...]`` (an
    unbatched one expanded), folded to ``[B * R, ...]``, the operator
    (``get_op()``) is called once, and every output unfolded to ``[B, R,
    ...]``.  The other arguments (the map) must not be batched."""
    def rule(info, in_dims, *args):
        if any(d is not None for d in in_dims[n_folded:]):
            raise ValueError("vmap: only the rays or queries may be batched")
        b = info.batch_size
        folded = []
        for x, d in zip(args[:n_folded], in_dims[:n_folded]):
            x = x.movedim(d, 0) if d is not None else x.expand(b, *x.shape)
            folded.append(x.flatten(0, 1).contiguous())
        out = get_op()(*folded, *args[n_folded:])
        if isinstance(out, torch.Tensor):
            return out.unflatten(0, (b, -1)), 0
        return tuple(o.unflatten(0, (b, -1)) for o in out), (0,) * len(out)
    return rule


def op(name: str):
    """The ``OpOverload`` of operator ``name`` (kept, so a call pays no
    overload resolution); at its first lookup an operator of
    ``VMAP_FOLDS`` gets its vmap rule."""
    fn = _ops.get(name)
    if fn is None:
        fn = getattr(library(), name).default
        if name in VMAP_FOLDS:
            torch.library.register_vmap(
                f"{namespace()}::{name}", fold_rule(lambda: fn,
                                                    VMAP_FOLDS[name]))
        _ops[name] = fn
    return fn


def _map_digest(cxx: str) -> str:
    """The map library's key: its source, the flags and ``cxx --version``
    (raises with the output when the compiler does not answer)."""
    out = subprocess.run([cxx, "--version"], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if out.returncode:
        raise RuntimeError(f"map builder: {cxx} --version failed "
                           f"(exit {out.returncode}):\n{out.stdout}")
    h = hashlib.sha256(" ".join(MAP_FLAGS).encode())
    h.update(out.stdout.encode())
    h.update((CSRC / MAP_SOURCE).read_bytes())
    return h.hexdigest()[:16]


def build_map(verbose: bool = False) -> Path:
    """Compile ``csrc/map_builder.cpp`` with the host compiler unless this
    hash is already built; returns the library path.  Several processes may
    build at once: each compiles in a directory of its own and moves its
    library into place.  Sets ``seconds["map"]`` (popped when the library
    was there)."""
    seconds.pop("map", None)
    cxx = _host_cxx()
    out_dir = BUILD_ROOT / f"map_{_map_digest(cxx)}"
    lib = out_dir / "libmcl3dl_map.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out_dir))
    tmp_lib = work / lib.name
    argv = [cxx, *MAP_FLAGS, str(CSRC / MAP_SOURCE), "-o", str(tmp_lib)]
    seconds["map"] = _run([(f"host {MAP_SOURCE}", argv)], verbose)[
        f"host {MAP_SOURCE}"]
    os.replace(tmp_lib, lib)
    shutil.rmtree(work, ignore_errors=True)
    return lib
