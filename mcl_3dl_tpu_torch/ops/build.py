"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object, all
in parallel, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``.  The library lives under
``build/torch_kernels/<hash>/`` at the repository root, keyed by a hash of
the sources and flags, and is built at first use.

``-fmad=false`` keeps every ``a*b + c`` unfused, so the kernels evaluate
the affine query and the score with the same roundings as the plain
PyTorch versions (eager torch never contracts across operations).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("grouped.cu", "local_gather.cu", "gather_bench.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: argument types after the leading pointers, per kernel
_SIGNATURES = {
    "mcl_like_score": [_P] * 8 + [_I] * 4 + [_F] * 6 + [_P],
    "mcl_beam_pen": [_P] * 8 + [_I] * 6 + [_F] * 9 + [_P],
    "mcl_local_score": [_P] * 4 + [_I] * 3 + [_F] * 3 + [_P],
    "mcl_row_gather": [_P] * 3 + [_I] * 4 + [_P],
    "mcl_flat_gather": [_P] * 3 + [_I] * 4 + [_P],
    "mcl_col_gather": [_P] * 3 + [_I] * 4 + [_P],
    "mcl_rowsel_accumulate": [_P] * 4 + [_I] * 4 + [_P],
}

_lib = None
_fns = {}       # entry name -> bound ctypes function, filled by ``library``


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless this source hash is already built;
    returns the library path."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libmcl3dl_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=out_dir))
    procs = []
    for name in SOURCES:
        obj = work / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / name),
               "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, failed = [], []
    for name, obj, proc in procs:
        out, _ = proc.communicate()
        if verbose or proc.returncode:
            print(f"[nvcc {name}]\n{out}", flush=True)
        if proc.returncode:
            failed.append(name)
        objs.append(str(obj))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}")
    tmp_lib = work / lib.name
    link = subprocess.run(
        [nvcc, "-shared", "-Xcompiler", "-fPIC", *objs, "-o", str(tmp_lib)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp_lib, lib)
    shutil.rmtree(work, ignore_errors=True)
    return lib


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[name] = fn
        _lib = lib
    return _lib


def current_stream() -> int:
    """The raw handle of the current device's current CUDA stream (what
    ``torch.cuda.current_stream().cuda_stream`` gives, without building a
    ``Stream`` object): inside ``torch.cuda.stream(s)`` it is ``s``'s."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def launch(name: str, *args) -> None:
    """Call one C entry point on the current CUDA stream; raise on a
    launch error (the entry returns ``cudaGetLastError()``)."""
    fn = _fns.get(name)
    if fn is None:
        library()
        fn = _fns[name]
    err = fn(*args, current_stream())
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check(t, name: str, dtype, shape=None, device=None):
    """Validate a kernel argument before its pointer is handed over."""
    if not (t.is_cuda and t.dtype == dtype and t.is_contiguous()
            and (device is None or t.device == device)
            and (shape is None or t.shape == tuple(shape))):
        _refuse(t, name, dtype, shape, device)
    return t.data_ptr()


def _refuse(t, name, dtype, shape, device):
    """Raise the first of ``check``'s conditions that ``t`` fails."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
