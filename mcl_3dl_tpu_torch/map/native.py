"""The port's native map compiler: ctypes binding of
``csrc/map_builder.cpp`` (the counterpart of the JAX package's
``map/native.py``, with its names).

The library is built by the host compiler at first use
(``ops/build.py::build_map``, under ``build/torch_kernels/map_<hash>/``)
and gives the same bytes as the port's numpy builds by construction, so
``distance_field.build_field_codes`` and
``occupancy.build_occupancy_arrays`` take it by default and keep the
numpy code as the plain version (``native=False``).  A failed build or
load raises; nothing falls back to numpy.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from mcl_3dl_tpu_torch.ops import build

_F64 = ctypes.POINTER(ctypes.c_double)
_U32 = ctypes.POINTER(ctypes.c_uint32)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_I64 = ctypes.c_int64
_SIGNATURES = {
    "mcl3dl_build_distance_field": [
        _F64, _I64, ctypes.c_double, ctypes.c_double, _F64, _I64, _I64, _I64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int],
    "mcl3dl_build_occupancy_rep": [
        _F64, _U32, _I64, ctypes.c_double, _F64, _I64, _I64, _I64,
        ctypes.c_int32, _U8, _U32, _U8],
}
_funcs: Optional[dict] = None     # entry point name -> bound function


def _load() -> dict:
    """Build (first use) and bind the library's entry points."""
    global _funcs
    if _funcs is None:
        lib = ctypes.CDLL(str(build.build_map()))
        funcs = {}
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            funcs[name] = fn
        _funcs = funcs
    return _funcs


def native_available() -> bool:
    """True once the library is built and bound (raises when it cannot
    be)."""
    return len(_load()) == len(_SIGNATURES)


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _call(name, *args):
    rc = _load()[name](*args)
    if rc != 0:
        raise RuntimeError(f"{name} returned {rc}")


def build_distance_field_native(points_scaled, cell: float, trunc: float,
                                origin, dims, n_threads: int = 0
                                ) -> np.ndarray:
    """Truncated distance splat: the float32 field ``[nx, ny, nz]`` of the
    least distance to any of ``points_scaled`` ``[n, 3]`` (weighted space)
    from each cell centre ``origin + idx * cell``, ``trunc`` where none is
    closer.  ``n_threads`` 0: one thread a hardware thread (the bytes do
    not depend on it)."""
    nx, ny, nz = (int(d) for d in dims)
    pts = np.ascontiguousarray(points_scaled, np.float64).reshape(-1, 3)
    org = np.ascontiguousarray(origin, np.float64).reshape(3)
    field = np.full(nx * ny * nz, np.float32(trunc), np.float32)
    _call("mcl3dl_build_distance_field", _ptr(pts, _F64), pts.shape[0],
          float(cell), float(trunc), _ptr(org, _F64), nx, ny, nz,
          _ptr(field, ctypes.POINTER(ctypes.c_float)), int(n_threads))
    return field.reshape(nx, ny, nz)


def build_occupancy_rep_native(points, labels, cell: float, origin, dims,
                               rep_points: int):
    """Occupancy, least label and representative points of each voxel:
    flat ``(occupied bool [V], min_label uint32 [V], rep_offsets uint8
    [V, rep_points, 3])``, ``V = nx * ny * nz``; ``labels`` None reads as
    all 0."""
    nx, ny, nz = (int(d) for d in dims)
    total = nx * ny * nz
    pts = np.ascontiguousarray(points, np.float64).reshape(-1, 3)
    lbl = (None if labels is None
           else np.ascontiguousarray(labels, np.uint32).reshape(-1))
    if lbl is not None and lbl.shape[0] != pts.shape[0]:
        raise ValueError(f"{lbl.shape[0]} labels for {pts.shape[0]} points")
    org = np.ascontiguousarray(origin, np.float64).reshape(3)
    occupied = np.zeros(total, np.uint8)
    min_label = np.full(total, 0xFFFFFFFF, np.uint32)
    rep = np.full(total * rep_points * 3, 127, np.uint8)
    _call("mcl3dl_build_occupancy_rep", _ptr(pts, _F64),
          None if lbl is None else _ptr(lbl, _U32), pts.shape[0],
          float(cell), _ptr(org, _F64), nx, ny, nz, int(rep_points),
          _ptr(occupied, _U8), _ptr(min_label, _U32), _ptr(rep, _U8))
    return (occupied.astype(bool), min_label,
            rep.reshape(total, rep_points, 3))
