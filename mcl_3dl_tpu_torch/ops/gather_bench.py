"""Lookup microbenchmark kernels (``csrc/gather_bench.cu``) and their
plain PyTorch versions.

One wrapper per Pallas kernel body of the JAX package's gather
experiments; each takes the arguments of the JAX function that calls
``pallas_call`` and computes the same function:

=====  ======================  =====================================  ==========
kernel wrapper                 replaces                               plain
=====  ======================  =====================================  ==========
G1     ``lane_gather``         tools/exp_gather.py::lane_kernel       ``row_gather_plain``
G2     ``wide_gather``         tools/exp_gather.py::wide_kernel       ``row_gather_plain``
G3     ``twostage_gather``     tools/exp_gather.py::twostage_kernel   ``flat_gather_plain``
G4     ``lane_gather_u8``      tools/exp_gather.py::lane_kernel_u8    ``row_gather_plain``
G5     ``sub_gather``          tools/exp_gather.py::sub_kernel        ``sub_gather_plain``
G6     ``fancy_gather``        tools/exp_gather2.py::k_fancy          ``flat_gather_plain``
G7     ``sublane_gather``      tools/exp_gather2.py::k_sublane        ``sublane_gather_plain``
G8     ``transpose_gather``    tools/exp_gather2.py::k_transpose      ``transpose_gather_plain``
G9     ``rowloop_gather``      tools/exp_gather2.py::k_rowloop        ``flat_gather_plain``
G10    ``rowsel_accumulate``   tools/exp_rowsel_shape.py::kern        ``rowsel_plain``
=====  ======================  =====================================  ==========

A CUDA tensor launches the kernel through its operator (``csrc/ops.cpp``,
which checks the tensors as the kernel needs them) or raises; a CPU
tensor takes the plain version.  Each wrapper counts its launches in ``.launches`` and
names its plain version in ``.plain``.  The plain versions compute the
index arithmetic in int32 (it wraps like the JAX int32 arithmetic) and
cast to int64 only to index; the kernels take int32.  Where the JAX body
indexes without a modulo (G6-G9), both versions reduce the index modulo
the table's power-of-two extent: for indices inside the table (the
domain the scripts draw from) that changes nothing.
"""

from __future__ import annotations

import torch

from mcl_3dl_tpu_torch.ops import build

LANES = 128


# ---- plain versions

def row_gather_plain(tab, idx, off=0):
    """``out[r, l] = tab[r, (idx[r, l] + off) mod W]`` (G1, G2, G4)."""
    return torch.gather(tab, 1, torch.remainder(idx + off, tab.shape[1]).long())


def flat_gather_plain(tab, idx, off=0):
    """``out = tab.flat[(idx + off) mod tab.numel()]`` as ``[-1, 128]``
    rows (G3, G6, G9)."""
    flat = tab.reshape(-1)
    i = torch.remainder(idx + off, flat.numel()).long()
    return flat[i].reshape(-1, LANES)


def sub_gather_plain(tab, idx, off=0):
    """``out[i, j] = tab[(idx[i, j] + off) mod R, j]`` (G5)."""
    return torch.gather(tab, 0, torch.remainder(idx + off, tab.shape[0]).long())


def sublane_gather_plain(tab, idx):
    """``out[b*BQ + q, l] = tab[idx[b, q, l] >> 7, l]`` (G7)."""
    rows = torch.remainder(idx.reshape(-1, LANES) >> 7, tab.shape[0])
    return torch.gather(tab, 0, rows.long())


def transpose_gather_plain(tab, idx):
    """``out[b*BQ + c*128 + i, j] = tab[idx[b, c*128 + i, j] >> 7, i]``
    (G8): the row of the output, modulo 128, picks the table's column."""
    rows = torch.remainder(idx.reshape(-1, LANES) >> 7, tab.shape[0]).long()
    cols = torch.arange(rows.shape[0], device=tab.device) % LANES
    return tab[rows, cols[:, None]]


def rowsel_plain(tab, rows, lanes, passes=16):
    """``out[t] = sum over passes of tab[rows[t], lanes[t]]``, added in
    order from 0.0 (G10); a row outside the table reads 0.0."""
    nr = tab.shape[0]
    hit = (rows >= 0) & (rows < nr)
    d = tab[rows.clamp(0, nr - 1).long(), (lanes & (LANES - 1)).long()]
    d = torch.where(hit, d, torch.zeros_like(d))
    acc = torch.zeros_like(d)
    for _ in range(passes):
        acc = acc + d
    return acc


# ---- launchers shared by the wrappers: one operator each (csrc/ops.cpp,
# which checks the tensors and allocates the output)

def _row_gather(wrapper, tab, idx, off, width, dtype):
    if not tab.is_cuda:
        return row_gather_plain(tab, idx, off)
    out = build.op("row_gather")(tab, idx, off, width, dtype)
    wrapper.launches += 1
    return out


def _flat_gather(wrapper, tab, idx, off, shared):
    if not tab.is_cuda:
        return flat_gather_plain(tab, idx, off)
    out = build.op("flat_gather")(tab, idx, off, shared)
    wrapper.launches += 1
    return out


_COL_MODES = {"mod": 0, "shift": 1, "shift_transposed": 2}


def _col_gather(wrapper, tab, idx, off, mode):
    out = build.op("col_gather")(tab, idx, off, _COL_MODES[mode])
    wrapper.launches += 1
    return out


# ---- one wrapper per TPU kernel body

def lane_gather(tab, idx, off=0):
    """G1: ``tab`` [R, 128] f32, ``idx`` [R, 128] i32 -> [R, 128] f32."""
    return _row_gather(lane_gather, tab, idx, off, LANES, torch.float32)


def wide_gather(tab, idx, off=0):
    """G2: ``tab`` [R, 512] f32, ``idx`` [R, 128] i32 -> [R, 128] f32."""
    return _row_gather(wide_gather, tab, idx, off, 512, torch.float32)


def lane_gather_u8(tab, idx, off=0):
    """G4: ``tab`` [R, 128] u8, ``idx`` [R, 128] i32 -> [R, 128] u8."""
    return _row_gather(lane_gather_u8, tab, idx, off, LANES, torch.uint8)


def twostage_gather(tab, idx, off=0):
    """G3: ``tab`` [8, 128] f32 (one 1024-entry table in shared memory),
    ``idx`` [R, 128] i32 -> [R, 128] f32."""
    return _flat_gather(twostage_gather, tab, idx, off, shared=1)


def fancy_gather(tab, idx):
    """G6: ``tab`` [128, 128] f32 in shared memory, ``idx`` [nb, BQ, 128]
    i32 -> [nb*BQ, 128] f32."""
    return _flat_gather(fancy_gather, tab, idx, 0, shared=1)


def rowloop_gather(tab, idx):
    """G9: G6's function, with the table read through L1/L2."""
    return _flat_gather(rowloop_gather, tab, idx, 0, shared=0)


def sub_gather(tab, idx, off=0):
    """G5: ``tab`` [R, 128] f32, ``idx`` [N, 128] i32 -> [N, 128] f32."""
    if not tab.is_cuda:
        return sub_gather_plain(tab, idx, off)
    return _col_gather(sub_gather, tab, idx, off, "mod")


def sublane_gather(tab, idx):
    """G7: ``tab`` [128, 128] f32, ``idx`` [nb, BQ, 128] i32 ->
    [nb*BQ, 128] f32."""
    if not tab.is_cuda:
        return sublane_gather_plain(tab, idx)
    return _col_gather(sublane_gather, tab, idx, 0, "shift")


def transpose_gather(tab, idx):
    """G8: ``tab`` [128, 128] f32, ``idx`` [nb, BQ, 128] i32 with
    BQ % 128 == 0 -> [nb*BQ, 128] f32."""
    if idx.dim() != 3 or idx.shape[1] % LANES:
        raise ValueError(f"idx must be [nb, BQ, {LANES}] with BQ % {LANES} == 0,"
                         f" got {tuple(idx.shape)}")
    if not tab.is_cuda:
        return transpose_gather_plain(tab, idx)
    return _col_gather(transpose_gather, tab, idx, 0, "shift_transposed")


def rowsel_accumulate(tab, rows, lanes, passes=16, tile_rows=8):
    """G10: ``tab`` [R, 128] f32 in shared memory; ``rows``, ``lanes``
    i32 of one shape -> f32 of that shape.  The queries go in tiles of
    ``tile_rows * 128`` (the script's tile height S), dealt out in turn to
    one block on each SM.  ``rows`` and ``lanes`` need no alignment: the
    kernel reads them four at a time where they are 16-byte aligned."""
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    if not tab.is_cuda:
        return rowsel_plain(tab, rows, lanes, passes)
    out = build.op("rowsel_accumulate")(tab, rows, lanes, passes, tile_rows)
    rowsel_accumulate.launches += 1
    return out


PLAIN = {lane_gather: row_gather_plain, wide_gather: row_gather_plain,
         twostage_gather: flat_gather_plain, lane_gather_u8: row_gather_plain,
         sub_gather: sub_gather_plain, fancy_gather: flat_gather_plain,
         sublane_gather: sublane_gather_plain,
         transpose_gather: transpose_gather_plain,
         rowloop_gather: flat_gather_plain, rowsel_accumulate: rowsel_plain}
for _w, _p in PLAIN.items():
    _w.launches = 0
    _w.plain = _p
WRAPPERS = tuple(PLAIN)     # G1..G10 in order
