"""Math helpers: quaternions (torch and numpy), filters, Gaussians, a
run-to-run reproducible scan, and kept device constants."""

import numpy as np
import torch

SCAN_ROW = 1024

_CONSTANTS = {}


def f32(x) -> float:
    """``x`` rounded once to float32, as a Python float.

    JAX casts a Python double constant to f32 once when it meets an f32
    array; a torch scalar operand must carry the same value."""
    return float(np.float32(x))


def cumsum(x):
    """Inclusive sum scan of a 1-D tensor, the same bits on every run.

    On the CPU this is ``torch.cumsum`` (one pass in index order).  On
    CUDA, ``torch.cumsum`` of a whole 1-D tensor is one device-wide
    decoupled look-back scan, whose float partial sums depend on which
    blocks finish first, so two runs of the filter drifted apart from
    the first resample; there it is ``row_scan``."""
    if not x.is_cuda:
        return torch.cumsum(x, dim=0)
    return row_scan(x)


def row_scan(x, row: int = SCAN_ROW):
    """Inclusive sum scan of a 1-D tensor in a fixed order on any device:
    scanned as rows of ``row`` (``torch.cumsum`` along the rows of a
    matrix of two rows or more, which never takes the device-wide scan),
    then the row totals likewise, and each row adds the total of the
    rows before it."""
    n = x.shape[0]
    r = max(-(-n // row), 2)
    rows = torch.nn.functional.pad(x, (0, r * row - n)).reshape(r, row)
    part = torch.cumsum(rows, dim=1)
    if n <= row:
        return part[0, :n]
    before = row_scan(part[:, -1], row)
    before = torch.cat([before.new_zeros(1), before[:-1]])
    return (part + before[:, None]).reshape(-1)[:n]


def device_constant(values, dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once and
    kept (callers never write to it).  A step captured into a CUDA graph
    may not copy from the host, so the constants it reads are made by the
    eager step that warms it up, and a capture finds them here."""
    key = (tuple(values) if isinstance(values, (tuple, list)) else values,
           dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t
