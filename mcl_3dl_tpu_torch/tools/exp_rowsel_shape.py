"""Row-select lookups with a growing number of queries per tile: the
counterpart of the JAX package's ``tools/exp_rowsel_shape.py``.

    python -m mcl_3dl_tpu_torch.tools.exp_rowsel_shape

G10 (``kern``): a 144 x 128 f32 table (the grouped kernels' row count),
2^20 queries, 16 passes each, every pass one lookup ``tab[row, lane]``
added in order from 0.0.  The script's tile height S becomes a tile of
S*128 queries, S in {8, 16, 32, 64}; the tiles are dealt out to one
block on each SM, which copies the 72 KB table into shared memory once.  The library row is one
``torch.take`` pass (per pass, not 16).  On the card each row also
carries the bound of the lookups themselves (``lookup_bound``), which is
larger than the byte bound.
"""

from __future__ import annotations

import numpy as np
import torch

from mcl_3dl_tpu_torch.ops import gather_bench as ogb
from mcl_3dl_tpu_torch.tools import (entry, kernel_lookup, nbytes, sm_rate,
                                     to_device)

L = ogb.LANES
R = 144
PASSES = 16
TILES = (8, 16, 32, 64)
BANKS = 32                 # shared-memory banks of 4 bytes


def lookups(device, nq=1 << 20, tiles=TILES, passes=PASSES):
    rng = np.random.default_rng(0)
    dev = to_device(device)
    tab = dev(rng.uniform(0, 1, (R, L)).astype(np.float32))
    rows = dev(rng.integers(0, R, nq).astype(np.int32).reshape(-1, L))
    lanes = dev(rng.integers(0, L, nq).astype(np.int32).reshape(-1, L))
    flat64 = (rows * L + lanes).long()
    lb = None
    if torch.device(device).type == "cuda":
        lb = lookup_bound(nq, passes, *sm_rate())[0]
    return [kernel_lookup(
        "G10", "tools/exp_rowsel_shape.py:64 (kern :44)", ogb.rowsel_accumulate,
        (tab, rows, lanes, passes), dict(tile_rows=s), lookups=nq * passes,
        nbytes=nbytes(tab, rows, lanes) + 4 * nq, flops=nq * passes,
        library=lambda: torch.take(tab, flat64),
        library_label="torch.take, one pass", lookup_bound_ms=lb,
        note=f"S={s}: {s * L} queries per tile") for s in tiles]


def lookup_bound(nq, passes, sms, clock_hz, warps=50_000, seed=0):
    """The least time of G10's shared-memory lookups, ``(ms, words)``.  A
    warp's read of 32 random table entries takes as many cycles as the
    most distinct words on one bank; ``words`` is that count's mean over
    ``warps`` random warps (numpy), and each of ``sms`` SMs serves one
    such cycle a clock, at ``clock_hz``."""
    rng = np.random.default_rng(seed)
    addr = np.sort(rng.integers(0, R * L, (warps, 32)), axis=1)
    distinct = np.ones(addr.shape, bool)
    distinct[:, 1:] = addr[:, 1:] != addr[:, :-1]
    per_bank = np.zeros((warps, BANKS), np.int64)
    np.add.at(per_bank, (np.arange(warps)[:, None], addr % BANKS), distinct)
    words = float(per_bank.max(axis=1).mean())
    return nq * passes / 32 * words / (sms * clock_hz) * 1e3, words


def main(device=None, nq=1 << 20, tiles=TILES, iters=25):
    return entry(lookups, device, iters, nq=nq, tiles=tiles)


if __name__ == "__main__":
    main()
