"""Row-select lookups with a growing number of queries per block: the
counterpart of the JAX package's ``tools/exp_rowsel_shape.py``.

    python -m mcl_3dl_tpu_torch.tools.exp_rowsel_shape

G10 (``kern``): a 144 x 128 f32 table (the grouped kernels' row count),
2^20 queries, 16 passes each, every pass one lookup ``tab[row, lane]``
added in order from 0.0.  The script's tile height S becomes S*128
queries per block, S in {8, 16, 32, 64}; each block copies the 72 KB
table into shared memory, so the sweep shows what that copy costs on the
card.  The library row is one ``torch.take`` pass (per pass, not 16).
"""

from __future__ import annotations

import numpy as np
import torch

from mcl_3dl_tpu_torch.ops import gather_bench as ogb
from mcl_3dl_tpu_torch.tools import entry, kernel_lookup, nbytes, to_device

L = ogb.LANES
R = 144
PASSES = 16
TILES = (8, 16, 32, 64)


def lookups(device, nq=1 << 20, tiles=TILES):
    rng = np.random.default_rng(0)
    dev = to_device(device)
    tab = dev(rng.uniform(0, 1, (R, L)).astype(np.float32))
    rows = dev(rng.integers(0, R, nq).astype(np.int32).reshape(-1, L))
    lanes = dev(rng.integers(0, L, nq).astype(np.int32).reshape(-1, L))
    flat64 = (rows * L + lanes).long()
    return [kernel_lookup(
        "G10", "tools/exp_rowsel_shape.py:64 (kern :44)", ogb.rowsel_accumulate,
        (tab, rows, lanes, PASSES), dict(tile_rows=s), lookups=nq * PASSES,
        nbytes=nbytes(tab, rows, lanes) + 4 * nq, flops=nq * PASSES,
        library=lambda: torch.take(tab, flat64),
        library_label="torch.take, one pass",
        note=f"S={s}: {s * L} queries per block") for s in tiles]


def main(device=None, nq=1 << 20, tiles=TILES, iters=25):
    return entry(lookups, device, iters, nq=nq, tiles=tiles)


if __name__ == "__main__":
    main()
