"""Two-dimensional lookups in one [128, 128] f32 table, 2^24 queries: the
counterpart of the JAX package's ``tools/exp_gather2.py``.

    python -m mcl_3dl_tpu_torch.tools.exp_gather2

  A   torch.take from the 16k-entry table (the script's XLA baseline A; a
      library call, timed as a yardstick)
  G6  tab[idx >> 7, idx & 127], table in shared memory   (k_fancy)
  G7  tab[idx >> 7, l], a column gather                   (k_sublane)
  G8  tab[idx >> 7, i], the transposed form               (k_transpose;
      the script defines it and never times it)
  G9  G6's function, table read through L1/L2             (k_rowloop)

Queries are ``idx [nb, BQ, 128]`` with BQ 512; output block ``b`` is the
gather of ``idx[b]`` (``[nb*BQ, 128]``).  The script's output index map
``lambda b: (b * BQ, 0)`` (exp_gather2.py:61) names element offsets where
Pallas expects block indices; the port computes the intended layout.
"""

from __future__ import annotations

import numpy as np
import torch

from mcl_3dl_tpu_torch.ops import gather_bench as ogb
from mcl_3dl_tpu_torch.tools import (Lookup, entry, kernel_lookup, nbytes,
                                     to_device)

L = ogb.LANES


def lookups(device, q=1 << 24, bq=512):
    nb = q // (bq * L)
    rng = np.random.default_rng(0)
    dev = to_device(device)
    tab = dev(rng.random((L, L), np.float32))
    idx = dev(rng.integers(0, L * L, (nb, bq, L), dtype=np.int32))
    n = nb * bq * L
    size = nbytes(tab, idx) + 4 * n
    flat64 = idx.long()
    rows64 = (idx.reshape(-1, L) >> 7).long()
    nch = rows64.shape[0] // L

    def take():
        return torch.take(tab, flat64)

    def transpose_gather():
        return torch.gather(tab.t().expand(nch, L, L), 2,
                            rows64.view(nch, L, L))

    def kern(tag, line, wrapper, **fields):
        return kernel_lookup(tag, line, wrapper, (tab, idx), lookups=n,
                             nbytes=size, **fields)

    return [
        Lookup("A", "take_16k", "tools/exp_gather2.py:45-47 (XLA jnp.take)",
               take, None, None, n, size),
        kern("G6", "tools/exp_gather2.py:56 (k_fancy :50)", ogb.fancy_gather,
             library=take, library_label="torch.take"),
        kern("G7", "tools/exp_gather2.py:56 (k_sublane :67)",
             ogb.sublane_gather,
             library=lambda: torch.gather(tab, 0, rows64),
             library_label="torch.gather"),
        kern("G8", "tools/exp_gather2.py:56 (k_transpose :75)",
             ogb.transpose_gather, library=transpose_gather,
             library_label="tab.t() + torch.gather (2 calls)"),
        kern("G9", "tools/exp_gather2.py:56 (k_rowloop :92)",
             ogb.rowloop_gather, library=take, library_label="torch.take"),
    ]


def main(device=None, q=1 << 24, bq=512, iters=25):
    return entry(lookups, device, iters, q=q, bq=bq)


if __name__ == "__main__":
    main()
