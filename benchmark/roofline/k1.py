"""Kernel K1 (``csrc/grouped.cu``, ``like_score_kernel``): the grouped
likelihood score over the pose-grouped layout.

Counted at the launch's shapes, each input byte the kernel must read
read once and each output byte written once: a tile's 12 pose-affine
rows (f32) and its bin, each point's fixed-point coordinates, window
meta and skip words (i32), the live (point, bin) tables of 144 rows x
128 z lanes (u8), and the score and match count (f32) of every tile
slot; 25 f32 operations a (particle, point) lookup.

A table is live when its bin holds tiles and its skip word does not
skip every block; the kernel skips the rest.  Which are live depends on
the particles, and no counter of the program reports it, so the count
holds the live tables at ``LIVE_SHARE`` of those a launch is given: the
7,225 of 96 x 97 of the 1M-particle state that PERF.md's kernel table
bounds at 0.0590 ms.  The tracking cell's state had 7,825 to 8,663 live
(PERF.md), so the count never takes more bytes than the kernel reads
there.
"""

KERNEL = "like_score_kernel"
TILE = 1024
ROWS, LANES = 144, 128
LIVE_SHARE = 7225 / (96 * 97)


def tiles(particles: int, bins: int) -> int:
    """Tiles of the layout: the particles plus one tile of slack a bin."""
    return (particles + bins * TILE) // TILE


def count(particles: int, points: int, bins: int, tables: int):
    """``(bytes, flops)`` of one launch that reads ``tables`` (point, bin)
    tables."""
    nt = tiles(particles, bins)
    nbytes = (nt * 12 * TILE * 4 + nt * 4          # pose rows, tile bins
              + points * 4 * 4                    # fixed-point points
              + points * bins * 4 * 4             # meta (origin, z used)
              + points * bins * 4                 # skip words
              + tables * ROWS * LANES             # u8 tables
              + 2 * nt * TILE * 4)                # score, match count
    return nbytes, particles * points * 25


def launch(shapes: dict):
    points, bins = shapes["like_points"], shapes["bins"]
    return count(shapes["particles"], points, bins,
                 round(LIVE_SHARE * points * bins))
