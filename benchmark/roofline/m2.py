"""Kernel M2 (``csrc/tier2.cu``, ``march_sphere_kernel``): the tier-2
sphere-traced raycast, one thread a ray.

Counted at the launch's shapes, each input byte read once and each
output byte written once: a ray's begin and direction (6 f32), its range
and weighted step norm (2 f32) in; its hit flag (1 byte), collision
point (3 f32), hit distance, entry range and entry distance (3 f32) out,
57 bytes a ray; the u8 field once; 24 f32 operations a probe, one probe
a ray at the least.
"""

KERNEL = "march_sphere_kernel"
BYTES_PER_RAY = 57


def count(rays: int, field_cells: int):
    return rays * BYTES_PER_RAY + field_cells + 12, rays * 24


def launch(shapes: dict):
    return count(shapes["particles"] * shapes["beam_points"],
                 shapes["field_cells"])
