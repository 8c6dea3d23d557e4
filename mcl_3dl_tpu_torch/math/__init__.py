"""Math helpers: quaternions (torch and numpy), filters, Gaussians."""

import numpy as np


def f32(x) -> float:
    """``x`` rounded once to float32, as a Python float.

    JAX casts a Python double constant to f32 once when it meets an f32
    array; a torch scalar operand must carry the same value."""
    return float(np.float32(x))
