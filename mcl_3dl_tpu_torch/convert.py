"""Carry the JAX package's state into the port.

Every function takes numpy arrays and plain Python values (what
``np.asarray`` of the JAX package's arrays gives) and returns the port's
counterpart on ``device``; nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from mcl_3dl_tpu_torch.config import Params
from mcl_3dl_tpu_torch.map import occupancy as mocc
from mcl_3dl_tpu_torch.map.distance_field import DistanceField, from_codes
from mcl_3dl_tpu_torch.math.filters import FilterState
from mcl_3dl_tpu_torch.state import ParticleState


def distance_field(field, origin, cell, trunc, weights, field2d=None,
                   device=None, packed=None) -> DistanceField:
    """A ``DistanceField`` around the u8 ``field`` [nx, ny, nz]; a given
    ``field2d`` must equal the z-major view the port derives from it, and
    a given ``packed`` (the uint32 corner pack) the pack it derives."""
    df = from_codes(field, origin, cell, trunc, weights, device,
                    pack=packed is not None)
    if field2d is not None and not np.array_equal(
            np.asarray(field2d), df.field2d.cpu().numpy()):
        raise ValueError("field2d does not match the z-major view of field")
    if packed is not None and (df.packed is None or not np.array_equal(
            np.asarray(packed, np.uint32),
            df.packed.cpu().numpy().view(np.uint32))):
        raise ValueError("packed does not match the corner pack of field")
    return df


def occupancy_grid(occupied, min_label, rep_point, origin, cell,
                   device=None) -> mocc.OccupancyGrid:
    """An ``OccupancyGrid`` around the JAX package's arrays."""
    return mocc.from_arrays(occupied, min_label, rep_point, origin, cell,
                            device)


def particle_state(pos, rot, odom_err_lin, odom_err_ang, noise, prob,
                   prob_bias, n_active, device=None) -> ParticleState:
    """One robot's state, or a fleet's with a leading robots axis (the JAX
    fleet's batched state: every column ``[R, P, ...]``, ``n_active``
    ``[R]``)."""
    def f(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    return ParticleState(
        pos=f(pos), rot=f(rot), odom_err_lin=f(odom_err_lin),
        odom_err_ang=f(odom_err_ang), noise=f(noise), prob=f(prob),
        prob_bias=f(prob_bias),
        n_active=torch.as_tensor(np.array(n_active, np.int32), device=device))


def filter_state(k, x, out, angle, device=None) -> FilterState:
    def f(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    return FilterState(k=f(k), x=f(x), out=f(out),
                       angle=torch.as_tensor(np.array(angle, bool),
                                             device=device))


def params(d: dict) -> Params:
    """``Params`` from a (nested) dict, e.g. ``dataclasses.asdict`` of the
    JAX package's ``Params``."""
    return Params.from_dict(d)
