"""Discrete first-order LPF/HPF (reference: include/mcl_3dl/filter.h).

A bilinear-transform first-order filter with an optional angle mode that
wraps the input to within pi of the current output (filter.h:85-88).
``FilterState`` is scalar or vector; coefficients follow filter.h:54-75:

LPF:  k3 = -1/(1+2T), k2 = -k3, k1 = (1-2T)k3, k0 = -k1 - 1
HPF:  k3 = -1/(1+2T), k2 = -2T k3, k1 = (1-2T)k3, k0 = 2T(-k1 + 1)
x0 for output out0:  x = (1 - k2) * out0 / k3
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class FilterState(NamedTuple):
    k: torch.Tensor        # [..., 4] coefficients
    x: torch.Tensor        # internal state
    out: torch.Tensor      # last output
    angle: torch.Tensor    # bool mask, same shape as x


def _f32(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _init(k0, k1, k2, k3, out0, angle, device):
    out0 = _f32(out0, device)
    k = torch.stack([k0, k1, k2, k3], dim=-1).expand(out0.shape + (4,))
    x = (1.0 - k[..., 2]) * out0 / k[..., 3]
    return FilterState(
        k=k.contiguous(), x=x, out=out0,
        angle=torch.as_tensor(angle, device=device).expand(out0.shape).clone())


def lpf_init(time_const, out0=0.0, angle=False, device=None) -> FilterState:
    """Low-pass filter (filter.h:60-66)."""
    t = _f32(time_const, device)
    k3 = -1.0 / (1.0 + 2.0 * t)
    k2 = -k3
    k1 = (1.0 - 2.0 * t) * k3
    k0 = -k1 - 1.0
    return _init(k0, k1, k2, k3, out0, angle, device)


def hpf_init(time_const, out0=0.0, angle=False, device=None) -> FilterState:
    """High-pass filter (filter.h:67-73)."""
    t = _f32(time_const, device)
    k3 = -1.0 / (1.0 + 2.0 * t)
    k2 = -k3 * 2.0 * t
    k1 = (1.0 - 2.0 * t) * k3
    k0 = 2.0 * t * (-k1 + 1.0)
    return _init(k0, k1, k2, k3, out0, angle, device)


def filter_set(state: FilterState, out0) -> FilterState:
    """Reset the filter output to ``out0`` (filter.h:76-80)."""
    out0 = _f32(out0, state.out.device).expand(state.out.shape)
    x = (1.0 - state.k[..., 2]) * out0 / state.k[..., 3]
    return state._replace(x=x, out=out0.clone())


def filter_step(state: FilterState, value):
    """Feed one sample; returns ``(new_state, output)`` (filter.h:81-94).

    In angle mode the input is unwrapped relative to the current output:
    ``in' = out + remainder(in - out, 2*pi)``."""
    value = _f32(value, state.out.device).expand(state.out.shape)
    two_pi = 2.0 * math.pi
    wrapped = state.out + (value - state.out) - two_pi * torch.round(
        (value - state.out) / two_pi)
    v = torch.where(state.angle, wrapped, value)
    x = state.k[..., 0] * v + state.k[..., 1] * state.x
    out = state.k[..., 2] * v + state.k[..., 3] * x
    return state._replace(x=x, out=out), out


def where(pred, a: FilterState, b: FilterState) -> FilterState:
    """Elementwise select between two filter states on a device bool."""
    return FilterState(*(torch.where(pred, x, y) for x, y in zip(a, b)))
