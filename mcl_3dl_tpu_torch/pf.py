"""Particle-filter core on struct-of-arrays particle tensors.

Port of the JAX package's ``pf.py`` (``pf::ParticleFilter``,
include/mcl_3dl/pf.h:160-462).  Inactive slots (index >= n_active) are
masked, never removed.  Random draws are inputs: ``resample`` takes the
comb offset ``u0`` in [0, 1) and the jitter normals ``[cap, 6]``,
``add_noise`` its normals ``[cap, 6]``.  ``resize`` draws nothing.
"""

from __future__ import annotations

import torch

from mcl_3dl_tpu_torch import state as st
from mcl_3dl_tpu_torch.math import cumsum
from mcl_3dl_tpu_torch.math import quat as mq
from mcl_3dl_tpu_torch.state import ParticleState


def measure(state: ParticleState, likelihood):
    """Multiply weights by ``likelihood`` and normalize; ``(new_state,
    entropy)``.  If the total weight is zero the previous weights are kept
    and the entropy reads 0 (pf.h:252-279)."""
    mask = state.active_mask()
    prob = state.prob * likelihood * mask
    total = torch.sum(prob)
    ok = total > 0.0
    prob_norm = prob / torch.where(ok, total, torch.ones_like(total))
    plogp = torch.where(prob_norm > 0.0, prob_norm * torch.log(prob_norm),
                        torch.zeros_like(prob_norm))
    entropy = -torch.sum(plogp)
    new_prob = torch.where(ok, prob_norm, state.prob)
    return (state._replace(prob=new_prob),
            torch.where(ok, entropy, torch.zeros_like(entropy)))


def bias(state: ParticleState, bias_values) -> ParticleState:
    """Set the per-particle bias weights (pf.h:245-251)."""
    return state._replace(prob_bias=bias_values)


def _systematic_select(prob, mask, n_active, capacity: int, p0, pstep):
    """For each comb offset ``p0 + pstep * k`` (k = 0..C-1), the first
    particle whose cumulative weight reaches it, in closed form: with
    ``m_j = floor((accum[j] - p0) / pstep) + 1`` offsets at or below
    ``accum[j]``, ``idx[k] = #{j : m_j <= k}`` — a histogram of ``m`` and
    an inclusive cumsum (the weights' scan is ``math.cumsum``, the same
    bits on every run).  Counts at ``m >= capacity`` fall off the end
    (they land in a dropped extra bin, never clamped onto the last one).
    Results are clamped into the active range (pf.h:209-213)."""
    accum = cumsum(prob * mask)
    m = torch.floor((accum - p0) / pstep).to(torch.int32) + 1
    m = torch.clamp(m, min=0, max=capacity).to(torch.int64)
    hist = torch.zeros((capacity + 1,), dtype=torch.int32, device=prob.device)
    hist.index_add_(0, m, torch.ones_like(m, dtype=torch.int32))
    idx = torch.cumsum(hist[:capacity], dim=0, dtype=torch.int32)
    return torch.minimum(idx, torch.clamp(n_active - 1, min=0))


def _gather_states(state: ParticleState, idx) -> ParticleState:
    """Reorder the particle columns by ``idx`` with one row gather."""
    packed = torch.cat([state.pos, state.rot, state.odom_err_lin,
                        state.odom_err_ang, state.noise], dim=1)
    g = packed[idx.to(torch.int64)]
    return state._replace(pos=g[:, 0:3], rot=g[:, 3:7],
                          odom_err_lin=g[:, 7:10], odom_err_ang=g[:, 10:13],
                          noise=g[:, 13:17])


def resample(state: ParticleState, u0, normals6, sigma6) -> ParticleState:
    """Systematic (low-variance) resampling (pf.h:186-225): comb offset
    ``u0 * pstep``; jitter only on draws that repeat the previous source
    particle (the first draw compares against particle 0), and only
    jittered rotations are re-normalized."""
    cap = state.capacity
    mask = state.active_mask()
    nf = state.n_active.to(torch.float32)
    total = torch.sum(state.prob * mask)
    pstep = total / nf
    idx = _systematic_select(state.prob, mask, state.n_active, cap,
                             u0 * pstep, pstep)
    prev_idx = torch.cat([torch.zeros_like(idx[:1]), idx[:-1]])
    dup = (idx == prev_idx) & mask
    new_state = _gather_states(state, idx)
    noise6 = normals6 * torch.as_tensor(
        sigma6, dtype=torch.float32, device=state.device) * dup[:, None]
    out = st.apply_noise_6dof(new_state, noise6)
    rot = torch.where(dup[:, None], mq.normalize(out.rot), out.rot)
    return out._replace(rot=rot, prob=mask / nf)


def add_noise(state: ParticleState, normals6, sigma6) -> ParticleState:
    """Expansion noise on every active particle (pf.h:226-237)."""
    noise6 = normals6 * torch.as_tensor(
        sigma6, dtype=torch.float32, device=state.device)
    return st.apply_noise_6dof(state, noise6 * state.active_mask()[:, None])


def expectation(state: ParticleState):
    """Weighted mean pose -> (pos[3], quat[4]) (pf.h:280-293)."""
    return st.weighted_mean(state, state.prob)


def expectation_biased(state: ParticleState):
    """Weighted mean with the bias weights (pf.h:294-303)."""
    return st.weighted_mean(state, state.prob * state.prob_bias)


def max_particle(state: ParticleState) -> dict:
    """State of the highest-weight particle (pf.h:361-374)."""
    idx = torch.argmax(torch.where(state.active_mask(), state.prob,
                                   torch.full_like(state.prob, -torch.inf)))
    return {"pos": state.pos[idx], "rot": state.rot[idx],
            "odom_err_lin": state.odom_err_lin[idx],
            "odom_err_ang": state.odom_err_ang[idx],
            "noise": state.noise[idx]}


def resize(state: ParticleState, new_n) -> ParticleState:
    """Re-draw ``new_n`` particles from the weight CDF (pf.h:399-436): a
    deterministic comb at ``pstep * (i + 1)``, no jitter, uniform output
    weights and bias weights 1.  ``new_n`` (an int or a device int32
    scalar) must not exceed the capacity; the engine grows it first."""
    cap = state.capacity
    mask = state.active_mask()
    new_n = torch.as_tensor(new_n, dtype=torch.int32, device=state.device)
    nf = new_n.to(torch.float32)
    total = torch.sum(state.prob * mask)
    pstep = total / nf
    idx = _systematic_select(state.prob, mask, state.n_active, cap, pstep,
                             pstep)
    out = _gather_states(state, idx)
    new_mask = torch.arange(cap, dtype=torch.int32, device=state.device) < new_n
    return out._replace(prob=new_mask / nf,
                        prob_bias=torch.ones_like(state.prob_bias),
                        n_active=new_n)


def covariance(state: ParticleState):
    """6x6 (xyz, rpy) covariance about the weighted mean (pf.h:304-360)."""
    mean_pos, mean_rot = expectation(state)
    return st.covariance6(state, state.prob, mean_pos, mean_rot)
