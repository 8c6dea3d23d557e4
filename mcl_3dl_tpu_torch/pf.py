"""Particle-filter core on struct-of-arrays particle tensors.

Port of the JAX package's ``pf.py`` (``pf::ParticleFilter``,
include/mcl_3dl/pf.h:160-462).  Inactive slots (index >= n_active) are
masked, never removed.  Random draws are inputs: ``resample`` takes the
comb offset ``u0`` in [0, 1) and the jitter normals ``[cap, 6]``,
``add_noise`` its normals ``[cap, 6]``.  ``resize`` draws nothing.

Every function takes an optional ``shard`` (``shard.Shard``): the state is
then one rank's slice of a particle split.  Sums go through
``all_reduce``; ``max_particle`` takes the highest weight, on a tie the
lowest global index; ``resample`` and ``resize`` bring every slice's
weights and rows together (``all_gather``), select once over the whole
capacity, and keep their own slice.  Without a shard every function
computes the bits it computes alone.
"""

from __future__ import annotations

import torch

from mcl_3dl_tpu_torch import state as st
from mcl_3dl_tpu_torch.math import cumsum
from mcl_3dl_tpu_torch.math import quat as mq
from mcl_3dl_tpu_torch.shard import offset, total as _total
from mcl_3dl_tpu_torch.state import ParticleState


def uniform_weights(state: ParticleState) -> ParticleState:
    """Equal weights ``1 / n_active`` on the active particles, 0 on the
    others."""
    return state._replace(
        prob=state.active_mask() / state.n_active.to(torch.float32))


def measure(state: ParticleState, likelihood, shard=None):
    """Multiply weights by ``likelihood`` and normalize; ``(new_state,
    entropy)``.  If the total weight is zero the previous weights are kept
    and the entropy reads 0 (pf.h:252-279)."""
    mask = state.active_mask(offset(shard))
    prob = state.prob * likelihood * mask
    total = _total(prob, shard)
    ok = total > 0.0
    prob_norm = prob / torch.where(ok, total, torch.ones_like(total))
    plogp = torch.where(prob_norm > 0.0, prob_norm * torch.log(prob_norm),
                        torch.zeros_like(prob_norm))
    entropy = -_total(plogp, shard)
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
    hist = torch.zeros((capacity + 1,), dtype=torch.int32,
                       device=prob.device).index_add(
        0, m, torch.ones_like(m, dtype=torch.int32))
    idx = torch.cumsum(hist[:capacity], dim=0, dtype=torch.int32)
    return torch.minimum(idx, torch.clamp(n_active - 1, min=0))


def _packed(state: ParticleState):
    """The particle columns as one [C, 17] row per particle."""
    return torch.cat([state.pos, state.rot, state.odom_err_lin,
                      state.odom_err_ang, state.noise], dim=1)


def _gather_states(state: ParticleState, idx, packed=None) -> ParticleState:
    """Reorder the particle columns by ``idx`` with one row gather from
    ``packed`` (default the state's own rows)."""
    packed = _packed(state) if packed is None else packed
    g = packed[idx.to(torch.int64)]
    return state._replace(pos=g[:, 0:3], rot=g[:, 3:7],
                          odom_err_lin=g[:, 7:10], odom_err_ang=g[:, 10:13],
                          noise=g[:, 13:17])


def _whole(state: ParticleState, shard):
    """``(prob, mask, capacity, rows)`` over the whole capacity: the
    state's own, or with a shard every slice's, gathered (``rows`` None:
    the state's own rows)."""
    if shard is None:
        return state.prob, state.active_mask(), state.capacity, None
    mask = torch.arange(shard.capacity, dtype=torch.int32,
                        device=state.device) < state.n_active
    return (shard.gather(state.prob), mask, shard.capacity,
            shard.gather(_packed(state)))


def resample(state: ParticleState, u0, normals6, sigma6,
             shard=None) -> ParticleState:
    """Systematic (low-variance) resampling (pf.h:186-225): comb offset
    ``u0 * pstep``; jitter only on draws that repeat the previous source
    particle (the first draw compares against particle 0), and only
    jittered rotations are re-normalized.  ``normals6`` are the slice's."""
    prob, mask, cap, rows = _whole(state, shard)
    nf = state.n_active.to(torch.float32)
    total = torch.sum(prob * mask)
    pstep = total / nf
    idx = _systematic_select(prob, mask, state.n_active, cap,
                             u0 * pstep, pstep)
    prev_idx = torch.cat([torch.zeros_like(idx[:1]), idx[:-1]])
    dup = (idx == prev_idx) & mask
    if shard is not None:
        idx, dup, mask = shard.local(idx), shard.local(dup), shard.local(mask)
    new_state = _gather_states(state, idx, rows)
    noise6 = normals6 * torch.as_tensor(
        sigma6, dtype=torch.float32, device=state.device) * dup[:, None]
    out = st.apply_noise_6dof(new_state, noise6)
    rot = torch.where(dup[:, None], mq.normalize(out.rot), out.rot)
    return out._replace(rot=rot, prob=mask / nf)


def add_noise(state: ParticleState, normals6, sigma6,
              shard=None) -> ParticleState:
    """Expansion noise on every active particle (pf.h:226-237)."""
    noise6 = normals6 * torch.as_tensor(
        sigma6, dtype=torch.float32, device=state.device)
    mask = state.active_mask(offset(shard))
    return st.apply_noise_6dof(state, noise6 * mask[:, None])


def expectation(state: ParticleState, pass_ratio: float = 1.0, shard=None):
    """Weighted mean pose -> (pos[3], quat[4]) (pf.h:280-293).

    With ``pass_ratio < 1`` the mean runs over the heaviest particles in
    descending order of weight until the cumulative weight exceeds the
    ratio, the crossing particle included: particle ``i`` (in that order)
    counts iff the cumulative weight before it is ``<= pass_ratio``.  The
    order is stable (equal weights in index order, as the JAX package's
    ``argsort`` orders them), over the whole capacity with a ``shard``."""
    if pass_ratio >= 1.0:
        return st.weighted_mean(state, state.prob, shard)
    prob, mask, _, _ = _whole(state, shard)
    prob = torch.where(mask, prob, torch.zeros_like(prob))
    order = torch.sort(-prob, stable=True).indices
    sorted_prob = prob[order]
    prev_csum = cumsum(sorted_prob) - sorted_prob
    w = torch.zeros_like(prob)
    w[order] = torch.where(prev_csum <= pass_ratio, sorted_prob,
                           torch.zeros_like(sorted_prob))
    if shard is not None:
        w = shard.local(w)
    return st.weighted_mean(state, w, shard)


def expectation_biased(state: ParticleState, shard=None):
    """Weighted mean with the bias weights (pf.h:294-303)."""
    return st.weighted_mean(state, state.prob * state.prob_bias, shard)


def max_particle(state: ParticleState, shard=None) -> dict:
    """State of the highest-weight particle (pf.h:361-374); on a tie the
    lowest index, as ``torch.argmax`` takes it."""
    return _argmax_particle(state, state.prob, shard)


def max_biased(state: ParticleState, shard=None) -> dict:
    """State of the highest ``prob * prob_bias`` particle (pf.h:375-390),
    in ``max_particle``'s form and with its tie rule."""
    return _argmax_particle(state, state.prob * state.prob_bias, shard)


def _argmax_particle(state: ParticleState, weights, shard) -> dict:
    prob = torch.where(state.active_mask(offset(shard)), weights,
                       torch.full_like(weights, -torch.inf))
    idx = torch.argmax(prob)
    names = ("pos", "rot", "odom_err_lin", "odom_err_ang", "noise")
    cols = (state.pos, state.rot, state.odom_err_lin, state.odom_err_ang,
            state.noise)
    if shard is None:
        # index_select, not c[idx]: a 0-dim index tensor is read on the
        # host, which a step captured into a CUDA graph may not do
        sel = idx.reshape(1)
        return {k: c.index_select(0, sel)[0] for k, c in zip(names, cols)}
    # every slice's best as (weight, row); the first maximum in rank order
    # is the lowest global index
    cand = shard.gather(torch.cat([prob[idx].reshape(1)]
                                  + [c[idx] for c in cols])[None])
    row = cand[torch.argmax(cand[:, 0]), 1:]
    return dict(zip(names, torch.split(row, [3, 4, 3, 3, 4])))


def entropy(state: ParticleState, shard=None):
    """``-sum p log p`` over the active particles with ``p > 0``
    (pf.h:263-273)."""
    p = state.prob * state.active_mask(offset(shard))
    return -_total(torch.where(p > 0.0, p * torch.log(p), torch.zeros_like(p)),
                   shard)


def resize(state: ParticleState, new_n, shard=None) -> ParticleState:
    """Re-draw ``new_n`` particles from the weight CDF (pf.h:399-436): a
    deterministic comb at ``pstep * (i + 1)``, no jitter, uniform output
    weights and bias weights 1.  ``new_n`` (an int or a device int32
    scalar) must not exceed the capacity; the engine grows it first."""
    prob, mask, cap, rows = _whole(state, shard)
    new_n = torch.as_tensor(new_n, dtype=torch.int32, device=state.device)
    nf = new_n.to(torch.float32)
    total = torch.sum(prob * mask)
    pstep = total / nf
    idx = _systematic_select(prob, mask, state.n_active, cap, pstep,
                             pstep)
    if shard is not None:
        idx = shard.local(idx)
    out = _gather_states(state, idx, rows)
    new_mask = torch.arange(offset(shard), offset(shard) + state.capacity,
                            dtype=torch.int32, device=state.device) < new_n
    return out._replace(prob=new_mask / nf,
                        prob_bias=torch.ones_like(state.prob_bias),
                        n_active=new_n)


def covariance(state: ParticleState, shard=None):
    """6x6 (xyz, rpy) covariance about the weighted mean (pf.h:304-360)."""
    mean_pos, mean_rot = expectation(state, shard=shard)
    return st.covariance6(state, state.prob, mean_pos, mean_rot, shard)
