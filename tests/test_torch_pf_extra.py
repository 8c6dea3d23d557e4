"""The port's ``pf.uniform_weights``, ``pf.max_biased``, ``pf.entropy``,
``pf.expectation(pass_ratio)``, ``quat.norm``, ``quat.weighted``,
``quat.rotate_axis`` and ``ops.grouped.empty_layout`` against the JAX
package on the CPU, on the JAX tests' inputs (``tests/test_pf.py``,
``tests/test_quat.py``) and on numpy-seeded states with inactive
particles and tied weights.

Tolerances and why:
* ``uniform_weights`` and the particle ``max_biased`` picks: equal (one
  f32 division; an index, ties to the lowest as ``argmax`` in both);
* ``entropy``: rtol 1e-6 (a sum over particles in another order);
* ``expectation(pass_ratio)``: the port's mean bit-equal to its plain
  weighted mean over the weights selected in numpy; against JAX atol 1e-6
  on position and on the quaternion where every component of the mean is
  beyond 0.05 of 0 (else 5e-5: ``from_frame``'s square roots amplify an
  ulp of the weighted sums, which the two libraries add in another
  order).  Equal weights keep index order in both stable sorts.  A ratio
  that a cumulative weight meets within 1e-6 is a boundary: JAX's and
  the port's f32 scans add in other orders and may decide that particle
  either way, so there the port's mean is held to one of the two
  selections and not compared with JAX's;
* ``norm``, ``weighted``, ``rotate_axis``: atol 1e-6 (f32 chains through
  ``acos``/``sin``/``cos``, where the libraries may differ by an ulp);
* ``empty_layout``: shapes and dtypes equal to ``build_layout``'s for the
  same ``n`` and ``cap`` (the port's layout: ``A`` [nt, 12, TILE], ``dest``
  and ``over_idx`` i64; JAX's ``A`` is [nt, 12, 8, 128] of the same
  ``nt``), values zero and ``over_idx`` the sentinel ``n``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcl_3dl_tpu import pf as jpf
from mcl_3dl_tpu import state as jst
from mcl_3dl_tpu.math import quat as jq
from mcl_3dl_tpu.ops import grouped as jog

from mcl_3dl_tpu_torch import convert, pf
from mcl_3dl_tpu_torch import state as st
from mcl_3dl_tpu_torch.math import quat as tq
from mcl_3dl_tpu_torch.ops import grouped as og

torch.set_num_threads(2)   # several test workers share the CPU

QATOL = 1e-6
# from_frame (the weighted mean's quaternion) takes square roots of
# ``1 +- xx +- yy +- zz``: where a component is near 0 that is a difference
# of O(1) f32 sums, so an ulp of the sums (added in another order by the
# two libraries) moves the component by up to ~sqrt(6e-8) / 2; measured
# up to 1.5e-5 on these inputs
NEAR_ZERO = 0.05
ILL_ATOL = 5e-5


def _rot_atol(q):
    return QATOL if np.abs(q).min() > NEAR_ZERO else ILL_ATOL


def _port(js):
    """The port's copy of a JAX state."""
    return convert.particle_state(*(np.asarray(x) for x in js))


def _diag(seed, n, cap=None, mean_x=0.0, sigma_x=1.0):
    """``tests/test_pf.py::make_state``."""
    return jst.init_diagonal(jax.random.PRNGKey(seed), cap or n, n,
                             jnp.asarray([mean_x, 0.0, 0.0]), jnp.zeros(3),
                             jnp.asarray([sigma_x, 0.0, 0.0, 0.0, 0.0, 0.0]))


def _seeded(seed, n=512, active=400, levels=None, rpy0=(0.0, 0.0, 0.0)):
    """A numpy-seeded state of ``n`` slots, ``active`` of them active,
    attitudes about ``rpy0``, its weights drawn from ``levels`` distinct
    values (ties) or uniform, and the inactive slots poisoned."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    rpy = (np.float32(rpy0)
           + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    if levels:
        prob = rng.integers(1, levels + 1, n).astype(np.float32)
    else:
        prob = rng.uniform(0.05, 1.0, n).astype(np.float32)
    prob /= prob[:active].sum()
    pos[active:] = 1e6
    fields = dict(pos=pos, rot=np.asarray(jq.from_rpy(rpy)),
                  odom_err_lin=pos * 0.1, odom_err_ang=rpy * 0.1,
                  noise=rng.normal(size=(n, 4)).astype(np.float32),
                  prob=prob,
                  prob_bias=(rng.integers(1, 4, n) / 4.0).astype(np.float32))
    return jst.ParticleState(**{k: jnp.asarray(v) for k, v in fields.items()},
                             n_active=jnp.int32(active))


def _pf_test_states():
    """The states of ``tests/test_pf.py`` the functions run on."""
    s4 = jst.zeros(4)._replace(
        pos=jnp.asarray(np.array([[10, 0, 0], [1, 0, 0], [2, 0, 0],
                                  [100, 0, 0]], np.float32)),
        prob=jnp.asarray(np.array([0.1, 0.4, 0.3, 0.2], np.float32)))
    s8 = _diag(10, 8)._replace(
        prob=jnp.asarray(np.linspace(0.1, 1.0, 8, dtype=np.float32)),
        prob_bias=jnp.asarray(np.linspace(1.0, 0.01, 8, dtype=np.float32)))
    return {
        "flat_64": jpf.uniform_weights(_diag(4, 64)),
        "heavy_64": _diag(6, 64)._replace(prob=jnp.asarray(
            np.where(np.arange(64) == 17, 1.0, 1e-9).astype(np.float32))),
        "max_8": s8,
        "cov_16384": _diag(11, 1 << 14),
        "masked_40_of_64": _diag(15, 40, cap=64, mean_x=1.0, sigma_x=0.1),
        "pass_ratio_4": s4,
        "seeded_uniform": _seeded(0),
        "seeded_tied": _seeded(1, levels=3),
        "seeded_tied_all_active": _seeded(2, n=256, active=256, levels=2),
        "seeded_turned": _seeded(3, rpy0=(0.6, -0.4, 1.2)),
        "seeded_turned_tied": _seeded(4, levels=4, rpy0=(-0.5, 0.7, 2.0)),
    }


STATES = _pf_test_states()


@pytest.mark.parametrize("name", sorted(STATES))
def test_uniform_weights_matches_jax(name):
    js = STATES[name]
    got = pf.uniform_weights(_port(js))
    np.testing.assert_array_equal(got.prob.numpy(),
                                  np.asarray(jpf.uniform_weights(js).prob))


@pytest.mark.parametrize("name", sorted(STATES))
def test_max_biased_matches_jax(name):
    js = STATES[name]
    want, got = jpf.max_biased(js), pf.max_biased(_port(js))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("name", sorted(STATES))
def test_entropy_matches_jax(name):
    js = STATES[name]
    np.testing.assert_allclose(float(pf.entropy(_port(js))),
                               float(jpf.entropy(js)), rtol=1e-6)


RATIOS = (0.05, 0.3, 0.5, 0.6, 0.9, 1.0)
BOUNDARY = 1e-6          # cumsum within this of the ratio: either side


def _selections(js, ratio):
    """The weights ``expectation(pass_ratio)`` averages over, in numpy
    (float64 cumsum), with the ratio lowered and raised by ``BOUNDARY``:
    they differ where a cumulative weight meets the ratio within it, and
    the two packages' f32 scans (which add in other orders) may then
    decide that particle either way."""
    prob = np.where(np.asarray(js.active_mask()), np.asarray(js.prob), 0.0)
    prob = prob.astype(np.float32)
    order = np.argsort(-prob, kind="stable")
    p = prob[order]
    before = np.cumsum(p.astype(np.float64)) - p
    if ratio >= 1.0:                         # every particle
        return [torch.as_tensor(prob)] * 2
    out = []
    for r in (ratio - BOUNDARY, ratio + BOUNDARY):
        w = np.zeros_like(prob)
        w[order] = np.where(before <= r, p, 0.0)
        out.append(torch.as_tensor(w))
    return out


@pytest.mark.parametrize("name", sorted(STATES))
def test_expectation_pass_ratio_matches_jax(name):
    """The port's mean is, to the bit, its plain weighted mean over the
    weights selected in numpy (at a boundary, over one of the two
    selections); away from a boundary it is JAX's within the tolerances."""
    js = STATES[name]
    ts = _port(js)
    for ratio in RATIOS:
        t_pos, t_rot = pf.expectation(ts, pass_ratio=ratio)
        lo, hi = _selections(js, ratio)
        plain = [st.weighted_mean(ts, w) for w in (lo, hi)]
        assert any(torch.equal(t_pos, p) and torch.equal(t_rot, q)
                   for p, q in plain), ratio
        if not torch.equal(lo, hi):
            continue
        j_pos, j_rot = jpf.expectation(js, pass_ratio=ratio)
        np.testing.assert_allclose(t_pos.numpy(), np.asarray(j_pos),
                                   atol=1e-6, err_msg=f"ratio {ratio}")
        np.testing.assert_allclose(t_rot.numpy(), np.asarray(j_rot),
                                   atol=_rot_atol(np.asarray(j_rot)),
                                   err_msg=f"ratio {ratio}")


def test_expectation_pass_ratio_cutoff():
    """``tests/test_pf.py::test_expectation_pass_ratio`` through the port:
    the crossing particle is included, and with a ratio of 1 the mean is
    the plain weighted mean, to the bit."""
    ts = _port(STATES["pass_ratio_4"])
    assert abs(float(pf.expectation(ts, pass_ratio=0.6)[0][0])
               - (0.4 * 1.0 + 0.3 * 2.0) / 0.7) < 1e-5
    assert abs(float(pf.expectation(ts, pass_ratio=0.3)[0][0]) - 1.0) < 1e-5
    for a, b in zip(pf.expectation(ts, pass_ratio=1.0), pf.expectation(ts)):
        assert torch.equal(a, b)


def test_expectation_pass_ratio_keeps_index_order_on_ties():
    """Equal weights at the cutoff: the stable order takes the lower
    indices first, in JAX as in the port (a descending sort that is not
    stable could take any of them)."""
    n = 8
    prob = np.full(n, 1.0 / n, np.float32)
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = np.arange(n)
    js = jst.zeros(n)._replace(pos=jnp.asarray(pos), prob=jnp.asarray(prob))
    t_pos, _ = pf.expectation(_port(js), pass_ratio=0.3)
    j_pos, _ = jpf.expectation(js, pass_ratio=0.3)
    # cumsum before particles 0, 1, 2 is 0, 1/8, 2/8 <= 0.3; the fourth's
    # 3/8 is not: the mean of x = 0, 1, 2
    assert abs(float(t_pos[0]) - 1.0) < 1e-6
    np.testing.assert_allclose(t_pos.numpy(), np.asarray(j_pos), atol=1e-6)


def _quat_cases():
    rng = np.random.default_rng(7)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    z = np.asarray(jq.from_axis_angle(jnp.asarray([0.0, 0.0, 1.0]), 1.0))
    yaw = np.asarray(jq.from_axis_angle(jnp.asarray([0.0, 0.0, 1.0]), 0.7))
    roll90 = np.asarray(jq.from_axis_angle(jnp.asarray([1.0, 0.0, 0.0]),
                                           np.pi / 2))
    return {
        # tests/test_quat.py:97 and :132
        "test_quat": (np.stack([z, yaw]), np.stack([roll90, roll90]),
                      np.float32([0.5, 1.0])),
        "random": (q, q[::-1].copy(),
                   rng.uniform(-2.0, 2.0, 64).astype(np.float32)),
        "identity": (np.tile(np.float32([0, 0, 0, 1]), (2, 1)),
                     q[:2].copy(), np.float32([0.5, 3.0])),
        "unnormalized": (q[:8] * 2.5, q[8:16].copy(), np.full(8, 0.25,
                                                              np.float32)),
    }


QUATS = _quat_cases()


@pytest.mark.parametrize("name", sorted(QUATS))
def test_quat_norm_weighted_rotate_axis_match_jax(name):
    q, r, s = QUATS[name]
    qt, rt, st_ = (torch.as_tensor(x) for x in (q, r, s))
    pairs = [(tq.norm(qt), jq.norm(jnp.asarray(q))),
             (tq.weighted(qt, st_), jq.weighted(jnp.asarray(q),
                                                jnp.asarray(s))),
             (tq.rotate_axis(qt, rt), jq.rotate_axis(jnp.asarray(q),
                                                     jnp.asarray(r)))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=QATOL)


def test_quat_weighted_and_rotate_axis_as_the_jax_tests_read_them():
    """``tests/test_quat.py::test_weighted`` and ``test_rotate_axis``
    through the port."""
    axis_z = torch.tensor([0.0, 0.0, 1.0])
    half = tq.weighted(tq.from_axis_angle(axis_z, torch.tensor(1.0)), 0.5)
    assert abs(float(tq.to_axis_angle(half)[1]) - 0.5) < 1e-5
    yaw_q = tq.from_axis_angle(axis_z, torch.tensor(0.7))
    roll90 = tq.from_axis_angle(torch.tensor([1.0, 0.0, 0.0]),
                                torch.tensor(np.pi / 2))
    axis, ang = tq.to_axis_angle(tq.rotate_axis(yaw_q, roll90))
    assert abs(float(ang) - 0.7) < 1e-5
    np.testing.assert_allclose(axis.numpy(), [0.0, -1.0, 0.0], atol=1e-5)
    assert abs(float(tq.norm(yaw_q * 3.0)) - 3.0) < 1e-6


@pytest.mark.parametrize("n", [1024, 4096, 1 << 14])
def test_empty_layout_matches_build_layout(n):
    cap = og.default_overflow_cap(n)
    rng = np.random.default_rng(n)
    stats = og.GroupStats(
        g=torch.as_tensor(rng.integers(0, og.G_GROUPS, n).astype(np.int32)),
        A=torch.as_tensor(rng.normal(size=(n, 12)).astype(np.float32)),
        a_min=None, a_max=None, any_active=None, n_over=None)
    built = og.build_layout(stats, cap)
    empty = og.empty_layout(n, cap)
    for b, e in zip(built, empty):
        assert (b.shape, b.dtype) == (e.shape, e.dtype)
        assert torch.all(e == (n if e is empty.over_idx else 0))
    jempty = jog.empty_layout(n, cap)
    assert jempty.A.shape[0] == empty.A.shape[0]
    assert jempty.A.size == empty.A.numel()
    for name in ("dest", "tile_group", "over_idx"):
        assert getattr(jempty, name).shape == tuple(getattr(empty, name).shape)
    np.testing.assert_array_equal(empty.over_idx.numpy(),
                                  np.asarray(jempty.over_idx))
