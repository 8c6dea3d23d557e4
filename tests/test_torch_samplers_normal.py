"""The normal-weighted point sampler of the port against the JAX package
on the CPU: normals, weights and the weighted draw without replacement.

Tolerances and why:
* normals: equal up to sign to 1e-6 (both packages run the same numpy
  and scipy code; the sign of an eigenvector is arbitrary);
* weights: rtol 1e-5 (f32 ``eigh``, ``arccos`` and the ramp's divisions
  in two libraries).  The covariance is clearly anisotropic (eigenvalues
  0.09, 0.01 and 0.001, a weighting ratio of 3): with two eigenvalues
  nearly equal, ``eigh`` may order their eigenvectors differently in the
  two libraries and the dominant direction is not defined;
* the weighted draw: the same selected indices and validity with JAX's
  Gumbel draws injected (ties have probability zero except at weight 0,
  which ``ok`` masks out).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mcl_3dl_tpu.math import quat as jq
from mcl_3dl_tpu.models import samplers as jsamp

from mcl_3dl_tpu_torch import worlds
from mcl_3dl_tpu_torch.models import samplers as tsamp

torch.set_num_threads(2)   # several test workers share the CPU

SW = dict(perform_weighting_ratio=2.0, max_weight_ratio=5.0, max_weight=5.0)


def _cloud(seed, n=1024):
    rng = np.random.default_rng(seed)
    pts = worlds.scan(rng, n).astype(np.float32)
    return rng, pts


@pytest.mark.parametrize("search_range", [0.2, 0.4])
def test_normals_match_jax_up_to_sign(search_range):
    _, pts = _cloud(0)
    got = tsamp.estimate_normals_host(pts, search_range)
    want = jsamp.estimate_normals_host(pts, search_range)
    assert got.dtype == np.float32 and got.shape == want.shape
    sign = np.where(np.sum(got * want, axis=1) < 0, -1.0, 1.0)[:, None]
    np.testing.assert_allclose(got * sign, want, atol=1e-6)
    has = np.linalg.norm(want, axis=1) > 0.5
    assert has.mean() > 0.5          # most points have 3+ neighbours
    assert tsamp.estimate_normals_host(np.zeros((0, 3)), 0.4).shape == (0, 3)


def _cov(rng):
    """A position covariance with eigenvalues 0.09, 0.01, 0.001 along a
    random orthonormal basis."""
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return (q @ np.diag([0.001, 0.01, 0.09]) @ q.T).astype(np.float32)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_weights_match_jax(seed):
    rng, pts = _cloud(seed)
    normals = jsamp.estimate_normals_host(pts, 0.4)
    valid = rng.uniform(size=len(pts)) < 0.9
    cov = _cov(rng)
    rot = np.asarray(jq.from_rpy(jnp.asarray(rng.normal(0, 0.3, 3),
                                             jnp.float32)), np.float32)
    got = tsamp.sampler_with_normal_weights(
        torch.as_tensor(normals), torch.as_tensor(valid), torch.as_tensor(cov),
        torch.as_tensor(rot), **SW).numpy()
    want = np.asarray(jsamp.sampler_with_normal_weights(
        jnp.asarray(normals), jnp.asarray(valid), jnp.asarray(cov),
        jnp.asarray(rot), **SW))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.all(got[~valid] == 0.0)
    assert got[valid].max() > 2.0        # the ramp amplifies some points


@pytest.mark.parametrize("k,valid_frac", [(96, 0.9), (64, 0.02)],
                         ids=["enough", "fewer-valid-than-k"])
def test_weighted_draw_matches_jax(k, valid_frac):
    rng, pts = _cloud(4)
    weights = rng.uniform(0.5, 5.0, len(pts)).astype(np.float32)
    weights[rng.uniform(size=len(pts)) > valid_frac] = 0.0
    key = jax.random.PRNGKey(7)
    g = np.asarray(jax.random.gumbel(key, weights.shape))
    jpts, jok, jidx = jsamp.sample_weighted_without_replacement(
        key, jnp.asarray(pts), jnp.asarray(weights), k)
    tpts, tok, tidx = tsamp.sample_weighted_without_replacement(
        torch.as_tensor(pts), torch.as_tensor(weights), k, torch.as_tensor(g))
    jok, jidx = np.asarray(jok), np.asarray(jidx)
    np.testing.assert_array_equal(tok.numpy(), jok)
    np.testing.assert_array_equal(tidx.numpy()[jok], jidx[jok])
    np.testing.assert_array_equal(tpts.numpy()[jok], np.asarray(jpts)[jok])
    assert len(np.unique(tidx.numpy())) == k          # no duplicates
    assert jok.sum() == min(k, int((weights > 0).sum()))


def test_gumbel_draws_are_standard_gumbel():
    g = tsamp.draw_gumbel(200_000, torch.Generator().manual_seed(0), "cpu")
    assert g.dtype == torch.float32 and torch.isfinite(g).all()
    # mean = Euler's gamma, variance = pi^2 / 6
    assert abs(float(g.mean()) - 0.5772) < 0.01
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.03
