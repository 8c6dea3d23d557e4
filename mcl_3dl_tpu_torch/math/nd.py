"""Gaussian likelihood evaluators (reference: include/mcl_3dl/nd.h)."""

from __future__ import annotations

import math

import numpy as np
import torch

from mcl_3dl_tpu_torch.math import device_constant


def normal_likelihood(x, sigma):
    """1-D Gaussian pdf N(x; 0, sigma^2) (nd.h:45-53), evaluated in f32."""
    sigma = (torch.as_tensor(sigma, dtype=torch.float32, device=x.device)
             if isinstance(sigma, torch.Tensor)
             else device_constant(float(sigma), torch.float32, x.device))
    a = 1.0 / torch.sqrt(2.0 * math.pi * sigma * sigma)
    return a * torch.exp(-x * x / (sigma * sigma * 2.0))


class NormalLikelihoodNd:
    """N-D Gaussian pdf with precomputed inverse covariance (nd.h:60-80);
    the inverse and determinant are computed once with numpy."""

    def __init__(self, sigma, device=None):
        sigma = np.asarray(sigma, dtype=np.float64)
        dim = sigma.shape[-1]
        self.a = float(
            1.0 / (np.power(2.0 * np.pi, 0.5 * dim) * np.sqrt(np.linalg.det(sigma))))
        self.sigma_inv = torch.as_tensor(
            np.linalg.inv(sigma), dtype=torch.float32, device=device)

    def __call__(self, x):
        """Evaluate the pdf at ``x`` of shape ``[..., dim]``."""
        quad = torch.einsum("...i,ij,...j->...", x, self.sigma_inv, x)
        return self.a * torch.exp(-0.5 * quad)
