"""Bijectors and triangular-matrix utilities for covariance
parameterisation (port of ``hmm_layer_tpu/utils/bijectors.py``).

``inverse_softplus``, ``DefaultDiagBijector`` (softplus with an offset so
that kernel 0 maps to a chosen base variance), ``fill_triangular`` and its
inverse (vector <-> lower-triangular packing, the row-major ``tril``
layout of the JAX package) and ``FillScaleTriL``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "inverse_softplus",
    "DefaultDiagBijector",
    "fill_triangular",
    "fill_triangular_inverse",
    "FillScaleTriL",
    "make_kernel",
]


def inverse_softplus(x):
    """``log(expm1(x))``, stable for large ``x``."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return x + torch.log(-torch.expm1(-x))


class DefaultDiagBijector:
    """Softplus bijector with an offset so that kernel 0 maps to
    ``sqrt(base_variance)``."""

    def __init__(self, base_variance: float, epsilon: float = 1e-5):
        base_std = math.sqrt(base_variance)
        self.scale_diag_init = float(inverse_softplus(base_std))
        self.epsilon = epsilon

    def forward(self, x):
        return torch.nn.functional.softplus(x + self.scale_diag_init) + self.epsilon

    def inverse(self, y):
        return inverse_softplus(y - self.epsilon) - self.scale_diag_init


def _tri_n(m: int) -> int:
    n = int((math.sqrt(8 * m + 1) - 1) / 2)
    if n * (n + 1) // 2 != m:
        raise ValueError(f"last dimension ({m}) is not a triangular number")
    return n


def _tri_indices(n: int, upper: bool, device):
    rows, cols = np.triu_indices(n) if upper else np.tril_indices(n)
    return torch.from_numpy(rows).to(device), torch.from_numpy(cols).to(device)


def fill_triangular(x, upper: bool = False):
    """Pack a (..., n(n+1)/2) vector into a (..., n, n) triangular matrix."""
    x = torch.as_tensor(x)
    n = _tri_n(x.shape[-1])
    rows, cols = _tri_indices(n, upper, x.device)
    out = x.new_zeros(tuple(x.shape[:-1]) + (n, n))
    out[..., rows, cols] = x
    return out


def fill_triangular_inverse(x, upper: bool = False):
    """Inverse of :func:`fill_triangular`."""
    x = torch.as_tensor(x)
    rows, cols = _tri_indices(x.shape[-1], upper, x.device)
    return x[..., rows, cols]


class FillScaleTriL:
    """Vector -> lower-triangular scale matrix with a positive diagonal."""

    def __init__(self, diag_bijector: DefaultDiagBijector):
        self.diag_bijector = diag_bijector

    def forward(self, x):
        y = fill_triangular(x)
        d = self.diag_bijector.forward(torch.diagonal(y, dim1=-2, dim2=-1))
        return y - torch.diag_embed(torch.diagonal(y, dim1=-2, dim2=-1)) + torch.diag_embed(d)

    def inverse(self, y):
        y = torch.as_tensor(y)
        d = self.diag_bijector.inverse(torch.diagonal(y, dim1=-2, dim2=-1))
        y = y - torch.diag_embed(torch.diagonal(y, dim1=-2, dim2=-1)) + torch.diag_embed(d)
        return fill_triangular_inverse(y)


def make_kernel(mean, scale, diag_bijector=None):
    """Pack (mean, scale) into an MVN kernel vector: a diagonal ``scale``
    of ``mean``'s shape, or a full lower-triangular one with one more
    axis."""
    mean = torch.as_tensor(mean, dtype=torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32)
    if scale.dim() == mean.dim():
        if diag_bijector is None:
            return torch.cat([mean, scale], dim=-1)
        return torch.cat([mean, diag_bijector.inverse(scale)], dim=-1)
    if scale.dim() == mean.dim() + 1:
        tril = FillScaleTriL(diag_bijector=diag_bijector)
        return torch.cat([mean, tril.inverse(scale)], dim=-1)
    raise ValueError(f"invalid scale shape: {tuple(scale.shape)}")
