"""Multivariate-normal mixture densities over embedding vectors (port of
``hmm_layer_tpu/models/mvn.py``).

Kernels of shape ``(k1, k2, components, 2d)`` (diagonal) or
``(k1, k2, components, d + d(d+1)/2)`` (full scale-TriL); log-densities by
Mahalanobis distance with inverse scales, optional mixture coefficients,
and the L2 regulariser of the scale kernel. The class holds the static
configuration only; the kernel is passed to each method, so that it can
be a parameter of the module that uses it.
"""

from __future__ import annotations

import math

import torch

from ..utils.bijectors import DefaultDiagBijector, FillScaleTriL

__all__ = ["MvnMixture"]


class MvnMixture:
    def __init__(
        self,
        dim: int,
        diag_only: bool = True,
        diag_bijector: DefaultDiagBijector | None = None,
    ):
        self.dim = dim
        self.diag_only = diag_only
        self.diag_bijector = diag_bijector or DefaultDiagBijector(1.0)
        self.scale_tril = FillScaleTriL(self.diag_bijector)
        self.constant = self.dim * math.log(2 * math.pi)

    def num_params(self) -> int:
        d = self.dim
        return 2 * d if self.diag_only else d + d * (d + 1) // 2

    def _validate(self, kernel):
        if kernel.dim() != 4 or kernel.shape[-1] != self.num_params():
            raise ValueError(
                f"kernel must be (k1, k2, c, {self.num_params()}), got {tuple(kernel.shape)}"
            )

    def component_expectations(self, kernel):
        """(k1, k2, c, d) means."""
        return kernel[..., : self.dim]

    def expectation(self, kernel, mixture_kernel=None):
        comp = self.component_expectations(kernel)
        if kernel.shape[2] == 1:
            return comp[..., 0, :]
        mix = self.mixture_coefficients(mixture_kernel)
        return (comp * mix[..., None]).sum(-2)

    def component_scale_diag(self, kernel):
        """Diagonal of the scale matrix, (k1, k2, c, d)."""
        if self.diag_only:
            return self.diag_bijector.forward(kernel[..., self.dim :]) + 1e-8
        tril = self.scale_tril.forward(kernel[..., self.dim :])
        return torch.diagonal(tril, dim1=-2, dim2=-1)

    def component_covariances(self, kernel):
        if self.diag_only:
            return torch.square(self.component_scale_diag(kernel))
        tril = self.scale_tril.forward(kernel[..., self.dim :])
        return torch.matmul(tril, tril.transpose(-1, -2))

    def mixture_coefficients(self, mixture_kernel):
        if mixture_kernel is None:
            raise ValueError(
                "mixture_kernel is required for multi-component mixtures "
                "(kernel has more than one component)"
            )
        return torch.softmax(mixture_kernel, dim=-1)

    def component_log_pdf(self, kernel, inputs):
        """All-pairs component log-densities.

        Args:
            kernel: (k1, k2, c, p).
            inputs: (k1, batch, d).
        Returns:
            (k1, batch, k2, c).

        Holds ``diff`` (k1, k2, c, batch, d) as the JAX function does: at
        b = 32, L = 9999, 13 parameter states and d = 32 that is 0.53 GB.
        """
        self._validate(kernel)
        mu = self.component_expectations(kernel)  # (k1, k2, c, d)
        diff = inputs[:, None, None] - mu[..., None, :]  # (k1, k2, c, b, d)
        if self.diag_only:
            scale_diag = self.component_scale_diag(kernel)
            log_det = 2.0 * torch.log(scale_diag).sum(-1)  # (k1, k2, c)
            pinv_sq = torch.square(1.0 / scale_diag)
            md_sq = (torch.square(diff) * pinv_sq[..., None, :]).sum(-1)
        else:
            tril = self.scale_tril.forward(kernel[..., self.dim :])
            log_det = 2.0 * torch.log(torch.diagonal(tril, dim1=-2, dim2=-1)).sum(-1)
            # Solve L y = diff  =>  y = L^{-1} diff; Mahalanobis = |y|^2.
            # One solve per component with the positions as right-hand
            # sides (columns), so that L is not copied per position.
            y = torch.linalg.solve_triangular(tril, diff.transpose(-1, -2), upper=False)
            md_sq = torch.square(y).sum(-2)
        md_sq = md_sq.movedim(-1, 1)  # (k1, k2, c, b) -> (k1, b, k2, c)
        return -0.5 * (self.constant + log_det[:, None] + md_sq)

    def log_pdf(self, kernel, inputs, mixture_kernel=None):
        """Mixture log-density; (k1, batch, k2)."""
        comp = self.component_log_pdf(kernel, inputs)
        if kernel.shape[2] == 1:
            return comp[..., 0]
        log_mix = torch.log(self.mixture_coefficients(mixture_kernel))
        return torch.logsumexp(comp + log_mix[:, None], dim=-1)

    def regularization_l2_loss(self, kernel):
        return torch.square(kernel[..., self.dim :]).sum(-1).mean()
