"""Dirichlet mixture densities over probability vectors (port of
``hmm_layer_tpu/models/dirichlet.py``).

The mixture log-pdf, the trainable mixture module with the
Dirichlet-process prior used when priors are trained, and the ``.npz``
format of trained mixtures. The profile-HMM family scores its amino-acid
and transition distributions under such mixtures
(:mod:`hmm_layer_torch.models.priors`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

__all__ = ["dirichlet_log_pdf", "DirichletMixture", "load_mixture_model", "save_mixture_model"]


def dirichlet_log_pdf(p, alpha, q):
    """Log-density of a Dirichlet mixture.

    Args:
        p: (b, s) probability vectors.
        alpha: (k, s) component concentration parameters.
        q: (k,) mixture weights.
    Returns:
        (b,) log-densities.
    """
    logZ = torch.lgamma(alpha).sum(-1) - torch.lgamma(alpha.sum(-1))
    log_p_alpha = torch.log(torch.clamp_min(p, 1e-16))[:, None] * (alpha - 1.0)[None]
    log_p_alpha = log_p_alpha.sum(-1) - logZ
    return torch.logsumexp(log_p_alpha + torch.log(q), dim=-1)


class DirichletMixture(nn.Module):
    """Trainable Dirichlet mixture over ``alphabet_size``-dim simplices.

    It owns ``alpha_kernel`` (k, s) and ``mix_kernel`` (k,), drawn from
    N(0, 1) with ``generator``; with ``use_dirichlet_process`` also the
    process prior's ``gamma_kernel``, ``beta_kernel``, ``lambda_kernel``
    and ``background_kernel`` (the JAX params' names, so
    :func:`~hmm_layer_torch.convert.params_from_jax` loads JAX params).
    """

    def __init__(
        self,
        num_components: int,
        alphabet_size: int,
        use_dirichlet_process: bool = True,
        number_of_examples: int = -1,
        trainable: bool = True,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.num_components = num_components
        self.alphabet_size = alphabet_size
        self.use_dirichlet_process = use_dirichlet_process
        self.number_of_examples = number_of_examples
        self.trainable = trainable
        randn = lambda *shape: torch.randn(shape, generator=generator)  # noqa: E731
        par = lambda x: nn.Parameter(x, requires_grad=trainable)  # noqa: E731
        self.alpha_kernel = par(randn(num_components, alphabet_size))
        self.mix_kernel = par(randn(num_components))
        if use_dirichlet_process:
            self.gamma_kernel = par(torch.tensor([50.0]))
            self.beta_kernel = par(torch.tensor([100.0]))
            self.lambda_kernel = par(torch.ones(1))
            self.background_kernel = par(randn(alphabet_size))

    def make_alpha(self):
        return F.softplus(self.alpha_kernel)

    def make_mix(self):
        return torch.softmax(self.mix_kernel, dim=-1)

    def log_pdf(self, p):
        return dirichlet_log_pdf(p, self.make_alpha(), self.make_mix())

    def component_distributions(self):
        alpha = self.make_alpha()
        return alpha / alpha.sum(-1, keepdim=True)

    def expectation(self):
        return (self.component_distributions() * self.make_mix()[..., None]).sum(0)

    def loss(self, p, training: bool = True):
        """Negative (regularised) mean log-likelihood for prior training."""
        alpha = self.make_alpha()
        mix = self.make_mix()
        loglik = dirichlet_log_pdf(p, alpha, mix).mean()
        if not (training and self.use_dirichlet_process):
            return -loglik
        sum_alpha = alpha.sum(-1, keepdim=True)
        lamb = F.softplus(self.lambda_kernel)
        sum_alpha_prior = (torch.log(lamb) - lamb * sum_alpha).sum()
        gamma = F.softplus(self.gamma_kernel)
        mix_dist = torch.ones_like(mix) * gamma / self.num_components
        ones = torch.ones(1, device=alpha.device)
        mix_prior = dirichlet_log_pdf(mix[None], mix_dist[None], ones)[0]
        beta = F.softplus(self.beta_kernel)
        background = torch.softmax(self.background_kernel, dim=-1)
        comp_dist = background * beta
        comp_prior = dirichlet_log_pdf(alpha / sum_alpha, comp_dist[None], ones).sum()
        joint = loglik + (sum_alpha_prior + mix_prior + comp_prior) / self.number_of_examples
        return -joint


def save_mixture_model(path, model):
    """Write a mixture's parameters (a :class:`DirichletMixture` or a dict
    of arrays) as ``.npz`` under the JAX params' names."""
    params = dict(model.named_parameters()) if isinstance(model, nn.Module) else model
    np.savez(path, **{k: np.asarray(torch.as_tensor(v).detach().cpu()) for k, v in params.items()})


def load_mixture_model(path, num_components, alphabet_size, trainable=False):
    """A :class:`DirichletMixture` holding a trained mixture's parameters."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    model = DirichletMixture(
        num_components,
        alphabet_size,
        use_dirichlet_process="gamma_kernel" in arrays,
        trainable=trainable,
    )
    with torch.no_grad():
        for name, value in arrays.items():
            getattr(model, name).copy_(torch.from_numpy(value))
    return model
