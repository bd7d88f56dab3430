"""Log- and max-plus semiring primitives (port of
``hmm_layer_tpu/ops/semiring.py``).

``(logsumexp, +)`` is the semiring of the forward/backward algorithms,
``(max, +)`` (tropical) that of Viterbi decoding. All functions broadcast
over leading batch dimensions.
"""

from __future__ import annotations

import torch

# Represents impossible transitions in dense log-matrices without -inf.
LOG_ZERO = -1e3

# Probability clamp of the scaled recursions.
EPS = 1e-16


def logmatmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Log-space matrix product ``log(exp(x) @ exp(y))``.

    x: (..., n, k), y: (..., k, m) -> (..., n, m). Each row of ``x`` and
    each column of ``y`` is shifted by its own max, so operands carrying
    large accumulated log-likelihood offsets stay in range.
    """
    x_max = x.amax(dim=-1, keepdim=True)
    y_max = y.amax(dim=-2, keepdim=True)
    x_max = torch.where(torch.isfinite(x_max), x_max, 0.0)
    y_max = torch.where(torch.isfinite(y_max), y_max, 0.0)
    prod = torch.matmul(torch.exp(x - x_max), torch.exp(y - y_max))
    return torch.log(torch.clamp_min(prod, EPS)) + x_max + y_max


def logmatvec(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Log-space row-vector times matrix: v (..., k), m (..., k, n) -> (..., n)."""
    return logmatmul(v[..., None, :], m)[..., 0, :]


def maxmatmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Tropical matrix product ``Z[i, j] = max_k x[i, k] + y[k, j]``.

    x: (..., n, k), y: (..., k, m) -> (..., n, m). Each term is one rounded
    float add and the max is exact, so the result does not depend on the
    order of the k terms.
    """
    return (x[..., :, :, None] + y[..., None, :, :]).amax(dim=-2)


def maxargmatvec(v: torch.Tensor, m: torch.Tensor):
    """Tropical vector-matrix product with argmax.

    v: (..., k), m: (..., k, n) -> (scores (..., n), argmax (..., n) int64):
    ``scores[j] = max_i v[i] + m[i, j]``; the argmax is the lowest maximising
    ``i``, as ``jnp.argmax`` takes it.
    """
    s = v[..., :, None] + m
    return s.amax(dim=-2), s.argmax(dim=-2)


def log_normalize(x: torch.Tensor, dim: int = -1):
    """Split log-weights into ``(x - lse, lse)`` with ``lse = logsumexp(x)``."""
    lse = torch.logsumexp(x, dim=dim, keepdim=True)
    return x - lse, lse.squeeze(dim)
