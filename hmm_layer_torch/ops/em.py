"""Classical Baum-Welch (EM) re-estimation for dense HMMs (port of
``hmm_layer_tpu/ops/em.py``).

The E-step reuses the chunked engine's forward and backward quantities:
on CUDA at q <= 16 one K1 summary pass (:func:`.recursion.
_chunk_summaries_dispatch`) serves both directions and K2/K3 give log
alpha and log beta at every position (:func:`.recursion._chunked_values`).
The expected transition counts are the balanced-shift xi product of the
analytic VJPs, a plain float32 einsum.

Emissions are per-position probabilities from arbitrary emitters, so the
emission M-step is the emitter's own job; this module gives the exact
E-step statistics, the closed-form init/transition M-step, and the full
step for free categorical emission tables.
"""

from __future__ import annotations

import torch

from .recursion import (
    _backward_seq,
    _chunk_summaries_dispatch,
    _chunked_values,
    _clamped,
    _forward_seq,
    _xi_sum,
)
from .semiring import EPS

__all__ = [
    "expected_statistics",
    "em_step",
    "categorical_emission_m_step",
    "em_step_categorical",
]


def expected_statistics(init, A, E, parallel_factor: int = 1):
    """E-step: posterior statistics of the hidden chain.

    Args:
        init: (m, q); A: (m, q, q); E: (m, b, L, q) linear emission probs.

    Returns:
        gamma: (m, b, L, q) posterior state probabilities (linear space).
        xi_sum: (m, q, q) expected transition counts, summed over batch and
            time: ``sum_{b,t} P(s_{t-1}=i, s_t=j | x)``.
        loglik: (m, b).
    """
    if parallel_factor == 1:
        la, ll = _forward_seq(init, A, E)
        lb = _backward_seq(A, E)
    else:
        # One summary pass serves both directions.
        C = _chunk_summaries_dispatch(A, E, parallel_factor)
        la, lb, ll = _chunked_values(init, A, E, C, parallel_factor)
    log_E = torch.log(_clamped(E))
    gamma = torch.exp(la + lb - ll[..., None, None])

    # xi_sum(i, j) = A(i, j) * sum_{b,t} exp(la_{t-1}(i) + log_E_t(j)
    #                                        + lb_t(j) - ll), balanced shift
    # (the factors alone would under/overflow at |ll| ~ L).
    csh = la[:, :, :-1].amax(-1, keepdim=True)
    F = torch.exp(la[:, :, :-1] - csh)
    U = torch.exp(lb[:, :, 1:] + log_E[:, :, 1:] - ll[..., None, None] + csh)
    return gamma, A * _xi_sum(F, U), ll


def _m_step_init_from_counts(init_counts, init, pseudocount):
    """Closed-form init update from (m, q) summed t = 0 posterior counts."""
    counts = (init_counts + pseudocount) * (init > 0)
    return counts / torch.clamp_min(counts.sum(-1, keepdim=True), EPS)


def _m_step_init(gamma, init, pseudocount):
    return _m_step_init_from_counts(gamma[:, :, 0].sum(1), init, pseudocount)


def _m_step_A(xi_sum, A, pseudocount):
    counts = (xi_sum + pseudocount) * (A > 0).to(A.dtype)
    row = counts.sum(-1, keepdim=True)
    return torch.where(row > 0, counts / torch.clamp_min(row, EPS), A)


def em_step(init, A, E, parallel_factor: int = 1, pseudocount: float = 0.0):
    """One Baum-Welch update of the initial distribution and transitions.

    ``new_init(i) ∝ sum_b gamma_0(i)``; ``new_A(i, j) ∝ xi_sum(i, j)``.
    ``pseudocount`` smooths both. Transition entries that are exactly zero
    stay zero (the grammar's structure is kept).

    Returns:
        (new_init (m, q), new_A (m, q, q), loglik (m, b)); the loglik is the
        pre-update one (non-decreasing across steps).
    """
    gamma, xi_sum, ll = expected_statistics(init, A, E, parallel_factor)
    return _m_step_init(gamma, init, pseudocount), _m_step_A(xi_sum, A, pseudocount), ll


def categorical_emission_m_step(gamma, x, pseudocount: float = 0.0):
    """M-step for free categorical emission tables:
    ``new_B(j, s) ∝ sum_{b,t} gamma_t(j) * x_t(s)``.

    Args:
        gamma: (m, b, L, q) posterior state probabilities.
        x: (m, b, L, s) one-hot (or soft) observed symbols.

    Returns:
        new_B: (m, q, s) row-stochastic emission table.
    """
    return _m_step_B_from_counts(_emission_counts(gamma, x), pseudocount)


def _emission_counts(gamma, x):
    """(m, q, s) expected symbol counts per state, summed over batch and time."""
    return torch.einsum("mblq,mbls->mqs", gamma, x)


def _m_step_B_from_counts(counts, pseudocount):
    counts = counts + pseudocount
    return counts / torch.clamp_min(counts.sum(-1, keepdim=True), EPS)


def em_step_categorical(init, A, B, x, parallel_factor: int = 1, pseudocount: float = 0.0):
    """One full Baum-Welch step for a lookup-table HMM whose observation
    model is ``E_t = x_t @ B^T`` (B a free (m, q, s) row-stochastic table):
    init, A and B from one E-step.

    Returns:
        (new_init, new_A, new_B, loglik); the loglik is the pre-update one.
    """
    E = torch.einsum("mbls,mqs->mblq", x, B)
    gamma, xi_sum, ll = expected_statistics(init, A, E, parallel_factor)
    return (
        _m_step_init(gamma, init, pseudocount),
        _m_step_A(xi_sum, A, pseudocount),
        categorical_emission_m_step(gamma, x, pseudocount),
        ll,
    )
