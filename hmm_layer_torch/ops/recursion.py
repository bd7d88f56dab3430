"""Core HMM recursions: forward, backward, posterior, log-likelihood.

Port of ``hmm_layer_tpu/ops/recursion.py`` (the sum-product functions of
the posterior-serving path). ``parallel_factor`` P > 1 runs the chunked
two-pass engine:

* **Summary pass** — every chunk of every sequence runs with a ``q x q``
  row-scaled carry, giving transfer operators ``C_p[i, j] = log P(chunk-p
  emissions, right-border state j | left-border state i)``.
* **Boundary combine** — the operators are folded into exact forward and
  backward values at every chunk boundary.
* **Output pass** — each chunk re-runs a ``q``-vector recursion from its
  boundary value.

On a CUDA tensor with q <= 16 the summary and output passes are the CUDA
kernels K1–K3 (:mod:`.cuda_forward`), as the JAX package runs its Pallas
kernels on a TPU (``_use_pallas``); everywhere else the plain chunked
version below runs. The boundary combine and the posterior combine are
plain torch ops in both.

Shapes: ``init`` (m, q), ``A`` (m, q, q), ``E`` (m, b, L, q), all linear
space; outputs are log space. Gradients: the plain paths are differentiable
by autograd; the kernel path raises in backward (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_forward
from .semiring import EPS, logmatmul, logmatvec

__all__ = [
    "forward",
    "backward",
    "posterior",
    "log_likelihood",
    "recommended_parallel_factor",
    "ForwardResult",
]


class ForwardResult(NamedTuple):
    log_alpha: torch.Tensor  # (m, b, L, q) — log P(x_{1..t}, s_t = j)
    log_lik: torch.Tensor  # (m, b) — log P(x_{1..L})


def _clamped(x):
    return torch.clamp_min(x, EPS)


# ---------------------------------------------------------------------------
# Sequential (parallel_factor == 1) recursions
# ---------------------------------------------------------------------------


def _forward_seq(init, A, E):
    """Scaled sequential forward. Returns (log_alpha (m,b,L,q), loglik (m,b))."""
    L = E.shape[2]
    s = _clamped(E[:, :, 0]) * _clamped(init)[:, None, :]
    z = s.sum(-1, keepdim=True)
    alpha, ll = s / z, torch.log(z[..., 0])
    outs = [torch.log(alpha) + ll[..., None]]
    for t in range(1, L):
        s = _clamped(E[:, :, t]) * _clamped(torch.matmul(alpha, A))
        z = s.sum(-1, keepdim=True)
        alpha, ll = s / z, ll + torch.log(z[..., 0])
        outs.append(torch.log(alpha) + ll[..., None])
    return torch.stack(outs, dim=2), ll


def _backward_seq(A, E):
    """Scaled sequential backward. Returns log_beta (m, b, L, q).

    beta_L = 1; beta_t(i) = sum_j A[i, j] * E_{t+1}(j) * beta_{t+1}(j).
    """
    m, b, L, q = E.shape
    beta = torch.ones((m, b, q), dtype=E.dtype, device=E.device)
    ll = torch.zeros((m, b), dtype=E.dtype, device=E.device)
    A_T = A.transpose(-1, -2)
    outs = [torch.zeros_like(beta)]
    for t in range(L - 1, 0, -1):  # consume e_t, produce beta_{t-1}
        s = _clamped(torch.matmul(_clamped(E[:, :, t]) * beta, A_T))
        z = s.amax(-1, keepdim=True)
        beta, ll = s / z, ll + torch.log(z[..., 0])
        outs.append(torch.log(beta) + ll[..., None])
    return torch.stack(outs[::-1], dim=2)


# ---------------------------------------------------------------------------
# Chunked parallel recursions (parallel_factor > 1), plain version
# ---------------------------------------------------------------------------


def _split_chunks(E, parallel_factor):
    m, b, L, q = E.shape
    if L % parallel_factor:
        raise ValueError(
            f"parallel_factor={parallel_factor} must divide seq_len={L}"
        )
    c = L // parallel_factor
    return E.reshape(m, b * parallel_factor, c, q), c


def _chunk_summaries(A, E, parallel_factor):
    """Summary pass: per-chunk transfer operators, (P, m, b, q, q).

    The left border is the state at the chunk's first position for chunk 0
    (identity start) and the state at the last position of the previous
    chunk otherwise (transition-applied start).
    """
    m, b, L, q = E.shape
    P = parallel_factor
    Ec, c = _split_chunks(E, P)
    Et = Ec.movedim(2, 0)  # (c, m, bP, q)
    eye = torch.eye(q, dtype=E.dtype, device=E.device)
    is_first = (torch.arange(P, device=E.device) == 0).to(E.dtype)
    is_first = is_first[None, None, :, None, None]  # (1, 1, P, 1, 1)
    R0 = is_first * eye + (1.0 - is_first) * A[:, None, None]  # (m, 1, P, q, q)
    R0 = R0.expand(m, b, P, q, q).reshape(m, b * P, q, q)
    C = _summaries_from_rows(A, Et, R0).reshape(m, b, P, q, q)
    return C.movedim(2, 0), c


def _summaries_from_rows(A, Et, R0):
    """Scaled summary scan from first-step operator rows ``R0`` (m, bP, r, q);
    ``Et`` (c, m, bP, q). Returns log-space operators (m, bP, r, q)."""

    def scale_rows(s):
        z = _clamped(s.sum(-1, keepdim=True))
        return s / z, torch.log(z[..., 0])

    M, ll = scale_rows(_clamped(Et[0])[..., None, :] * _clamped(R0))
    A_b = A[:, None]
    for t in range(1, Et.shape[0]):
        r = torch.matmul(M, A_b)
        M, dll = scale_rows(_clamped(Et[t])[..., None, :] * _clamped(r))
        ll = ll + dll
    return torch.log(M) + ll[..., None]


def _prefix_logmatmul(X):
    """Inclusive prefix products ``X_0 ∘ ... ∘ X_p`` along dim 0 under
    :func:`logmatmul`, in log2(P) doubling steps."""
    Y, d = X, 1
    while d < Y.shape[0]:
        Y = torch.cat([Y[:d], logmatmul(Y[:-d], Y[d:])], dim=0)
        d *= 2
    return Y


def _boundary_values(init, C):
    """Exact forward/backward values at chunk boundaries.

    Prefix and suffix run in ONE batched stream (the suffix of ``C`` is the
    flipped prefix of the flipped, transposed operators): a sequential
    vector fold for P <= 64, a log-depth prefix product above.

    Args:
        init: (m, q) linear initial distribution.
        C: (P, m, b, q, q) chunk operators.

    Returns:
        T: (P, m, b, q) — log forward at the last position of each chunk.
        S: (P, m, b, q) — log backward at the last position of each chunk
           (S[P-1] = 0).
        loglik: (m, b).
    """
    P, m, b, q = C.shape[:4]
    log_init = torch.log(_clamped(init))
    X = torch.cat([C, C.flip(0).transpose(-1, -2)], dim=2)  # (P, m, 2b, q, q)

    if P <= 64:
        v0 = log_init[:, None, :].expand(m, b, q)
        u = torch.cat([v0, torch.zeros_like(v0)], dim=1)  # (m, 2b, q)
        outs = []
        for p in range(P):
            u = logmatvec(u, X[p])
            outs.append(u)
        outs = torch.stack(outs)
        T = outs[:, :, :b]
        W = outs[:, :, b:]  # W[k] = backward at the start of chunk P-1-k
        S = torch.cat([W.flip(0)[1:], torch.zeros_like(T[:1])], dim=0)
        return T, S, torch.logsumexp(T[-1], dim=-1)

    Y = _prefix_logmatmul(X)
    prefix = Y[:, :, :b]
    suffix_T = Y[:, :, b:].flip(0)
    T = torch.logsumexp(log_init[None, :, None, :, None] + prefix, dim=-2)
    S_inner = torch.logsumexp(suffix_T[1:], dim=-2)
    S = torch.cat([S_inner, torch.zeros_like(S_inner[:1])], dim=0)
    return T, S, torch.logsumexp(T[-1], dim=-1)


def _forward_boundary_starts(init, A, T):
    """Per-chunk pre-emission start vectors in log space, (m, bP, q):
    ``log(init)`` for chunk 0, ``T[p-1]`` propagated through ``A`` after."""
    P, m, b, q = T.shape
    r_later = logmatmul(
        T[:-1][..., None, :], torch.log(_clamped(A))[None, :, None]
    )[..., 0, :]
    first = torch.log(_clamped(init))[:, None, :].expand(m, b, q)
    R0_log = torch.cat([first[None], r_later], dim=0)  # (P, m, b, q)
    return R0_log.movedim(0, 2).reshape(m, b * P, q)


def _forward_outputs(init, A, E, T, parallel_factor):
    """Output pass: exact log-forward at every position from boundary values."""
    m, b, L, q = E.shape
    Ec, c = _split_chunks(E, parallel_factor)
    Et = Ec.movedim(2, 0)  # (c, m, bP, q)

    R0_log = _forward_boundary_starts(init, A, T)
    ll = torch.logsumexp(R0_log, dim=-1)  # (m, bP)
    r0 = torch.exp(R0_log - ll[..., None])

    s = _clamped(Et[0]) * _clamped(r0)
    z = s.sum(-1, keepdim=True)
    alpha, ll = s / z, ll + torch.log(z[..., 0])
    outs = [torch.log(alpha) + ll[..., None]]
    for t in range(1, c):
        s = _clamped(Et[t]) * _clamped(torch.matmul(alpha, A))
        z = s.sum(-1, keepdim=True)
        alpha, ll = s / z, ll + torch.log(z[..., 0])
        outs.append(torch.log(alpha) + ll[..., None])
    return torch.stack(outs, dim=2).reshape(m, b, L, q)


def _backward_outputs(A, E, S, parallel_factor):
    """Output pass: exact log-backward at every position from boundary values."""
    m, b, L, q = E.shape
    P = parallel_factor
    Ec, c = _split_chunks(E, P)
    Et = Ec.movedim(2, 0)  # (c, m, bP, q)

    # Right-boundary beta per chunk (at the chunk's last position).
    S_flat = S.movedim(0, 2).reshape(m, b * P, q)
    ll = S_flat.amax(-1)
    beta = torch.exp(S_flat - ll[..., None])
    A_T = A.transpose(-1, -2)
    outs = [torch.log(beta) + ll[..., None]]
    for t in range(c - 1, 0, -1):  # consume e_t, produce beta_{t-1}
        s = _clamped(torch.matmul(_clamped(Et[t]) * beta, A_T))
        z = s.amax(-1, keepdim=True)
        beta, ll = s / z, ll + torch.log(z[..., 0])
        outs.append(torch.log(beta) + ll[..., None])
    return torch.stack(outs[::-1], dim=2).reshape(m, b, L, q)


def _posterior_chunked_plain(init, A, E, P, no_loglik):
    C, _ = _chunk_summaries(A, E, P)
    T, S, ll = _boundary_values(init, C)
    log_gamma = _forward_outputs(init, A, E, T, P) + _backward_outputs(A, E, S, P)
    if not no_loglik:
        log_gamma = log_gamma - ll[..., None, None]
    return log_gamma, ll


def _forward_boundaries(init, C):
    """Prefix-only fold of the chunk operators: ``T`` (P, m, b, q), for
    callers that need no backward direction."""
    log_init = torch.log(_clamped(init))
    m, b = C.shape[1:3]
    v = log_init[:, None].expand(m, b, log_init.shape[-1])
    T = []
    for C_p in C:
        v = logmatvec(v, C_p)
        T.append(v)
    return torch.stack(T)


def _loglik_from_C(init, C):
    return torch.logsumexp(_forward_boundaries(init, C)[-1], dim=-1)


# ---------------------------------------------------------------------------
# Kernel route (K1–K3): the chunk-element lane layout around the kernels
# ---------------------------------------------------------------------------


def _use_kernels(E) -> bool:
    """The kernels run where the tensors are on CUDA and q fits a thread's
    registers (the JAX gate ``_use_pallas`` at q <= 16, on a TPU)."""
    return E.is_cuda and E.shape[-1] <= cuda_forward.KERNEL_MAX_Q


def _kernel_chunk_inputs(E, P):
    """Emissions in the kernels' (m, c, q, R) layout, clamped to >= EPS;
    lanes are b-major, chunk-minor."""
    Ec, _ = _split_chunks(E, P)  # (m, bP, c, q)
    return _clamped(Ec).permute(0, 2, 3, 1).contiguous()


def _chunk_summaries_kernels(A, E_T, P, b):
    """K1 over all models, as (P, m, b, q, q)."""
    m, _, q, _ = E_T.shape
    C = cuda_forward.sum_chunk_summaries(A, E_T, P)  # (m, R, q, q)
    return C.reshape(m, b, P, q, q).movedim(2, 0)


def _lanes_to_mblq(x, b):
    """(m, c, q, R) -> (m, b, L, q); lanes are b-major, chunk-minor."""
    m, c, q, R = x.shape
    P = R // b
    return x.reshape(m, c, q, b, P).permute(0, 3, 4, 1, 2).reshape(m, b, P * c, q)


def _posterior_chunked_kernels(init, A, E, P, no_loglik):
    m, b, L, q = E.shape
    R = b * P
    A = A.contiguous()
    E_T = _kernel_chunk_inputs(E, P)
    C = _chunk_summaries_kernels(A, E_T, P, b)
    T, S, ll = _boundary_values(init, C)

    R0_log = _forward_boundary_starts(init, A, T)  # (m, R, q)
    ll0 = torch.logsumexp(R0_log, dim=-1)
    r0 = torch.exp(R0_log - ll0[..., None])
    log_alpha = cuda_forward.sum_fwd_outputs(
        A, E_T, r0.transpose(-1, -2).contiguous(), ll0.contiguous()
    )

    # Backward boundary starts (same construction as _backward_outputs).
    S_flat = S.movedim(0, 2).reshape(m, R, q)
    ll0b = S_flat.amax(-1)
    beta0 = torch.exp(S_flat - ll0b[..., None])
    log_beta = cuda_forward.beta_bwd_outputs(
        A, E_T, beta0.transpose(-1, -2).contiguous(), ll0b.contiguous()
    )

    # Posterior combine outside the kernels, as in the JAX package.
    log_gamma = log_alpha + log_beta  # (m, c, q, R)
    if not no_loglik:
        ll_lane = ll[..., None].expand(m, b, P).reshape(m, R)
        log_gamma = log_gamma - ll_lane[:, None, None, :]
    return _lanes_to_mblq(log_gamma, b), ll


def _chunk_summaries_dispatch(A, E, P):
    if _use_kernels(E):
        b = E.shape[1]
        return _chunk_summaries_kernels(A.contiguous(), _kernel_chunk_inputs(E, P), P, b)
    return _chunk_summaries(A, E, P)[0]


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def recommended_parallel_factor(
    L: int, q: int, m: int = 1, for_viterbi: bool = False
) -> int:
    """The ``parallel_factor`` to use per shape; a divisor of ``L``.

    Copied unchanged from the JAX package, together with the q <= 16
    kernel gate: both were tuned from TPU v5e measurements (chunk length
    ~300 at q <= 16, ~340 for 16 < q <= 64 at m == 1, sequential above),
    not on an H100. Retune them only from H100 numbers.
    """
    if for_viterbi and q > cuda_forward.KERNEL_MAX_Q:
        return 1
    if q <= cuda_forward.KERNEL_MAX_Q:
        target_c = 300
    elif q <= 64 and m == 1 and not for_viterbi:
        target_c = 340
    else:
        return 1
    best, best_err = 1, abs(L - target_c)
    d = 1
    while d * d <= L:
        if L % d == 0:
            for p in (d, L // d):
                err = abs(L / p - target_c)
                if err < best_err:
                    best, best_err = p, err
        d += 1
    return best


def forward(init, A, E, parallel_factor: int = 1) -> ForwardResult:
    """Forward algorithm: per-position ``log P(x_{1..t}, s_t)`` and the
    per-sequence log-likelihood."""
    if parallel_factor == 1:
        return ForwardResult(*_forward_seq(init, A, E))
    C = _chunk_summaries_dispatch(A, E, parallel_factor)
    T, _, ll = _boundary_values(init, C)
    return ForwardResult(_forward_outputs(init, A, E, T, parallel_factor), ll)


def backward(init, A, E, parallel_factor: int = 1) -> torch.Tensor:
    """Backward algorithm: ``log_beta[t, i] = log P(x_{t+1..L} | s_t = i)``."""
    if parallel_factor == 1:
        return _backward_seq(A, E)
    C = _chunk_summaries_dispatch(A, E, parallel_factor)
    _, S, _ = _boundary_values(init, C)
    return _backward_outputs(A, E, S, parallel_factor)


def log_likelihood(init, A, E, parallel_factor: int = 1) -> torch.Tensor:
    """Per-sequence log-likelihood ``log P(x_{1..L})``, shape (m, b)."""
    if parallel_factor == 1:
        return _forward_seq(init, A, E)[1]
    return _loglik_from_C(init, _chunk_summaries_dispatch(A, E, parallel_factor))


def posterior(init, A, E, parallel_factor: int = 1, no_loglik: bool = False):
    """State posterior log-probabilities ``log P(s_t = j | x)``.

    With ``no_loglik`` the loglik normalisation is skipped (log alpha +
    log beta). Returns (log_gamma (m, b, L, q), loglik (m, b)).
    """
    if parallel_factor == 1:
        la, ll = _forward_seq(init, A, E)
        log_gamma = la + _backward_seq(A, E)
        if not no_loglik:
            log_gamma = log_gamma - ll[..., None, None]
        return log_gamma, ll
    if _use_kernels(E):
        return _posterior_chunked_kernels(init, A, E, parallel_factor, no_loglik)
    return _posterior_chunked_plain(init, A, E, parallel_factor, no_loglik)
