"""Core HMM recursions: forward, backward, posterior, log-likelihood and
Viterbi decoding.

Port of ``hmm_layer_tpu/ops/recursion.py`` (the sum-product functions of
the posterior-serving path and the max-plus decode). ``parallel_factor``
P > 1 runs the chunked two-pass engine:

* **Summary pass** — every chunk of every sequence runs with a ``q x q``
  row-scaled carry, giving transfer operators ``C_p[i, j] = log P(chunk-p
  emissions, right-border state j | left-border state i)``.
* **Boundary combine** — the operators are folded into exact forward and
  backward values at every chunk boundary.
* **Output pass** — each chunk re-runs a ``q``-vector recursion from its
  boundary value.

On a CUDA tensor with q <= 16 the summary and output passes are the CUDA
kernels K1–K3 (:mod:`.cuda_forward`) and, for :func:`viterbi`, K6–K8
(:mod:`.cuda_viterbi`), as the JAX package runs its Pallas kernels on a
TPU (``_use_pallas``); everywhere else the plain chunked version below
runs. The boundary combine, the chunk-level backtrace and the posterior
combine are plain torch ops in both.

Shapes: ``init`` (m, q), ``A`` (m, q, q), ``E`` (m, b, L, q), all linear
space; outputs are log space. Gradients: the plain paths are differentiable
by autograd; the kernel path raises in backward (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_forward, cuda_viterbi
from .semiring import EPS, logmatmul, logmatvec, maxargmatvec, maxmatmul

__all__ = [
    "forward",
    "backward",
    "posterior",
    "log_likelihood",
    "viterbi",
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
# Viterbi: sequential, and the chunked max-plus two-pass engine
# ---------------------------------------------------------------------------

# Sentinel for impossible paths in the tropical semiring: it must never win
# an argmax against a real path score, including paths of clamped-EPS steps
# over long chunks. A finite Python float, never -inf.
_NEG = cuda_viterbi.NEG


def _viterbi_seq(init, A, E):
    """Max-plus Viterbi with backpointers. Returns paths (m, b, L) int32."""
    log_A = torch.log(_clamped(A))
    log_E = torch.log(_clamped(E))
    log_init = torch.log(_clamped(init))
    L = E.shape[2]
    delta = log_init[:, None, :] + log_E[:, :, 0]  # (m, b, q)
    backptrs = []
    for t in range(1, L):
        best, arg = maxargmatvec(delta, log_A[:, None])
        delta = best + log_E[:, :, t]
        backptrs.append(arg)
    state = delta.argmax(dim=-1)  # (m, b)
    path = [state]
    for bp in reversed(backptrs):
        state = torch.gather(bp, -1, state[..., None])[..., 0]
        path.append(state)
    return torch.stack(path[::-1], dim=-1).to(torch.int32)


def _viterbi_chunk_summaries(log_A, Et, P):
    """Plain max-plus chunk transfer operators in the TRANSPOSED convention
    ``C_T[p, m, b, j, i] = C_p[i, j]``, as (P, m, b, q, q).

    ``Et`` (c, m, bP, q) log emissions. The first step is the identity
    (0 / ``_NEG``) for chunk 0 of a sequence and log A's rows otherwise; no
    rescaling: each step is exact up to one rounded add per term.
    """
    c, m, R, q = Et.shape
    b = R // P
    log_A_T = log_A.transpose(-1, -2)
    eye = torch.full((q, q), _NEG, dtype=Et.dtype, device=Et.device)
    eye.fill_diagonal_(0.0)
    is_first = (torch.arange(R, device=Et.device) % P == 0)[None, :, None, None]
    M_T = torch.where(is_first, eye, log_A_T[:, None]) + Et[0][..., None]
    for t in range(1, c):
        M_T = maxmatmul(log_A_T[:, None], M_T) + Et[t][..., None]
    return M_T.reshape(m, b, P, q, q).movedim(2, 0)


def _viterbi_boundaries(log_v, C_T):
    """Max-plus forward values at every chunk's last position, (P, m, b, q):
    ``T[p](j)`` is the best score of a path up to the end of chunk ``p``
    ending in ``j``. ``log_v`` is the start vector, (m, q) or (m, b, q).

    A sequential vector fold for P <= 64, a log-depth prefix product above.
    """
    P, m, b, q = C_T.shape[:4]
    if log_v.dim() == 2:
        log_v = log_v[:, None]  # (m, 1, q): broadcast over the batch
    if P <= 64:
        v = log_v.expand(m, b, q)
        T = []
        for C_T_p in C_T:
            # v_new[j] = max_i v[i] + C_p[i, j] = max_i C_T_p[j, i] + v[i].
            v = (C_T_p + v[..., None, :]).amax(dim=-1)
            T.append(v)
        return torch.stack(T)
    # prefix_T[p] = (C_0 ∘ … ∘ C_p)^T = C_p^T ∘ … ∘ C_0^T, by doubling.
    Y, d = C_T, 1
    while d < P:
        Y = torch.cat([Y[:d], maxmatmul(Y[d:], Y[:-d])], dim=0)
        d *= 2
    return (Y + log_v[None, :, :, None, :]).amax(dim=-1)


def _boundary_backtrace(T, C_T, j_last=None):
    """The optimal path's state at the last position of every chunk,
    (P, m, b) int64.

    A positionwise ``argmax(delta + psi)`` decode is exact only in exact
    arithmetic: at |score| ~ L in float32 independent roundings splice
    states of different near-optimal paths into invalid transitions. A
    backtrace always returns one valid optimal path, so the decode is this
    chunk-level backtrace followed by within-chunk backtraces from stored
    deltas. ``j_last`` (m, b) fixes the last chunk's end state; by default
    ``argmax(T[-1])``. Row ``j`` of ``C_T`` is taken by indexing, which is
    exact.
    """
    P, m, b, q = T.shape
    j = T[-1].argmax(dim=-1) if j_last is None else j_last.long()
    out = [j]
    for p in range(P - 2, -1, -1):
        row = torch.gather(C_T[p + 1], -2, j[..., None, None].expand(m, b, 1, q))[..., 0, :]
        j = (T[p] + row).argmax(dim=-1)
        out.append(j)
    return torch.stack(out[::-1])


def _conditional_viterbi_starts(first_start_log, log_A, j_end):
    """Per-chunk conditional start vectors and decoded chunk-end states.

    Returns ``r0`` (m, bP, q): chunk 0 starts from ``first_start_log``
    (m, b, q), chunk p > 0 from the row ``log_A[j_end[p-1], :]``
    (conditioning on the decoded border state keeps every splice a real
    transition); and ``last_state`` (m, bP) int64.
    """
    P, m, b = j_end.shape
    q = log_A.shape[-1]
    models = torch.arange(m, device=log_A.device)[None, :, None]
    r_later = log_A[models, j_end[:-1]]  # (P-1, m, b, q): log_A[j_end, :]
    r0 = torch.cat([first_start_log[None], r_later], dim=0).movedim(0, 2).reshape(m, b * P, q)
    last_state = j_end.movedim(0, 2).reshape(m, b * P)
    return r0, last_state


def _viterbi_outputs(first_start_log, log_A, Et, j_end, P):
    """Conditional delta passes and within-chunk backtraces (plain route).

    ``first_start_log`` (m, b, q) is chunk 0's pre-emission start; ``Et``
    (c, m, bP, q) log emissions; ``j_end`` (P, m, b) the decoded state at
    each chunk's end. Returns paths (m, b, L) int32.
    """
    c, m, R, q = Et.shape
    b = R // P
    r0, state = _conditional_viterbi_starts(first_start_log, log_A, j_end)
    delta = r0 + Et[0]
    deltas = [delta]
    for t in range(1, c):
        delta = maxmatmul(delta[..., None, :], log_A[:, None])[..., 0, :] + Et[t]
        deltas.append(delta)

    log_A_T = log_A.transpose(-1, -2)
    models = torch.arange(m, device=log_A.device)[:, None]
    states = [state]
    for t in range(c - 2, -1, -1):
        state = (deltas[t] + log_A_T[models, state]).argmax(dim=-1)  # + A[:, state]
        states.append(state)
    states = torch.stack(states[::-1], dim=-1)  # (m, bP, c)
    return states.reshape(m, b, P * c).to(torch.int32)


def _viterbi_chunked_plain(init, A, E, P):
    """Chunked Viterbi, plain route: summaries, boundary fold, chunk-level
    backtrace, conditional delta passes and within-chunk backtraces."""
    m, b, L, q = E.shape
    log_init, log_A = torch.log(_clamped(init)), torch.log(_clamped(A))
    Ec, _ = _split_chunks(torch.log(_clamped(E)), P)  # (m, bP, c, q)
    Et = Ec.movedim(2, 0)  # (c, m, bP, q)
    C_T = _viterbi_chunk_summaries(log_A, Et, P)
    T = _viterbi_boundaries(log_init, C_T)
    j_end = _boundary_backtrace(T, C_T)
    first_start = log_init[:, None, :].expand(m, b, q)
    return _viterbi_outputs(first_start, log_A, Et, j_end, P)


def _viterbi_chunked_kernels(init, A, E, P):
    """Chunked Viterbi, kernel route: K6 summaries, the plain boundary fold
    and chunk-level backtrace, then K7 + K8 from the conditional starts."""
    m, b, L, q = E.shape
    log_init, log_A = torch.log(_clamped(init)), torch.log(_clamped(A)).contiguous()
    log_E_T = torch.log(_kernel_chunk_inputs(E, P))  # (m, c, q, R)
    C_T = cuda_viterbi.maxplus_chunk_summaries(log_A, log_E_T, P)  # (m, R, q, q)
    C_T = C_T.reshape(m, b, P, q, q).movedim(2, 0)
    T = _viterbi_boundaries(log_init, C_T)
    j_end = _boundary_backtrace(T, C_T)
    first_start = log_init[:, None, :].expand(m, b, q)
    r0, last_state = _conditional_viterbi_starts(first_start, log_A, j_end)
    delta0 = (r0.transpose(-1, -2) + log_E_T[:, 0]).contiguous()  # (m, q, R)
    states = cuda_viterbi.maxplus_decode(
        log_A, log_E_T, delta0, last_state.to(torch.int32).contiguous()
    )  # (m, c, R)
    return states.transpose(-1, -2).reshape(m, b, L)


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


@torch.no_grad()
def viterbi(init, A, E, parallel_factor: int = 1) -> torch.Tensor:
    """Most likely state path, shape (m, b, L) int32.

    ``parallel_factor == 1`` runs the sequential max-plus scan with
    backpointers; ``parallel_factor > 1`` the chunked max-plus engine — a
    chunk-level backtrace over the transfer operators, then per-chunk
    conditional delta passes and within-chunk backtraces — which always
    returns one valid optimal path. On a CUDA tensor with q <= 16 the
    chunked engine runs the kernels K6–K8.

    Engine parity: when distinct paths tie within float32 rounding
    (inevitable at |score| ~ L for dense emissions), engines may break the
    tie differently; the paths' true scores then agree to ~1e-7 relative.

    Routing for 16 < q <= 64: the JAX package sends these shapes on a TPU
    to its blocked sequential Pallas kernels (K7b/K8b) whatever the
    ``parallel_factor``. Those are not ported yet (ROADMAP Queue 2), so the
    port routes them as the JAX package does off the TPU: the sequential
    scan for ``parallel_factor == 1``, the plain chunked engine above.
    Decoding has no gradient; it runs under ``torch.no_grad``.
    """
    if parallel_factor == 1:
        return _viterbi_seq(init, A, E)
    if _use_kernels(E):
        return _viterbi_chunked_kernels(init, A, E, parallel_factor)
    return _viterbi_chunked_plain(init, A, E, parallel_factor)
