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
combine are plain torch ops in both. At 16 < q <= 64 on CUDA,
:func:`viterbi` runs the sequential decode through the blocked kernels
K7b/K8b whatever the ``parallel_factor``; at 16 < q <= 128 the summary
pass of the log-likelihood, ``forward`` and ``backward`` runs K9
(:mod:`.cuda_mxu`) when its opt-in gate ``HMM_PALLAS_MXU=1`` is set, as in
the JAX package. At 64 < q <= 704 on CUDA the sequential log-likelihood
(``parallel_factor == 1``) and its VJP run their passes through K2c and K3c
(:func:`.cuda_forward.sum_forward_wide`, :func:`.cuda_forward.sum_backward_wide`),
one launch a pass; the JAX package leaves those scans to XLA.

Gradients at ``parallel_factor`` > 1 come from analytic VJPs
(``torch.autograd.Function``s, the JAX ``custom_vjp``\\ s), not from taping
the O(L·q²) summary carries: Baum-Welch statistics for the log-likelihood,
and chunked affine adjoint solves (:func:`_chunked_affine_reverse`; on CUDA
at q <= 15 the kernels K4–K5 of :mod:`.cuda_adjoint`) for ``forward``,
``backward`` and ``posterior``. ``parallel_factor == 1`` is differentiated
by autograd, except the log-likelihood, which has its analytic VJP there
too (``analytic_vjp=True``).

Shapes: ``init`` (m, q), ``A`` (m, q, q), ``E`` (m, b, L, q), all linear
space; outputs are log space.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.profiling import span
from . import cuda_adjoint, cuda_forward, cuda_mxu, cuda_viterbi
from .semiring import EPS, logmatmul, logmatvec, maxmatmul

__all__ = [
    "forward",
    "backward",
    "posterior",
    "log_likelihood",
    "viterbi",
    "recommended_parallel_factor",
    "ForwardResult",
    "set_dp_precision",
    "dp_precision",
]

# The JAX package's DP-einsum precision modes ("high": 3-pass bf16 on a
# TPU, "highest": 6-pass float32). Here every mode computes in IEEE
# float32: the recursions run no TF32 (``torch.set_float32_matmul_precision
# ("highest")`` at import), and a reduced mode is mapped only once an H100
# log-likelihood error measurement backs it. The mode is recorded and
# returned, so callers written for the JAX API (``align --precision``) run.
_DP_MODES = ("highest", "high", "default")
_dp_mode = "highest"


def set_dp_precision(mode: str) -> str:
    """Set the DP precision mode ('highest' | 'high' | 'default'); returns
    the previous mode's name. Every mode computes exactly what 'highest'
    computes (IEEE float32, no TF32)."""
    global _dp_mode
    mode = mode.lower()
    if mode not in _DP_MODES:
        raise KeyError(mode)
    prev, _dp_mode = _dp_mode, mode
    return prev


class dp_precision:
    """Context manager form of :func:`set_dp_precision`."""

    def __init__(self, mode: str):
        self.mode = mode

    def __enter__(self):
        self._prev = set_dp_precision(self.mode)
        return self

    def __exit__(self, *exc):
        set_dp_precision(self._prev)
        return False


class ForwardResult(NamedTuple):
    log_alpha: torch.Tensor  # (m, b, L, q) — log P(x_{1..t}, s_t = j)
    log_lik: torch.Tensor  # (m, b) — log P(x_{1..L})


def _clamped(x):
    return torch.clamp_min(x, EPS)


# ---------------------------------------------------------------------------
# Sequential (parallel_factor == 1) recursions
# ---------------------------------------------------------------------------


def _forward_seq(init, A, E):
    """Scaled sequential forward. Returns (log_alpha (m,b,L,q), loglik (m,b)):
    the loop of K2c's plain version."""
    return cuda_forward.sum_forward_wide_plain(init, A, E, True)


def _backward_seq(A, E):
    """Scaled sequential backward. Returns log_beta (m, b, L, q): the loop
    of K3c's plain version."""
    return cuda_forward.sum_backward_wide_plain(A, E)


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


def _chunk_summaries(A, E, parallel_factor, first_chunk_identity=True):
    """Summary pass: per-chunk transfer operators, (P, m, b, q, q).

    The left border is the state at the chunk's first position for chunk 0
    (identity start) and the state at the last position of the previous
    chunk otherwise (transition-applied start). ``first_chunk_identity=False``
    gives chunk 0 the transition-applied start too: sequence-sharded callers
    pass ``rank index == 0`` so that only the globally first block starts
    from the identity.
    """
    m, b, L, q = E.shape
    P = parallel_factor
    Ec, c = _split_chunks(E, P)
    Et = Ec.movedim(2, 0)  # (c, m, bP, q)
    eye = torch.eye(q, dtype=E.dtype, device=E.device)
    is_first = ((torch.arange(P, device=E.device) == 0) & bool(first_chunk_identity)).to(E.dtype)
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


def _forward_boundary_starts(init, A, T, first_start_log=None):
    """Per-chunk pre-emission start vectors in log space, (m, bP, q):
    ``log(init)`` for chunk 0 (or ``first_start_log`` (m, b, q) —
    sequence-sharded callers pass the boundary value entering their block
    propagated through ``A``), ``T[p-1]`` propagated through ``A`` after."""
    P, m, b, q = T.shape
    r_later = logmatmul(
        T[:-1][..., None, :], torch.log(_clamped(A))[None, :, None]
    )[..., 0, :]
    if first_start_log is None:
        first_start_log = torch.log(_clamped(init))[:, None, :].expand(m, b, q)
    R0_log = torch.cat([first_start_log[None], r_later], dim=0)  # (P, m, b, q)
    return R0_log.movedim(0, 2).reshape(m, b * P, q)


def _forward_outputs(init, A, E, T, parallel_factor, first_start_log=None):
    """Output pass: exact log-forward at every position from boundary values
    (chunk 0 from ``first_start_log`` when given, see
    :func:`_forward_boundary_starts`)."""
    m, b, L, q = E.shape
    Ec, c = _split_chunks(E, parallel_factor)
    Et = Ec.movedim(2, 0)  # (c, m, bP, q)

    R0_log = _forward_boundary_starts(init, A, T, first_start_log)
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
    """(log_gamma, loglik, log_alpha); log alpha is the VJP's residual."""
    C, _ = _chunk_summaries(A, E, P)
    T, S, ll = _boundary_values(init, C)
    la = _forward_outputs(init, A, E, T, P)
    log_gamma = la + _backward_outputs(A, E, S, P)
    if not no_loglik:
        log_gamma = log_gamma - ll[..., None, None]
    return log_gamma, ll, la


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


def _alpha_kernels(init, A, E_T, T):
    """K2: log alpha (m, c, q, R) from the boundary values, with the starts
    built as :func:`_forward_outputs` builds them. ``A`` contiguous."""
    R0_log = _forward_boundary_starts(init, A, T)  # (m, R, q)
    ll0 = torch.logsumexp(R0_log, dim=-1)
    r0 = torch.exp(R0_log - ll0[..., None])
    return cuda_forward.sum_fwd_outputs(A, E_T, r0.transpose(-1, -2).contiguous(), ll0.contiguous())


def _beta_kernels(A, E_T, S):
    """K3: log beta (m, c, q, R) from the boundary values, with the starts
    built as :func:`_backward_outputs` builds them. ``A`` contiguous."""
    P, m, b, q = S.shape
    S_flat = S.movedim(0, 2).reshape(m, b * P, q)
    ll0 = S_flat.amax(-1)
    beta0 = torch.exp(S_flat - ll0[..., None])
    return cuda_forward.beta_bwd_outputs(A, E_T, beta0.transpose(-1, -2).contiguous(), ll0.contiguous())


def _outputs_kernels(init, A, E_T, T, S):
    """K2 and K3: log alpha and log beta (m, c, q, R)."""
    return _alpha_kernels(init, A, E_T, T), _beta_kernels(A, E_T, S)


def _posterior_chunked_kernels(init, A, E, P, no_loglik):
    """(log_gamma, loglik, log_alpha) through K1–K3; log alpha is the
    VJP's residual, as in the JAX Pallas route."""
    m, b, L, q = E.shape
    R = b * P
    A = A.contiguous()
    E_T = _kernel_chunk_inputs(E, P)
    C = _chunk_summaries_kernels(A, E_T, P, b)
    T, S, ll = _boundary_values(init, C)
    log_alpha, log_beta = _outputs_kernels(init, A, E_T, T, S)

    # Posterior combine outside the kernels, as in the JAX package.
    log_gamma = log_alpha + log_beta  # (m, c, q, R)
    if not no_loglik:
        ll_lane = ll[..., None].expand(m, b, P).reshape(m, R)
        log_gamma = log_gamma - ll_lane[:, None, None, :]
    return _lanes_to_mblq(log_gamma, b), ll, _lanes_to_mblq(log_alpha, b)


def _posterior_chunked_primal(init, A, E, P, no_loglik):
    if _use_kernels(E):
        return _posterior_chunked_kernels(init, A, E, P, no_loglik)
    return _posterior_chunked_plain(init, A, E, P, no_loglik)


def _chunked_values(init, A, E, C, P):
    """(log_alpha, log_beta, loglik) at every position from the chunk
    operators ``C``: K2 and K3 on CUDA at q <= 16 (the JAX package runs
    its plain output scans here), the plain output passes elsewhere."""
    T, S, ll = _boundary_values(init, C)
    if _use_kernels(E):
        b = E.shape[1]
        la, lb = _outputs_kernels(init, A.contiguous(), _kernel_chunk_inputs(E, P), T, S)
        return _lanes_to_mblq(la, b), _lanes_to_mblq(lb, b), ll
    return _forward_outputs(init, A, E, T, P), _backward_outputs(A, E, S, P), ll


def _forward_values(init, A, E, T, P):
    """log alpha (m, b, L, q) from the boundary values ``T``: K2 on CUDA at
    q <= 16 (the JAX package runs its plain output scan here), the plain
    output pass elsewhere."""
    if _use_kernels(E):
        la = _alpha_kernels(init, A.contiguous(), _kernel_chunk_inputs(E, P), T)
        return _lanes_to_mblq(la, E.shape[1])
    return _forward_outputs(init, A, E, T, P)


def _backward_values(A, E, S, P):
    """log beta (m, b, L, q) from the boundary values ``S``: K3 on CUDA at
    q <= 16, the plain output pass elsewhere."""
    if _use_kernels(E):
        lb = _beta_kernels(A.contiguous(), _kernel_chunk_inputs(E, P), S)
        return _lanes_to_mblq(lb, E.shape[1])
    return _backward_outputs(A, E, S, P)


def _use_mxu_kernel(E) -> bool:
    """K9 runs where its opt-in gate is set, 16 < q <= 128 and the tensors
    are on CUDA (the JAX gate: ``pallas_mxu.MXU_KERNELS``,
    ``mxu_supported`` and a TPU)."""
    return cuda_mxu.MXU_KERNELS and cuda_mxu.mxu_supported(E.shape[-1]) and E.is_cuda


def _chunk_summaries_mxu(A, E, P):
    """K9 over all models, as (P, m, b, q, q); emissions clamped to >= EPS
    in K9's (m, c, R, q) layout, states last."""
    m, b, L, q = E.shape
    Ec, _ = _split_chunks(_clamped(E), P)  # (m, bP, c, q)
    C = cuda_mxu.sum_chunk_summaries_mxu(A.contiguous(), Ec.transpose(1, 2).contiguous(), P)
    return C.reshape(m, b, P, q, q).movedim(2, 0)


def _chunk_summaries_dispatch(A, E, P):
    """Chunk operators (P, m, b, q, q) for the log-likelihood, ``forward``
    and ``backward``: K1, else K9 behind its gate, else the plain pass."""
    if _use_kernels(E):
        b = E.shape[1]
        return _chunk_summaries_kernels(A.contiguous(), _kernel_chunk_inputs(E, P), P, b)
    if _use_mxu_kernel(E):
        return _chunk_summaries_mxu(A, E, P)
    return _chunk_summaries(A, E, P)[0]


# ---------------------------------------------------------------------------
# Analytic gradients: adjoint weights and the chunked affine solver
# ---------------------------------------------------------------------------


def _forward_adjoint_weights(la, log_E):
    """(u, v) diagonals of the log-forward adjoint maps ``diag(u) A diag(v)``.

    ``v`` (gbar) is pre-shifted by one step and zeroed at t = L-1 (terminal
    condition x_L = 0). These softmax-weight constructions are the
    numerically sensitive core of every analytic VJP — keep single-sourced.
    """
    m, b, L, q = la.shape
    s = la.amax(-1, keepdim=True)
    f = torch.exp(la - s)
    gbar = torch.cat(
        [
            torch.exp(log_E[:, :, 1:] + s[:, :, :-1] - la[:, :, 1:]),
            torch.zeros((m, b, 1, q), dtype=la.dtype, device=la.device),
        ],
        dim=2,
    )
    return f, gbar


def _backward_adjoint_weights(lb, log_E):
    """(u, v) diagonals of the log-backward adjoint maps (time-flipped use).

    Returns (fp, gp, sp, elb); ``fp`` is zero at t = 0.
    """
    m, b, L, q = lb.shape
    elb = log_E + lb
    sp = elb.amax(-1, keepdim=True)
    fp = torch.cat(
        [
            torch.zeros((m, b, 1, q), dtype=lb.dtype, device=lb.device),
            torch.exp(sp[:, :, 1:] - lb[:, :, :-1]),
        ],
        dim=2,
    )
    gp = torch.exp(elb - sp)
    return fp, gp, sp, elb


def _forward_gA_factors(la, log_E):
    """Balanced-shift factors for the xi-style gA einsum of the la adjoint:
    ``gA = einsum(F, x[1:] * exp(log_E - la + csh)[1:])``."""
    csh = la[:, :, :-1].amax(-1, keepdim=True)
    F = torch.exp(la[:, :, :-1] - csh)

    def G_of(x):
        return x[:, :, 1:] * torch.exp(log_E[:, :, 1:] - la[:, :, 1:] + csh)

    return F, G_of, csh


def _backward_gA_factors(lb, sp, elb):
    """Balanced-shift factors for the gA einsum of the lb adjoint."""

    def Fp_of(x):
        return x[:, :, :-1] * torch.exp(sp[:, :, 1:] - lb[:, :, :-1])

    Gp = torch.exp(elb[:, :, 1:] - sp[:, :, 1:])
    return Fp_of, Gp


def _xi_sum(F, G):
    """``einsum("mbti,mbtj->mij")``: the Baum-Welch xi statistic."""
    return torch.einsum("mbti,mbtj->mij", F, G)


def _use_affine_kernels(x) -> bool:
    """K4–K5 run where the tensors are on CUDA and q + 1 <= 16 (the JAX
    gate ``pallas_adjoint.supported``, on a TPU)."""
    return x.is_cuda and cuda_adjoint.supported(x.shape[-1])


def _affine_lanes(x, P):
    """(m, b, L, q) -> (m, c, q, R), the kernels' lane layout; lanes are
    b-major, chunk-minor. No padding: the kernels mask the ragged block."""
    m, b, L, q = x.shape
    return x.reshape(m, b * P, L // P, q).permute(0, 2, 3, 1).contiguous()


def _affine_kernel_lanes(u, v, cvec, P):
    """(U, V, S): u, v and cvec in the kernels' lane layout, built once for
    K4 and K5."""
    return tuple(_affine_lanes(x, P) for x in (u, v, cvec))


def _affine_composites_kernels(B, lanes, b):
    """K4 over all models on the lanes (U, V, S), as (P, m, b, q, q+1)."""
    U, V, S = lanes
    m, _, q, R = U.shape
    comp = cuda_adjoint.affine_chunk_composites(B, U, V, S)  # (m, R, q, q+1)
    return comp.reshape(m, b, R // b, q, q + 1).movedim(2, 0)


def _affine_composites(B, u, v, cvec, P):
    """Per-chunk composite affine maps ``[K | o]`` of the reverse adjoint
    recursion; (P, m, b, q, q+1). The plain route (K4 is
    :func:`_affine_composites_kernels`)."""
    m, b, L, q = cvec.shape
    c = L // P

    def to_chunks(x):
        return x.reshape(m, b * P, c, q).movedim(2, 0)  # (c, m, bP, q)

    ut, vt, ctt = to_chunks(u), to_chunks(v), to_chunks(cvec)
    eye = torch.eye(q, dtype=cvec.dtype, device=cvec.device).expand(m, b * P, q, q)
    X = torch.cat([eye, torch.zeros((m, b * P, q, 1), dtype=cvec.dtype, device=cvec.device)], dim=-1)
    B_b = B[:, None]
    for t in range(c - 1, -1, -1):
        X = ut[t][..., None] * torch.matmul(B_b, vt[t][..., None] * X)
        X[..., -1] += ctt[t]
    return X.reshape(m, b, P, q, q + 1).movedim(2, 0)


def _affine_boundary_fold(comp, x_term):
    """Right-to-left fold over chunk composites from terminal ``x_term``.

    Returns ``rights`` (P, m, b, q): the adjoint entering each chunk's
    right edge (rights[P-1] = x_term).
    """
    q = comp.shape[-2]
    vb = x_term
    rights = [None] * comp.shape[0]
    for p in range(comp.shape[0] - 1, -1, -1):
        rights[p] = vb
        vb = comp[p][..., q] + torch.matmul(comp[p][..., :q], vb[..., None])[..., 0]
    return torch.stack(rights)


def _affine_outputs_kernels(B, lanes, b, rights):
    """K5 over all models on the lanes (U, V, S), as (m, b, L, q)."""
    U, V, S = lanes
    m, _, q, R = U.shape
    x_right = rights.movedim(0, 2).reshape(m, R, q).transpose(-1, -2).contiguous()
    out = cuda_adjoint.affine_reverse_outputs(B, U, V, S, x_right)
    return _lanes_to_mblq(out, b)


def _affine_outputs(B, u, v, cvec, P, rights):
    """Per-position adjoints from per-chunk right-edge values ``rights``
    (P, m, b, q). The plain route (K5 is :func:`_affine_outputs_kernels`)."""
    m, b, L, q = cvec.shape
    c = L // P

    def to_chunks(x):
        return x.reshape(m, b * P, c, q).movedim(2, 0)

    ut, vt, ctt = to_chunks(u), to_chunks(v), to_chunks(cvec)
    x = rights.movedim(0, 2).reshape(m, b * P, q)
    xs = [None] * c
    for t in range(c - 1, -1, -1):
        x = ctt[t] + ut[t] * torch.matmul(B[:, None], (vt[t] * x)[..., None])[..., 0]
        xs[t] = x
    return torch.stack(xs, dim=2).reshape(m, b, L, q)


def _chunked_affine_reverse(B, u, v, cvec, P, x_term=None):
    """Chunked solve of ``x_t = cvec_t + u_t * (B @ (v_t * x_{t+1}))``
    (terminal ``x_L = x_term``, default 0) — composites, boundary fold,
    output passes; K4–K5 on CUDA at q <= 15, on one lane layout of u, v and
    cvec."""
    m, b, _, q = cvec.shape
    if x_term is None:
        x_term = torch.zeros((m, b, q), dtype=cvec.dtype, device=cvec.device)
    if _use_affine_kernels(cvec):
        B, lanes = B.contiguous(), _affine_kernel_lanes(u, v, cvec, P)
        rights = _affine_boundary_fold(_affine_composites_kernels(B, lanes, b), x_term)
        return _affine_outputs_kernels(B, lanes, b, rights)
    rights = _affine_boundary_fold(_affine_composites(B, u, v, cvec, P), x_term)
    return _affine_outputs(B, u, v, cvec, P, rights)


# ---------------------------------------------------------------------------
# Analytic VJPs (the JAX custom_vjps as autograd Functions; reverse mode only)
# ---------------------------------------------------------------------------


def _loglik_bw_stats(init, A, E, la, lb, ll, ct):
    """Baum-Welch gradient statistics shared by the chunked and sequential
    analytic log-likelihood VJPs."""
    log_E = torch.log(_clamped(E))
    lgam = la + lb - ll[..., None, None]
    gE = torch.exp(lgam - log_E) * (E >= EPS) * ct[..., None, None]
    ginit = (
        (torch.exp(log_E[:, :, 0] + lb[:, :, 0] - ll[..., None]) * ct[..., None]).sum(1)
        * (init >= EPS)
    )
    # Expected transition statistics: shift each timestep by the row max of
    # log alpha so both einsum factors stay in float32 range (their product
    # is O(1); the factors alone would over/underflow at |ll| ~ L).
    cshift = la[:, :, :-1].amax(-1, keepdim=True)
    w = torch.exp(la[:, :, :-1] - cshift)
    u = torch.exp(lb[:, :, 1:] + log_E[:, :, 1:] - ll[..., None, None] + cshift) * ct[..., None, None]
    return ginit, _xi_sum(w, u), gE


# Save the chunk operators as VJP residuals when small (~1 MB at the
# flagship shape): the backward then skips the whole summary pass.
_LOGLIK_RESIDUAL_C_MAX_BYTES = 32 * 1024 * 1024


def _save_C(E, P):
    m, b, L, q = E.shape
    return P * m * b * q * q * 4 <= _LOGLIK_RESIDUAL_C_MAX_BYTES


class _LoglikChunked(torch.autograd.Function):
    """Chunked log-likelihood with an analytic (Baum-Welch) VJP.

    Autograd through the summary scan would tape the O(L·q²) operator
    carries; the analytic gradient needs one forward + one backward pass:

        dll/dE_t(j)  = gamma_t(j) / E_t(j)
        dll/dA(i,j)  = sum_t alpha_{t-1}(i) E_t(j) beta_t(j) / P(x)
        dll/dpi(i)   = E_0(i) beta_0(i) / P(x)

    with zero gradient where the init/E EPS clamps bind (A is not clamped
    by the recursion, so exact-zero transitions still receive their true
    nonzero gradient). On CUDA the backward's log alpha and log beta come
    from K2 and K3 (:func:`_chunked_values`).
    """

    @staticmethod
    def forward(ctx, init, A, E, P):
        C = _chunk_summaries_dispatch(A, E, P)
        ctx.P = P
        ctx.save_for_backward(init, A, E, C if _save_C(E, P) else None)
        return _loglik_from_C(init, C)

    @staticmethod
    @span("hmm.recursion.loglik_vjp")
    def backward(ctx, ct):
        init, A, E, C = ctx.saved_tensors
        if C is None:
            C = _chunk_summaries_dispatch(A, E, ctx.P)  # one pass serves both directions
        la, lb, ll = _chunked_values(init, A, E, C, ctx.P)
        return (*_loglik_bw_stats(init, A, E, la, lb, ll, ct), None)


def _use_wide_loglik_kernels(E) -> bool:
    """K2c and K3c take the sequential log-likelihood and its VJP for a CUDA
    float32 E at 64 < q <= ``cuda_forward.MAX_WIDE_Q`` (704): A in shared
    memory to q = 512, the register cut above (the kernel picks the cut
    from q; at q = 647, ~2.9 us a step on an H100)."""
    return (E.is_cuda and E.dtype == torch.float32
            and cuda_forward.MIN_WIDE_Q <= E.shape[-1] <= cuda_forward.MAX_WIDE_Q)


def _seq_passes(init, A, E):
    """The forward and backward passes of :class:`_LoglikSeq` and their
    inputs: K2c and K3c (contiguous inputs) where
    :func:`_use_wide_loglik_kernels`, else their plain versions."""
    if _use_wide_loglik_kernels(E):
        return (cuda_forward.sum_forward_wide, cuda_forward.sum_backward_wide,
                init.contiguous(), A.contiguous(), E.contiguous())
    return cuda_forward.sum_forward_wide_plain, cuda_forward.sum_backward_wide_plain, init, A, E


class _LoglikSeq(torch.autograd.Function):
    """Sequential log-likelihood with the analytic Baum-Welch VJP: one
    forward + one backward pass instead of a taped L-step scan. On CUDA at
    64 < q <= 704 the passes are K2c and K3c (:func:`_seq_passes`), one
    launch each (a MAP step of learnMSA's q = 647 models: three launches of
    ~6.8 ms for three 400-step loops of ~3,700 launches each). Under a
    profiler each forward pass opens the span
    ``hmm.recursion.loglik.alphas`` and the backward pass
    ``hmm.recursion.loglik.betas``."""

    @staticmethod
    def forward(ctx, init, A, E):
        ctx.save_for_backward(init, A, E)
        fwd, _, *args = _seq_passes(init, A, E)
        with span("hmm.recursion.loglik.alphas"):
            return fwd(*args, False)[1]

    @staticmethod
    @span("hmm.recursion.loglik_vjp")
    def backward(ctx, ct):
        init, A, E = ctx.saved_tensors
        fwd, bwd, *args = _seq_passes(init, A, E)
        with span("hmm.recursion.loglik.alphas"):
            la, ll = fwd(*args, True)
        with span("hmm.recursion.loglik.betas"):
            lb = bwd(*args[1:])
        return _loglik_bw_stats(init, A, E, la, lb, ll, ct)


class _ForwardChunked(torch.autograd.Function):
    """Chunked forward values with an analytic adjoint VJP.

    The adjoint of the log-forward recursion is one chunked affine solve
    over O(L·q) residuals. No gamma-centering is needed: without the
    loglik normalisation the adjoint's O(L) growth is the true gradient
    magnitude, representable in float32.
    """

    @staticmethod
    def forward(ctx, init, A, E, P):
        C = _chunk_summaries_dispatch(A, E, P)
        T, _, ll = _boundary_values(init, C)
        la = _forward_values(init, A, E, T, P)
        ctx.P = P
        ctx.save_for_backward(init, A, E, la, ll)
        return la, ll

    @staticmethod
    def backward(ctx, ct_la, ct_ll):
        init, A, E, la, ll = ctx.saved_tensors
        L = E.shape[2]
        log_E = torch.log(_clamped(E))
        # Fold the loglik cotangent into the terminal source:
        # ll = LSE(la_{L-1}) -> d ll / d la_{L-1} = softmax(la_{L-1}).
        src = ct_la.clone()
        src[:, :, L - 1] += ct_ll[..., None] * torch.exp(la[:, :, L - 1] - ll[..., None])
        f, gbar = _forward_adjoint_weights(la, log_E)
        bar = _chunked_affine_reverse(A, f, gbar, src, ctx.P)

        gE = bar / _clamped(E) * (E >= EPS)
        ginit = bar[:, :, 0].sum(1) / _clamped(init) * (init >= EPS)
        F, G_of, _ = _forward_gA_factors(la, log_E)
        return ginit, _xi_sum(F, G_of(bar)), gE, None


class _BackwardChunked(torch.autograd.Function):
    """Chunked backward values with an analytic adjoint VJP (see
    :class:`_ForwardChunked`)."""

    @staticmethod
    def forward(ctx, init, A, E, P):
        C = _chunk_summaries_dispatch(A, E, P)
        _, S, _ = _boundary_values(init, C)
        lb = _backward_values(A, E, S, P)
        ctx.P = P
        ctx.save_for_backward(init, A, E, lb)
        return lb

    @staticmethod
    def backward(ctx, ct):
        init, A, E, lb = ctx.saved_tensors
        log_E = torch.log(_clamped(E))
        fp, gp, sp, elb = _backward_adjoint_weights(lb, log_E)
        cb = _chunked_affine_reverse(
            A.transpose(-1, -2), gp.flip(2), fp.flip(2), ct.flip(2), ctx.P
        ).flip(2)
        gE = (cb - ct) / _clamped(E) * (E >= EPS)
        Fp_of, Gp = _backward_gA_factors(lb, sp, elb)
        return torch.zeros_like(init), _xi_sum(Fp_of(cb), Gp), gE, None


def _posterior_vjp_residuals(no_loglik, saved):
    """la, lb, ll for the adjoint pass, recovered from the saved primal
    outputs: lb = lg - la [+ ll]."""
    la, lg, ll = saved
    lb = lg - la
    if not no_loglik:
        lb = lb + ll[..., None, None]
    return la, lb, ll


def _posterior_analytic_vjp(init, A, E, P, no_loglik, ct, ct_ll_direct, saved):
    """Analytic VJP of the chunked posterior (chunked adjoint scans).

    ``log_gamma = la + lb [- ll]``; the pullbacks are assembled from two
    chunked affine adjoint solves over O(L·q) residuals, vs. taping the
    O(L·q²) summary-scan carries under autograd.

    Stability: the raw adjoints grow O(L) along the ``gamma`` direction
    (the adjoint maps are sum-preserving with ``M γ_{t+1} = γ_t`` /
    ``Nᵀ γ_{t-1} = γ_t`` as exact flow identities) and those parts cancel
    against the loglik-normalization pullback only at the very end — a
    catastrophic float32 cancellation at L ≳ 1000. So each adjoint is
    solved in the decomposition ``adjoint_t = γ_t · (cumulative scalar) +
    residual`` with a CENTERED source (zero-sum, preserved by the maps,
    hence bounded residuals); the scalar parts combine in closed form.
    """
    la, lb, ll = _posterior_vjp_residuals(no_loglik, saved)
    log_E = torch.log(_clamped(E))
    gam = torch.exp(la + lb - ll[..., None, None])  # (m, b, L, q)

    # Scalar bookkeeping (exact cumsums; no large-term cancellation is ever
    # evaluated numerically — see the closed forms below).
    sig = ct.sum(-1)  # (m, b, L)
    sig_tot = sig.sum(-1)  # (m, b)
    ct_ll_eff = ct_ll_direct if no_loglik else ct_ll_direct - sig_tot

    # --- centered adjoints of la and lb, solved as ONE batched call ---------
    # la adjoint: reverse-time with maps diag(f) A diag(gbar); the terminal
    # ll-fold adds ct_ll_eff * gamma_{L-1} to the source, whose centered
    # part is identically zero — it enters only via the scalar R below.
    m = E.shape[0]
    src = ct - gam * sig[..., None]  # centered (same for both adjoints)
    f, gbar = _forward_adjoint_weights(la, log_E)
    # lb adjoint: forward-time with maps diag(gp) A^T diag(fp) — a reverse
    # recursion on the flipped time axis. Stacking it as extra "models"
    # (B = [A; A^T]) halves the solve count and doubles the batch.
    fp, gp, sp, elb = _backward_adjoint_weights(lb, log_E)
    B2 = torch.cat([A, A.transpose(-1, -2)], dim=0)
    u2 = torch.cat([f, gp.flip(2)], dim=0)
    v2 = torch.cat([gbar, fp.flip(2)], dim=0)
    c2 = torch.cat([src, src.flip(2)], dim=0)
    x2 = _chunked_affine_reverse(B2, u2, v2, c2, P)
    bhat, chat = x2[:m], x2[m:].flip(2)
    # Project out numerical drift along the growing gamma mode: the exact
    # residuals have zero sum (the maps conserve the sum functional), so any
    # accumulated sum is float32 flow error riding the gamma direction.
    bhat = bhat - gam * bhat.sum(-1, keepdim=True)
    chat = chat - gam * chat.sum(-1, keepdim=True)
    # bar_t = gam_t * R_t + bhat_t with R_t = sum_{s>=t} sig_s + ct_ll_eff;
    # cb_t = gam_t * S_t + chat_t with S_t = sum_{s<=t} sig_s. R and S enter
    # only through the closed forms below (K, R0, kappa).

    # --- assemble ------------------------------------------------------------
    # bar + cb - ct = gam*(R + S) + bhat + chat - ct, with the closed form
    # R_t + S_t = sig_t + ct_ll_direct [+ sig_tot if no_loglik].
    K = sig + ct_ll_direct[..., None]
    if no_loglik:
        K = K + sig_tot[..., None]
    gE = (gam * K[..., None] + bhat + chat - ct) / _clamped(E) * (E >= EPS)

    # ginit: bar_0 with R_0 = sig_tot + ct_ll_eff.
    R0 = sig_tot + ct_ll_eff
    bar0 = gam[:, :, 0] * R0[..., None] + bhat[:, :, 0]
    ginit = bar0.sum(1) / _clamped(init) * (init >= EPS)

    # gA: the gamma parts of both adjoints reduce to the Baum-Welch xi
    # statistic weighted by the constant R_t + S_{t-1} = K_t - sig_t.
    kappa = ct_ll_direct + sig_tot if no_loglik else ct_ll_direct  # (m, b)
    F, G_of, csh = _forward_gA_factors(la, log_E)
    xi_u = (
        torch.exp(lb[:, :, 1:] + log_E[:, :, 1:] - ll[..., None, None] + csh)
        * kappa[..., None, None]
    )
    # Residual of the lb adjoint only — its gamma*S part is inside kappa.
    Fp_of, Gp = _backward_gA_factors(lb, sp, elb)
    gA = _xi_sum(F, xi_u + G_of(bhat)) + _xi_sum(Fp_of(chat), Gp)
    return ginit, gA, gE


class _PosteriorChunked(torch.autograd.Function):
    """Chunked posterior (K1–K3 on CUDA) with analytic gradients: the VJP
    runs chunked adjoint recursions (:func:`_posterior_analytic_vjp`) over
    residuals saved from the primal (log-forward comes out of the forward
    output pass; log-backward is recovered as ``lg - la [+ ll]``)."""

    @staticmethod
    def forward(ctx, init, A, E, P, no_loglik):
        lg, ll, la = _posterior_chunked_primal(init, A, E, P, no_loglik)
        ctx.P, ctx.no_loglik = P, no_loglik
        ctx.save_for_backward(init, A, E, la, lg, ll)
        return lg, ll

    @staticmethod
    @span("hmm.recursion.posterior_vjp")
    def backward(ctx, ct, ct_ll):
        init, A, E, la, lg, ll = ctx.saved_tensors
        grads = _posterior_analytic_vjp(
            init, A, E, ctx.P, ctx.no_loglik, ct, ct_ll, saved=(la, lg, ll)
        )
        return (*grads, None, None)


# ---------------------------------------------------------------------------
# Viterbi: sequential, and the chunked max-plus two-pass engine
# ---------------------------------------------------------------------------

# Sentinel for impossible paths in the tropical semiring: it must never win
# an argmax against a real path score, including paths of clamped-EPS steps
# over long chunks. A finite Python float, never -inf.
_NEG = cuda_viterbi.NEG


def _viterbi_seq(init, A, E, deltas=cuda_viterbi.maxplus_deltas_wide_plain,
                 backtrace=cuda_viterbi.maxplus_backtrace_wide_plain):
    """Max-plus Viterbi with backpointers. Returns paths (m, b, L) int32.

    The max-plus loop and the pointer walk are ``deltas`` and
    ``backtrace``: the plain versions of K7c and K8c, or the kernels
    themselves from :func:`_viterbi_wide_kernels`. Under a profiler the
    loop opens the span ``hmm.recursion.viterbi.deltas`` and the walk
    ``hmm.recursion.viterbi.backtrace``, once each a call."""
    log_A = torch.log(_clamped(A)).contiguous()
    log_E = torch.log(_clamped(E)).contiguous()
    log_init = torch.log(_clamped(init))
    with span("hmm.recursion.viterbi.deltas"):
        delta0 = (log_init[:, None, :] + log_E[:, :, 0]).contiguous()  # (m, b, q)
        bp, last = deltas(log_A, log_E, delta0)
    with span("hmm.recursion.viterbi.backtrace"):
        return backtrace(bp, last)


def _viterbi_chunk_summaries(log_A, Et, P, first_chunk_identity=True):
    """Plain max-plus chunk transfer operators in the TRANSPOSED convention
    ``C_T[p, m, b, j, i] = C_p[i, j]``, as (P, m, b, q, q).

    ``Et`` (c, m, bP, q) log emissions. The first step is the identity
    (0 / ``_NEG``) for chunk 0 of a sequence and log A's rows otherwise; no
    rescaling: each step is exact up to one rounded add per term.
    ``first_chunk_identity=False`` gives chunk 0 log A's rows too
    (sequence-sharded callers: only the globally first block starts from
    the identity).
    """
    c, m, R, q = Et.shape
    b = R // P
    log_A_T = log_A.transpose(-1, -2)
    eye = torch.full((q, q), _NEG, dtype=Et.dtype, device=Et.device)
    eye.fill_diagonal_(0.0)
    is_first = ((torch.arange(R, device=Et.device) % P == 0) & bool(first_chunk_identity))[None, :, None, None]
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
    with span("hmm.recursion.viterbi.summaries"):
        Ec, _ = _split_chunks(torch.log(_clamped(E)), P)  # (m, bP, c, q)
        Et = Ec.movedim(2, 0)  # (c, m, bP, q)
        C_T = _viterbi_chunk_summaries(log_A, Et, P)
    with span("hmm.recursion.viterbi.boundaries"):
        T = _viterbi_boundaries(log_init, C_T)
        j_end = _boundary_backtrace(T, C_T)
    with span("hmm.recursion.viterbi.paths"):
        first_start = log_init[:, None, :].expand(m, b, q)
        return _viterbi_outputs(first_start, log_A, Et, j_end, P)


def _use_seq_viterbi_kernels(E) -> bool:
    """The blocked decode K7b/K8b runs where the tensors are on CUDA and
    16 < q <= 64 (the JAX gate ``_use_pallas_seq_viterbi``, on a TPU)."""
    return E.is_cuda and cuda_forward.KERNEL_MAX_Q < E.shape[-1] <= cuda_viterbi.MAX_BLOCKED_Q


def _viterbi_seq_kernels(init, A, E):
    """Sequential decode through the delta pass and the backtrace on the
    emissions' own layout (m, b, L, q) (K7b + K8b on CUDA), as
    ``_viterbi_seq_pallas``. Returns paths (m, b, L) int32, the same as
    :func:`_viterbi_seq`'s: the deltas are bit-equal and both take the
    lowest argmax."""
    log_A = torch.log(_clamped(A)).contiguous()
    log_init = torch.log(_clamped(init))
    log_E = torch.log(_clamped(E)).contiguous()  # (m, b, L, q)
    delta0 = (log_init[:, None, :] + log_E[:, :, 0]).contiguous()  # (m, b, q)
    return cuda_viterbi.maxplus_decode_seq(log_A, log_E, delta0)


def _use_wide_viterbi_kernels(E) -> bool:
    """The sequential decode K7c/K8c runs where the tensors are on CUDA and
    64 < q <= ``cuda_viterbi.MAX_WIDE_Q``, at ``parallel_factor == 1``."""
    return E.is_cuda and cuda_viterbi.MAX_BLOCKED_Q < E.shape[-1] <= cuda_viterbi.MAX_WIDE_Q


def _viterbi_wide_kernels(init, A, E):
    """:func:`_viterbi_seq` through K7c (the delta pass, uint16 pointers)
    and K8c (the pointer walk) on the emissions' own layout (m, b, L, q):
    the same paths, int32 (m, b, L), and the same spans."""
    return _viterbi_seq(init, A, E, cuda_viterbi.maxplus_deltas_wide, cuda_viterbi.maxplus_backtrace_wide)


def _viterbi_chunked_kernels(init, A, E, P):
    """Chunked Viterbi, kernel route: K6 summaries, the plain boundary fold
    and chunk-level backtrace, then K7 + K8 from the conditional starts."""
    m, b, L, q = E.shape
    log_init, log_A = torch.log(_clamped(init)), torch.log(_clamped(A)).contiguous()
    with span("hmm.recursion.viterbi.summaries"):
        log_E_T = torch.log(_kernel_chunk_inputs(E, P))  # (m, c, q, R)
        C_T = cuda_viterbi.maxplus_chunk_summaries(log_A, log_E_T, P)  # (m, R, q, q)
        C_T = C_T.reshape(m, b, P, q, q).movedim(2, 0)
    with span("hmm.recursion.viterbi.boundaries"):
        T = _viterbi_boundaries(log_init, C_T)
        j_end = _boundary_backtrace(T, C_T)
    with span("hmm.recursion.viterbi.paths"):
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
    per-sequence log-likelihood. At ``parallel_factor`` > 1 on CUDA at
    q <= 16 it runs K1 and K2; the gradient is the analytic adjoint VJP
    (:class:`_ForwardChunked`)."""
    if parallel_factor == 1:
        return ForwardResult(*_forward_seq(init, A, E))
    return ForwardResult(*_ForwardChunked.apply(init, A, E, parallel_factor))


def backward(init, A, E, parallel_factor: int = 1) -> torch.Tensor:
    """Backward algorithm: ``log_beta[t, i] = log P(x_{t+1..L} | s_t = i)``.
    At ``parallel_factor`` > 1 on CUDA at q <= 16 it runs K1 and K3; the
    gradient is the analytic adjoint VJP (:class:`_BackwardChunked`)."""
    if parallel_factor == 1:
        return _backward_seq(A, E)
    return _BackwardChunked.apply(init, A, E, parallel_factor)


@span("hmm.recursion.loglik")
def log_likelihood(
    init, A, E, parallel_factor: int = 1, analytic_vjp: bool = True
) -> torch.Tensor:
    """Per-sequence log-likelihood ``log P(x_{1..L})``, shape (m, b).

    The training-loss path. Gradients are analytic Baum-Welch VJPs at every
    ``parallel_factor`` (chunked: :class:`_LoglikChunked`; sequential:
    :class:`_LoglikSeq`, one forward + one backward pass instead of a taped
    scan, through K2c and K3c on CUDA at 64 < q <= 704). ``analytic_vjp=False`` at ``parallel_factor == 1`` differentiates
    the sequential scan by autograd instead (forward-mode differentiation
    needs it).
    """
    if parallel_factor == 1:
        if analytic_vjp:
            return _LoglikSeq.apply(init, A, E)
        return _forward_seq(init, A, E)[1]
    return _LoglikChunked.apply(init, A, E, parallel_factor)


@span("hmm.recursion.posterior")
def posterior(init, A, E, parallel_factor: int = 1, no_loglik: bool = False):
    """State posterior log-probabilities ``log P(s_t = j | x)``.

    With ``no_loglik`` the loglik normalisation is skipped (log alpha +
    log beta). Returns (log_gamma (m, b, L, q), loglik (m, b)). At
    ``parallel_factor`` > 1 the gradient is the analytic VJP with chunked
    affine adjoint solves (:class:`_PosteriorChunked`), K4–K5 on CUDA.
    """
    if parallel_factor == 1:
        la, ll = _forward_seq(init, A, E)
        log_gamma = la + _backward_seq(A, E)
        if not no_loglik:
            log_gamma = log_gamma - ll[..., None, None]
        return log_gamma, ll
    return _PosteriorChunked.apply(init, A, E, parallel_factor, no_loglik)


@torch.no_grad()
@span("hmm.recursion.viterbi")
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

    Routing for 16 < q <= 64: on a CUDA tensor these shapes take the
    sequential decode through the blocked kernels K7b/K8b
    (:func:`_viterbi_seq_kernels`) whatever the ``parallel_factor``, as the
    JAX package sends them to its blocked Pallas kernels on a TPU; the path
    is the sequential scan's. Off CUDA they route as the JAX package does
    off the TPU: the sequential scan for ``parallel_factor == 1``, the plain
    chunked engine above. For 64 < q <= ``cuda_viterbi.MAX_WIDE_Q`` at
    ``parallel_factor == 1`` a CUDA tensor takes K7c/K8c
    (:func:`_viterbi_wide_kernels`), the sequential scan's paths; the JAX
    package leaves that scan to XLA. Decoding has no gradient; it runs
    under ``torch.no_grad``.
    """
    if _use_seq_viterbi_kernels(E):
        with span("hmm.recursion.viterbi.paths"):
            return _viterbi_seq_kernels(init, A, E)
    if parallel_factor == 1:
        with span("hmm.recursion.viterbi.paths"):
            if _use_wide_viterbi_kernels(E):
                return _viterbi_wide_kernels(init, A, E)
            return _viterbi_seq(init, A, E)
    if _use_kernels(E):
        return _viterbi_chunked_kernels(init, A, E, parallel_factor)
    return _viterbi_chunked_plain(init, A, E, parallel_factor)
