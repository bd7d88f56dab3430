"""Exact posterior path sampling by forward-filter backward-sample (port of
``hmm_layer_tpu/ops/sampling.py``).

Draws joint hidden-state paths ``s ~ P(s | x)`` with Gumbel-max
categorical draws over the FFBS conditionals:

    s_{L-1} ~ softmax(log alpha_{L-1})
    s_t     ~ softmax(log alpha_t + log A[:, s_{t+1}])

The chunked variant is exact too: the states at the P chunk ends form a
Markov chain whose transition operators are the chunk summaries
``C[p](i, j)``, so they are sampled first from the boundary forward values
(``P(s at chunk p's end = i | s at chunk p+1's end = j, x) ∝ exp(T[p](i) +
C[p+1](i, j))``). Given both borders the chunk interiors are independent,
so every chunk then runs a conditional forward recursion from its sampled
left border followed by backward sampling within the chunk, all chunks at
once. On CUDA at q <= 16 the summaries come from K1, at 16 < q <= 128 from
K9 behind its gate (:func:`.recursion._chunk_summaries_dispatch`); the
folds and the draws are plain torch.

Transitions with probability exactly zero are never sampled: ``log A`` is
masked with the finite ``_MASK``, and the boundary chain's operators and
forward values with hard structural masks (:func:`_boundary_masks`). The
conditional selections (a row or a column of ``log A`` or of ``C``) are
exact indexing, never a product with a one-hot vector.

The Gumbel noise comes from the caller's ``torch.Generator`` through
:func:`_gumbel`, in the JAX function's shapes and order: one (L, m, b, S, q)
draw for ``parallel_factor == 1``; a (P, m, b, S, q) draw for the boundary
chain, then a (c - 1, m, b, P, S, q) draw within the chunks.
"""

from __future__ import annotations

import torch

from .recursion import _chunk_summaries_dispatch, _clamped, _forward_boundaries, _forward_seq

__all__ = ["sample_posterior"]

# Sentinel for structurally impossible transitions. Sampling has no
# gradient, so a hard mask is safe, and the exactness guarantee needs it:
# the soft LOG_ZERO (-1e3) of the recursions could lose an argmax to
# accumulated within-chunk deficits of the same size. Not -inf: -1e30 beats
# no real path score (bounded by ~L·|log EPS| ≈ 4e5) and stays finite
# under adds.
_MASK = -1e30


def _masked_log(A):
    return torch.where(A > 0, torch.log(_clamped(A)), _MASK)


def _gumbel(shape, generator, device):
    """Standard Gumbel noise of ``shape`` (float32) on ``device``, drawn
    from ``generator`` on the generator's own device."""
    gen_device = generator.device if generator is not None else device
    u = torch.empty(shape, dtype=torch.float32, device=gen_device).exponential_(generator=generator)
    return (-torch.log(u)).to(device)


def _gumbel_argmax(logits, g):
    return (logits + g).argmax(dim=-1)


def _bool_matpower(Ab, n: int):
    """Support of ``A^n`` per model: (m, q, q) bool, by squaring."""
    m, q = Ab.shape[0], Ab.shape[-1]
    out = torch.eye(q, dtype=torch.float32, device=Ab.device).expand(m, q, q)
    base = Ab.to(torch.float32)
    while n:
        if n & 1:
            out = (out @ base > 0).to(torch.float32)
        base = (base @ base > 0).to(torch.float32)
        n >>= 1
    return out > 0


def _boundary_masks(init, A, P: int, c: int):
    """Hard structural masks of the chunk-boundary Markov chain.

    The summary scan clamps its per-step operators at EPS, so impossible
    entries of ``C``/``T`` are only soft floors; exactness needs true
    masks. Returns ``reach_c`` (m, q, q), the support of the operators of
    chunks p > 0 (``c`` factors of A), and ``fmask`` (P, m, q), forward
    reachability at each chunk's last position. Emissions and init are
    clamped by the engine (only A carries structural zeros), so A's
    support decides reachability exactly.
    """
    Ab = A > 0
    reach_c = _bool_matpower(Ab, c)
    R0 = _bool_matpower(Ab, c - 1).to(torch.float32)
    f = ((init > 0).to(torch.float32)[:, None, :] @ R0)[:, 0] > 0  # (m, q)
    reach_f = reach_c.to(torch.float32)
    fmask = [f]
    for _ in range(P - 1):
        f = (f.to(torch.float32)[:, None, :] @ reach_f)[:, 0] > 0
        fmask.append(f)
    return reach_c, torch.stack(fmask)


def _column(log_A, s):
    """``log_A[m, :, s[m, ...]]`` for states ``s`` (m, ...); (m, ..., q)."""
    m = log_A.shape[0]
    models = torch.arange(m, device=log_A.device).reshape((m,) + (1,) * (s.dim() - 1))
    return log_A.transpose(-1, -2)[models, s]


@torch.no_grad()
def sample_posterior(init, A, E, generator=None, num_samples: int = 1, parallel_factor: int = 1):
    """Joint posterior path samples by forward-filter backward-sampling.

    Args:
        init: (m, q); A: (m, q, q); E: (m, b, L, q) linear emission probs.
        generator: the ``torch.Generator`` the Gumbel noise is drawn from
            (on the tensors' device, or on the CPU and then copied); the
            device's default generator when ``None``.
        num_samples: independent paths per sequence.
        parallel_factor: chunked-parallel factor (must divide L).

    Returns:
        paths: (m, b, num_samples, L) int32, exact draws from P(s | x).
    """
    log_A = _masked_log(A)
    if parallel_factor == 1:
        la, _ = _forward_seq(init, A, E)
        paths = _sample_backward_seq(la, log_A, generator, num_samples)
    else:
        paths = _sample_backward_chunked(init, A, E, log_A, generator, num_samples, parallel_factor)
    return paths.to(torch.int32)


def _sample_backward_seq(la, log_A, generator, S):
    m, b, L, q = la.shape
    g = _gumbel((L, m, b, S, q), generator, la.device)
    s = _gumbel_argmax(la[:, :, -1][:, :, None, :], g[-1])  # (m, b, S)
    path = [s]
    for t in range(L - 2, -1, -1):
        s = _gumbel_argmax(la[:, :, t][:, :, None, :] + _column(log_A, s), g[t])
        path.append(s)
    return torch.stack(path[::-1], dim=-1)


def _sample_backward_chunked(init, A, E, log_A, generator, S, P):
    m, b, L, q = E.shape
    c = L // P
    C = _chunk_summaries_dispatch(A, E, P)  # (P, m, b, q, q)
    T = _forward_boundaries(init, C)  # log forward at the chunk ends
    reach_c, fmask = _boundary_masks(init, A, P, c)
    T = torch.where(fmask[:, :, None, :], T, _MASK)
    C_next = torch.where(reach_c[None, :, None], C[1:], _MASK)

    # -- boundary pass: exact FFBS over the chunk-end Markov chain -----------
    gb = _gumbel((P, m, b, S, q), generator, E.device)
    s = _gumbel_argmax(T[-1][:, :, None, :], gb[-1])  # (m, b, S)
    bounds = [s]
    for p in range(P - 2, -1, -1):
        # w[m, b, s, i] = C_{p+1}[m, b, i, s_next]
        w = torch.gather(C_next[p].transpose(-1, -2), 2, s[..., None].expand(m, b, S, q))
        s = _gumbel_argmax(T[p][:, :, None, :] + w, gb[p])
        bounds.append(s)
    s_bounds = torch.stack(bounds[::-1])  # (P, m, b, S)

    if c == 1:
        return s_bounds.permute(1, 2, 3, 0)  # every position is a boundary

    # -- conditional forward within each chunk from its sampled left border --
    log_Et = torch.log(_clamped(E)).reshape(m, b, P, c, q).movedim(3, 0)  # (c, m, b, P, q)
    models = torch.arange(m, device=E.device)[:, None, None, None]
    start_rest = log_A[models, s_bounds[:-1].movedim(0, 2)]  # (m, b, P-1, S, q): A rows
    start0 = torch.log(_clamped(init))[:, None, None, None, :].expand(m, b, 1, S, q)
    la = torch.cat([start0, start_rest], dim=2) + log_Et[0][:, :, :, None, :]  # (m, b, P, S, q)
    log_A_b = log_A[:, None, None, None]
    la_hist = [la]
    for t in range(1, c - 1):
        la = torch.logsumexp(la[..., :, None] + log_A_b, dim=-2) + log_Et[t][:, :, :, None, :]
        la_hist.append(la)

    # -- within-chunk backward sampling from the sampled right border ---------
    g_w = _gumbel((c - 1, m, b, P, S, q), generator, E.device)
    s = s_bounds.movedim(0, 2)  # (m, b, P, S)
    path = [s]
    for t in range(c - 2, -1, -1):
        s = _gumbel_argmax(la_hist[t] + _column(log_A, s), g_w[t])
        path.append(s)
    path = torch.stack(path[::-1])  # (c, m, b, P, S)
    return path.permute(1, 2, 4, 3, 0).reshape(m, b, S, L)
