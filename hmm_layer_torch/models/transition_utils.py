"""Transition matrices parameterised by one logit per allowed edge (port of
``hmm_layer_tpu/models/transition_utils.py``).

Each state's outgoing edges compete through a softmax restricted to the
allowed sparsity pattern. ``indices`` may be a NumPy array or a tensor; a
tensor already on the values' device (a module buffer) costs no copy.
"""

from __future__ import annotations

import torch

from ..ops.semiring import LOG_ZERO


def dense_from_edge_probs(indices, edge_probs, num_states):
    """Densify per-edge values: ``A[..., i, j] = sum_{e: src=i, dst=j} w_e``,
    computed as ``(OneHotSrc ⊙ w)ᵀ @ OneHotDst`` (no scatter).

    Args:
        indices: (n_edges, 2) int array of (from, to) pairs.
        edge_probs: (..., n_edges) values (leading axes broadcast).
        num_states: q.

    Returns:
        (..., q, q); entries off the edge support are 0.
    """
    indices = torch.as_tensor(indices, device=edge_probs.device)
    states = torch.arange(num_states, device=edge_probs.device)
    oh_src = (indices[:, 0, None] == states[None, :]).to(edge_probs.dtype)  # (n, q)
    oh_dst = (indices[:, 1, None] == states[None, :]).to(edge_probs.dtype)
    return torch.matmul((edge_probs[..., :, None] * oh_src).transpose(-1, -2), oh_dst)


def masked_row_softmax_from_edges(indices, values, num_states):
    """Dense row-stochastic (q, q) matrix from edge logits ``values``
    (n_edges,): each row softmaxes its allowed edges, rows without any edge
    are all zero.

    Logits are clamped to ``LOG_ZERO + 1`` first: a row whose logits are all
    -inf degrades to a uniform row over its edges instead of NaN.
    """
    values = torch.clamp_min(values, LOG_ZERO + 1.0)
    probs = sparse_edge_softmax(indices, values, num_states)
    return dense_from_edge_probs(indices, probs, num_states)


def gather_edge_probs(A, indices):
    """Read back per-edge probabilities from a dense matrix."""
    indices = torch.as_tensor(indices, device=A.device)
    return A[..., indices[:, 0], indices[:, 1]]


def sparse_edge_softmax(indices, values, num_states):
    """Per-edge probabilities without densifying.

    Each state's outgoing edges compete through a softmax restricted to the
    sparsity pattern, computed with segment reductions over the edge list.
    Both reductions are deterministic on CUDA too (a max, and an
    accumulating ``index_put_``, which sums each row serially after a sort;
    ``index_add`` would add with atomics in a varying order): the sparse
    engine's float32 log-scales at |loglik| ~ 1e5 turn a last-bit change of
    a probability into ~1e-3 changes of log gamma.

    Args:
        indices: (n_edges, 2) int array of (from_state, to_state).
        values: (..., n_edges) logits (leading axes broadcast).
        num_states: q.

    Returns:
        (..., n_edges) probabilities.
    """
    rows = torch.as_tensor(indices, device=values.device)[:, 0]
    v = values.movedim(-1, 0)  # (n, ...)
    index = rows.reshape((-1,) + (1,) * (v.ndim - 1)).expand_as(v)
    seg_shape = (num_states,) + tuple(v.shape[1:])
    row_max = torch.full(seg_shape, -torch.inf, dtype=v.dtype, device=v.device)
    row_max = row_max.scatter_reduce(0, index, v, reduce="amax", include_self=True)
    e = torch.exp(torch.clamp_min(v - row_max[rows], LOG_ZERO))
    denom = torch.zeros(seg_shape, dtype=v.dtype, device=v.device).index_put_((rows,), e, accumulate=True)
    return (e / torch.clamp_min(denom[rows], 1e-16)).movedim(0, -1)
