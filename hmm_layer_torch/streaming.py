"""Streaming (online) inference over unbounded sequences (port of
``hmm_layer_tpu/streaming.py``).

* **Filter** — the carried state is the normalised filter
  ``log P(s_t | x_{1..t})`` plus the running log-likelihood, O(q) per
  sequence however much has been consumed (carrying the raw joint would
  lose all state resolution in float32 once |loglik| ~ 1e7). Each block is
  reduced with the chunked engine's summaries (K1 on CUDA at q <= 16, K9
  behind its gate at 16 < q <= 128) and folded into the carry.
* **Fixed-lag Viterbi** — decision-feedback decode of a window of the last
  ``lag`` buffered positions plus the new block, conditioned on the last
  committed state (plain torch: the JAX package runs it as a ``lax.scan``).
* **Fixed-lag smoother** — exact posteriors of each window (the chunked
  :func:`~hmm_layer_torch.ops.recursion.forward` and
  :func:`~hmm_layer_torch.ops.recursion.backward`, K1–K3 on CUDA at
  q <= 16 when ``parallel_factor`` divides the window) with the seam
  filter folded in as a pseudo-position.
* **Sparse filter** — ``sparse_streaming_init/update`` carry the same
  state over an edge list (:mod:`.ops.sparse`): no dense ``A`` is built,
  the only streaming route past the dense (q, q) wall. Each position runs
  the sparse engine's single-sourced forward step, so the blockwise
  log-likelihood equals
  :func:`~hmm_layer_torch.ops.sparse.sparse_log_likelihood` of the whole
  sequence.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ops import sparse as _sparse
from .ops.recursion import _chunk_summaries_dispatch, _clamped, backward, forward
from .ops.semiring import logmatvec

__all__ = [
    "StreamingForwardState",
    "streaming_init",
    "streaming_update",
    "streaming_log_likelihood",
    "streaming_filter_log_probs",
    "sparse_streaming_init",
    "sparse_streaming_update",
    "StreamingViterbiState",
    "streaming_viterbi_init",
    "streaming_viterbi_update",
    "streaming_viterbi_finalize",
    "StreamingSmootherState",
    "streaming_smoother_init",
    "streaming_smoother_update",
    "streaming_smoother_finalize",
]


class StreamingForwardState(NamedTuple):
    """Filter ``log P(s_t | x_{1..t})`` (m, b, q) + loglik (m, b)."""

    log_filter: torch.Tensor
    log_lik: torch.Tensor


def _fold_block(log_v, A, E_block, parallel_factor):
    """Fold a block's chunk operators into the carried forward vector.

    The block's chunk 0 starts at the state of the block's first position
    (its emission included), so the caller folds the inter-block
    transition into ``log_v`` beforehand. Returns the unnormalised update
    of ``log_v``.
    """
    C = _chunk_summaries_dispatch(A, E_block, parallel_factor)
    for C_p in C:
        log_v = logmatvec(log_v, C_p)
    return log_v


def _normalize(v, log_lik):
    lse = torch.logsumexp(v, dim=-1, keepdim=True)
    return StreamingForwardState(v - lse, log_lik + lse[..., 0])


@torch.no_grad()
def streaming_init(init, A, E_block, parallel_factor: int = 1) -> StreamingForwardState:
    """Start a stream with its first emission block.

    Args:
        init: (m, q) initial distribution; A: (m, q, q); E_block:
            (m, b, L_block, q) linear emission probabilities
            (``parallel_factor`` must divide ``L_block``).
    """
    m, b, _, q = E_block.shape
    log_init = torch.log(_clamped(init))[:, None, :].expand(m, b, q)
    v = _fold_block(log_init, A, E_block, parallel_factor)
    return _normalize(v, torch.zeros((m, b), dtype=E_block.dtype, device=E_block.device))


@torch.no_grad()
def streaming_update(
    state: StreamingForwardState, A, E_block, parallel_factor: int = 1
) -> StreamingForwardState:
    """Consume the next emission block; O(q) carried state per sequence."""
    # Inter-block transition, then the block fold (identity-start chunk 0).
    u = logmatvec(state.log_filter, torch.log(_clamped(A))[:, None])
    v = _fold_block(u, A, E_block, parallel_factor)
    return _normalize(v, state.log_lik)


def streaming_log_likelihood(state: StreamingForwardState) -> torch.Tensor:
    """``log P(x_{1..t})`` of everything consumed so far, shape (m, b)."""
    return state.log_lik


def streaming_filter_log_probs(state: StreamingForwardState) -> torch.Tensor:
    """Filtered state posterior ``log P(s_t | x_{1..t})``, shape (m, b, q)."""
    return state.log_filter


def _sparse_block_fold(alpha, log_lik, dp, edge_probs, E_block):
    """Scaled sparse forward over a block from a normalised filter carry.

    Every position applies transition then emission (the carry is the
    filter at the position before), so the caller handles the stream's
    first position (emission only). The step is the sparse engine's own:
    blockwise parity with the whole sequence depends on it.
    """
    step = _sparse._scaled_fwd_step(dp.matvec(edge_probs, E_block.shape[:2], transpose=True))
    Ec = _clamped(E_block)
    for t in range(E_block.shape[2]):
        alpha, log_lik = step(alpha, log_lik, Ec[:, :, t])
    return StreamingForwardState(torch.log(alpha), log_lik)


@torch.no_grad()
def sparse_streaming_init(init, indices, edge_probs, E_block) -> StreamingForwardState:
    """Start a stream with the edge-list engine (no dense ``A`` is built).
    Same state as :func:`streaming_init`; the blockwise loglik matches
    :func:`~hmm_layer_torch.ops.sparse.sparse_log_likelihood` of the
    concatenated blocks to float tolerance.

    Args:
        init: (m, q); indices: (n_edges, 2) host edge list; edge_probs:
            (m, n_edges); E_block: (m, b, L_block, q) linear emissions.
    """
    dp = _sparse.EdgePlan.cached(indices).on(E_block.device, E_block.shape[-1])
    alpha, ll = _sparse._fwd_start(init, _clamped(E_block[:, :, 0]))
    return _sparse_block_fold(alpha, ll, dp, edge_probs, E_block[:, :, 1:])


@torch.no_grad()
def sparse_streaming_update(
    state: StreamingForwardState, indices, edge_probs, E_block
) -> StreamingForwardState:
    """Consume the next block over the edge list; O(q) carried state."""
    dp = _sparse.EdgePlan.cached(indices).on(E_block.device, E_block.shape[-1])
    return _sparse_block_fold(torch.exp(state.log_filter), state.log_lik, dp, edge_probs, E_block)


# ---------------------------------------------------------------------------
# Streaming (bounded-lag, online) Viterbi decode
# ---------------------------------------------------------------------------


class StreamingViterbiState(NamedTuple):
    """Decision-feedback fixed-lag decoder state.

    ``buf_log_E``: (m, b, lag, q) log emissions of the last ``lag``
    positions (not yet committed). ``seam_state``: (m, b) int32, the
    decoded state at the last committed position. ``started``: () bool,
    False until a position has been committed (the recursion then starts
    from ``init`` instead of the seam conditioning).
    """

    buf_log_E: torch.Tensor
    seam_state: torch.Tensor
    started: torch.Tensor


def _viterbi_window_decode(log_init, log_A, seam_state, started, log_E_win):
    """Conditional delta pass + backtrace over a window of emissions.

    ``log_E_win``: (m, b, W, q). The recursion starts from ``log_init``
    (stream head) or from the seam state's row of ``log_A`` (decision
    feedback keeps every committed transition valid). Returns the states
    (m, b, W) int32 of the whole window, backtraced from the window-end
    argmax.
    """
    m, b, W, q = log_E_win.shape
    models = torch.arange(m, device=log_A.device)[:, None]
    seam_row = log_A[models, seam_state.long()]  # (m, b, q): log_A[seam, :]
    start = torch.where(started, seam_row, log_init[:, None, :])
    delta = start + log_E_win[:, :, 0]
    log_A_b = log_A[:, None]
    deltas = [delta]
    for t in range(1, W):
        # max_i delta[i] + log_A[i, :]; the backtrace recomputes the argmax.
        delta = (delta[..., :, None] + log_A_b).amax(dim=-2) + log_E_win[:, :, t]
        deltas.append(delta)

    state = deltas[-1].argmax(dim=-1)
    log_A_T = log_A.transpose(-1, -2)
    states = [state]
    for t in range(W - 2, -1, -1):
        state = (deltas[t] + log_A_T[models, state]).argmax(dim=-1)  # + A[:, state]
        states.append(state)
    return torch.stack(states[::-1], dim=-1).to(torch.int32)


@torch.no_grad()
def streaming_viterbi_init(init, A, E_block, lag: int):
    """Start a bounded-lag streaming decode with the first emission block.

    Args:
        init: (m, q); A: (m, q, q); E_block: (m, b, L_block, q) linear
            emissions with ``L_block >= lag``.
        lag: decision lag D: a position is committed once D later positions
            have been consumed. Exact whenever all survivor paths merge
            within D steps; the committed sequence is always one valid
            path (decision-feedback seam conditioning).

    Returns:
        (state, committed (m, b, L_block - lag) int32).
    """
    m, b, L_block, q = E_block.shape
    if lag < 1:
        raise ValueError(
            f"lag must be >= 1, got {lag} (a zero-lag stream leaves an "
            "empty buffer that finalize cannot decode)"
        )
    if L_block < lag:
        raise ValueError(f"first block length {L_block} must be >= lag {lag}")
    log_E = torch.log(_clamped(E_block))
    log_init = torch.log(_clamped(init))
    log_A = torch.log(_clamped(A))
    device = E_block.device
    no_seam = torch.zeros((m, b), dtype=torch.int32, device=device)
    states = _viterbi_window_decode(
        log_init, log_A, no_seam, torch.tensor(False, device=device), log_E
    )
    n_commit = L_block - lag
    state = StreamingViterbiState(
        buf_log_E=log_E[:, :, n_commit:],
        seam_state=states[:, :, n_commit - 1] if n_commit else no_seam,
        started=torch.tensor(n_commit > 0, device=device),
    )
    return state, states[:, :, :n_commit]


@torch.no_grad()
def streaming_viterbi_update(state: StreamingViterbiState, init, A, E_block):
    """Consume the next block; returns (state, committed (m, b, L_block)).

    Decodes the (lag + L_block) window from the seam conditioning and
    commits its oldest ``L_block`` positions.
    """
    L_block = E_block.shape[2]
    log_E = torch.log(_clamped(E_block))
    win = torch.cat([state.buf_log_E, log_E], dim=2)
    states = _viterbi_window_decode(
        torch.log(_clamped(init)), torch.log(_clamped(A)), state.seam_state, state.started, win
    )
    committed = states[:, :, :L_block]
    new_state = StreamingViterbiState(
        buf_log_E=win[:, :, L_block:],
        seam_state=committed[:, :, -1],
        started=torch.tensor(True, device=E_block.device),
    )
    return new_state, committed


@torch.no_grad()
def streaming_viterbi_finalize(state: StreamingViterbiState, init, A) -> torch.Tensor:
    """End the stream: decode and commit the ``lag`` buffered positions
    (exact for the tail, given the seam)."""
    return _viterbi_window_decode(
        torch.log(_clamped(init)),
        torch.log(_clamped(A)),
        state.seam_state,
        state.started,
        state.buf_log_E,
    )


# ---------------------------------------------------------------------------
# Streaming fixed-lag smoothing (online posterior marginals)
# ---------------------------------------------------------------------------


class StreamingSmootherState(NamedTuple):
    """Fixed-lag smoother state.

    ``buf_E``: (m, b, lag, q) linear emissions of the last ``lag``
    positions (consumed, not yet committed). ``log_filter_seam``:
    (m, b, q), the normalised filter ``log P(s_c | x_{1..c})`` at the last
    committed position ``c``. ``log_lik``: (m, b), ``log P(x_{1..c})``.
    """

    buf_E: torch.Tensor
    log_filter_seam: torch.Tensor
    log_lik: torch.Tensor


def _pf_eff(length: int, parallel_factor: int) -> int:
    """The chunked engine needs the factor to divide the window; windows of
    another length run the sequential recursion."""
    return parallel_factor if length % parallel_factor == 0 else 1


def _window_posteriors(init, A, E_win, parallel_factor):
    """Exact forward/backward over one window: (post, la), the normalised
    posterior log-marginals ``log P(s_t | window)`` (m, b, W, q) and the
    raw log-forward values (m, b, W, q)."""
    pf = _pf_eff(E_win.shape[2], parallel_factor)
    la, _ = forward(init, A, E_win, pf)
    post = la + backward(init, A, E_win, pf)
    return post - torch.logsumexp(post, dim=-1, keepdim=True), la


@torch.no_grad()
def streaming_smoother_init(init, A, E_block, lag: int, parallel_factor: int = 1):
    """Start a fixed-lag smoothing stream with the first emission block.

    Position ``t`` is committed once ``lag`` later positions have been
    consumed, with marginal ``log P(s_t | x_{1..t+D_t})``, ``D_t >= lag``:
    the posterior of the stream truncated at the window's end. The carried
    state is O(lag·q) per sequence.

    Args:
        init: (m, q); A: (m, q, q); E_block: (m, b, L_block, q) linear
            emissions with ``L_block > lag >= 1``.
        parallel_factor: chunk parallelism within each window (used where
            it divides the window's length, else that window runs the
            sequential recursion).

    Returns:
        (state, committed (m, b, L_block - lag, q) posterior log-marginals).
    """
    L_block = E_block.shape[2]
    if lag < 1:
        raise ValueError(f"lag must be >= 1, got {lag}")
    if L_block <= lag:
        raise ValueError(
            f"first block length {L_block} must be > lag {lag} (the seam "
            "filter needs at least one committed position)"
        )
    post, la = _window_posteriors(init, A, E_block, parallel_factor)
    n_commit = L_block - lag
    seam = la[:, :, n_commit - 1]
    lse = torch.logsumexp(seam, dim=-1)
    state = StreamingSmootherState(
        buf_E=E_block[:, :, n_commit:], log_filter_seam=seam - lse[..., None], log_lik=lse
    )
    return state, post[:, :, :n_commit]


def _augmented_window(state: StreamingSmootherState, E_new):
    """Window emissions with the seam filter as a pseudo-position in front.

    Under a uniform initial distribution the engine applies one transition
    between the pseudo-position and the first real position, so alpha
    within the window is ``(1/q) P(x_win_{1..t}, s_t | x_{1..c})``: the
    constant drops out of every normalised quantity and is taken out of
    the log-likelihood bookkeeping.
    """
    m, b, _, q = state.buf_E.shape
    pseudo = torch.exp(state.log_filter_seam)[:, :, None, :]
    E_win = torch.cat([state.buf_E, E_new], dim=2)
    uniform = torch.full((m, q), 1.0 / q, dtype=E_win.dtype, device=E_win.device)
    return torch.cat([pseudo, E_win], dim=2), E_win, uniform


@torch.no_grad()
def streaming_smoother_update(state: StreamingSmootherState, A, E_block, parallel_factor: int = 1):
    """Consume the next block; returns (state, committed (m, b, L_block, q)).

    Smooths the (lag + L_block) window from the seam filter and commits its
    oldest ``L_block`` positions.
    """
    L_block, q = E_block.shape[2], E_block.shape[3]
    E_aug, E_win, uniform = _augmented_window(state, E_block)
    post, la = _window_posteriors(uniform, A, E_aug, parallel_factor)
    seam = la[:, :, L_block]  # augmented index: window position L_block - 1
    lse = torch.logsumexp(seam, dim=-1)
    new_state = StreamingSmootherState(
        buf_E=E_win[:, :, L_block:],
        log_filter_seam=seam - lse[..., None],
        log_lik=state.log_lik + lse + torch.log(torch.tensor(float(q), dtype=lse.dtype)),
    )
    return new_state, post[:, :, 1 : L_block + 1]


@torch.no_grad()
def streaming_smoother_finalize(state: StreamingSmootherState, A, parallel_factor: int = 1):
    """End the stream: commit the ``lag`` buffered positions, exactly (the
    window ends at the stream's end); (m, b, lag, q)."""
    E_aug, _, uniform = _augmented_window(state, state.buf_E[:, :, :0])  # no new block
    post, _ = _window_posteriors(uniform, A, E_aug, parallel_factor)
    return post[:, :, 1:]
