"""Multi-device sharding for HMM inference and training (port of
``hmm_layer_tpu/parallel/sharding.py``, its dense routes) over
``torch.distributed``.

* **Data parallelism** — the batch split over a ``data`` mesh axis; each
  rank runs the dense engine (on CUDA its kernels) on its rows.
* **State parallelism** — for large state counts (q >= 500, config 5) the
  alpha/beta columns, the emission columns and the transition rows are
  split over a ``state`` axis; each scan step computes a partial
  ``alpha @ A`` and all-reduces it. At ``parallel_factor > 1`` the chunk
  operators' left-border rows are split instead: no collective in the
  summary pass, one per chunk in the boundary folds.
* **Sequence parallelism** — the sequence axis split over a ``seq`` axis;
  each rank reduces its block to one ``q x q`` operator, the operators are
  all-gathered, and every rank folds the boundary values itself.

One process per rank (SPMD): a ``shard_map`` body of the JAX package is
the rank's own code here, with the collectives of :mod:`.collectives` on
the mesh axes' process groups. The state and sequence routes have two
modes:

* global (``local=False``, the default): every function takes the GLOBAL
  tensors on every rank (as the JAX functions take global arrays) and
  returns the global result on every rank, so each rank holds the whole
  ``E`` and the gathered outputs; gradients are those of the global
  function, the same on every rank;
* rank-local (``local=True``): ``init`` and ``A`` stay global, but ``E``
  comes in and log gamma goes out as the rank's block, as the JAX
  ``in_specs``/``out_specs`` shard them — (m, b_l, L, q_l) on the state
  routes, (m, b_l, L_l, q) on the sequence routes
  (:func:`~.collectives.local_ranges`); logliks (m, b_l), paths (m, b_l,
  L) or (m, b_l, L_l). No rank holds a global (m, b, L, q) tensor, except
  that the chunked state route (``parallel_factor > 1``) all-gathers its
  rows' columns of ``E`` inside the call (its chunk operators need every
  column). Gradients: ``E``'s is the rank's block of the global one;
  ``init``'s and ``A``'s are the global ones on every rank.

The sequence routes' gradients are analytic
(``torch.autograd.Function``\\ s whose backwards make the JAX VJPs'
collectives; on CUDA at q <= 15 the posterior VJP's affine solves launch
K4–K5); the state routes are differentiated through autograd-aware
collectives.

As in the JAX package the sequence routes' primal and the state routes
run the plain recursions (``_chunk_summaries``, not the K1 dispatch).
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from ..ops.recursion import (
    _affine_boundary_fold,
    _affine_composites,
    _affine_composites_kernels,
    _affine_kernel_lanes,
    _affine_outputs,
    _affine_outputs_kernels,
    _backward_adjoint_weights,
    _backward_gA_factors,
    _backward_outputs,
    _boundary_backtrace,
    _chunk_summaries,
    _clamped,
    _forward_adjoint_weights,
    _forward_gA_factors,
    _forward_outputs,
    _loglik_bw_stats,
    _prefix_logmatmul,
    _split_chunks,
    _summaries_from_rows,
    _viterbi_boundaries,
    _viterbi_chunk_summaries,
    _viterbi_outputs,
    _xi_sum,
)
from ..ops import recursion
from ..ops.semiring import EPS, logmatmul, maxmatmul
from . import collectives as C
from .collectives import Mesh, make_mesh

__all__ = [
    "init_distributed",
    "make_mesh",
    "shard_batch",
    "replicate",
    "data_parallel_fn",
    "data_parallel_em_step",
    "data_parallel_em_step_categorical",
    "state_sharded_log_likelihood",
    "state_sharded_posterior",
    "state_sharded_viterbi",
    "seq_sharded_log_likelihood",
    "seq_sharded_posterior",
    "seq_sharded_viterbi",
]


def init_distributed(
    backend: str | None = None,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    timeout_s: float | None = None,
    **kwargs,
) -> None:
    """Initialise the process group of this rank (the JAX
    ``jax.distributed.initialize``).

    ``backend`` defaults to NCCL where CUDA is available and gloo
    elsewhere; under NCCL each rank takes the GPU ``rank % device_count``.
    ``init_method`` (e.g. ``"tcp://localhost:29500"``), ``world_size`` and
    ``rank`` default to the ``env://`` variables (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). ``timeout_s`` bounds every
    collective: a rank whose peers diverge fails instead of hanging.
    """
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    if backend == "nccl":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def shard_batch(x, mesh: Mesh, axis: str = "data", batch_dim: int = 1):
    """This rank's block of an (m, b, L, s) batch, ``b`` split over ``axis``."""
    return C.block(torch.as_tensor(x), mesh, axis, batch_dim)


def replicate(tree, mesh: Mesh):
    """Make every rank hold rank 0's copy of ``tree``: the tensors of
    nested dicts, lists and tuples, or the parameters and buffers of an
    ``nn.Module``, broadcast in place. Returns ``tree``."""
    if not mesh.distributed:
        return tree
    if isinstance(tree, torch.nn.Module):
        leaves = [t.data for t in [*tree.parameters(), *tree.buffers()]]
    else:
        leaves = []
        _map_tensors(leaves.append, tree)
    with torch.no_grad():
        for t in leaves:
            dist.broadcast(t, src=0)
    return tree


def _map_tensors(fn, tree):
    """``fn`` over the tensors of nested dicts, lists and tuples; other
    leaves pass through."""
    from ..training import _tree_map

    return _tree_map(lambda leaf: fn(leaf) if torch.is_tensor(leaf) else leaf, tree)


def data_parallel_fn(fn, mesh: Mesh, axis: str = "data", batch_dim: int = 1):
    """``fn(params, x, ...)`` with ``x`` split over ``axis`` along
    ``batch_dim``: each rank runs ``fn`` on its rows, with the parameters
    replicated. ``x`` is one tensor or a tuple of tensors that share the
    row count (their other leaves pass through whole). The row count need
    not divide by the axis size: the blocks then differ by one row
    (:func:`~hmm_layer_torch.parallel.collectives.row_sizes`), as the JAX
    sharding constraint keeps every row. Tensor results are gathered along
    ``batch_dim``, 0-d results averaged over the ranks weighted by their
    rows (so a mean over a rank's rows becomes the batch mean): the call
    returns what ``fn(params, x)`` returns, and its gradients are those of
    the whole batch on every rank."""

    def wrapped(params, x, *args, **kwargs):
        x = tuple(x) if isinstance(x, (tuple, list)) else torch.as_tensor(x)
        total = next(t for t in (x if isinstance(x, tuple) else (x,)) if torch.is_tensor(t)).shape[batch_dim]
        rows = _map_tensors(lambda t: C.scatter(t, mesh, axis, batch_dim, ragged=True), x)
        return run_on_rows(fn, params, rows, total, mesh, axis, batch_dim, *args, **kwargs)

    return wrapped


def run_on_rows(fn, params, rows, total: int, mesh: Mesh, axis: str = "data", batch_dim: int = 1, *args, **kwargs):
    """``fn(params, rows, ...)`` on this rank's ``rows`` (its block of
    ``total`` rows along ``batch_dim``, :func:`~.collectives.row_sizes`),
    combined as :func:`data_parallel_fn` combines them: the parameters
    replicated, tensor results gathered, 0-d results averaged by rows. The
    rows' own gradients are their block's (a rank that computed only its
    rows, e.g. its emissions, sums the gradients of what it computed them
    from over ``axis`` itself)."""
    params = _map_tensors(lambda a: C.replicated(a, mesh, axis), params)
    share = C.row_sizes(total, mesh.shape[axis])[mesh.index(axis)] / total
    out = fn(params, rows, *args, **kwargs)

    def combine(o):
        if o.dim() == 0:
            return C.mean_out(o, mesh, axis, share)
        return C.gather(o, mesh, axis, batch_dim, total)

    return _map_tensors(combine, out)


def _check_divisible(size, n, what, axis_size_name):
    if size % n:
        raise ValueError(f"{what}={size} not divisible by {axis_size_name} size {n}")


# ---------------------------------------------------------------------------
# State-sharded routes (tensor-parallel analog)
# ---------------------------------------------------------------------------


def _plogsumexp(x, mesh, axis):
    """Elementwise log-sum-exp across the ranks of ``axis``; the max shift
    carries no gradient (exact for any constant shift)."""
    m = C.pmax(x.detach(), mesh, axis)
    safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.log(C.psum_ad(torch.exp(x - safe), mesh, axis)) + safe


def _border_sharded_chunk_operators(A, E, P_local, n_state, idx):
    """Chunk transfer operators with the left-border axis split: this
    rank's operator ROWS (its border-state block) from the whole ``A`` and
    emissions, with no collective. Returns (P, m, b, q_l, q) log-space
    row blocks."""
    m, b, L, q = E.shape
    q_l = q // n_state
    col0 = idx * q_l
    Ec, c = _split_chunks(E, P_local)
    Et = Ec.movedim(2, 0)  # (c, m, bP, q)
    eye_rows = torch.eye(q, dtype=E.dtype, device=E.device)[col0 : col0 + q_l]
    A_rows = A[:, col0 : col0 + q_l]  # (m, q_l, q)
    is_first = (torch.arange(P_local, device=E.device) == 0).to(E.dtype)[None, None, :, None, None]
    R0 = is_first * eye_rows + (1.0 - is_first) * A_rows[:, None, None]
    R0 = R0.expand(m, b, P_local, q_l, q).reshape(m, b * P_local, q_l, q)
    C_l = _summaries_from_rows(A, Et, R0)  # (m, bP, q_l, q)
    return C_l.reshape(m, b, P_local, q_l, q).movedim(2, 0)


def _sharded_boundary_folds(init, C_l, mesh, state_axis, q_l, idx, want_backward=True):
    """Forward/backward values at chunk boundaries from row-split
    operators: sequential log-matvec folds over the P chunks with one
    collective per chunk (the forward fold contracts over the split border
    axis, the backward fold all-gathers its row block). Returns (T, S, ll)
    as ``recursion._boundary_values``; S is None without
    ``want_backward``."""
    P, m, b = C_l.shape[:3]
    q = C_l.shape[-1]
    col0 = idx * q_l
    v = torch.log(_clamped(init))[:, None, :].expand(m, b, q)
    T = []
    for p in range(P):
        part = torch.logsumexp(v[..., col0 : col0 + q_l, None] + C_l[p], dim=-2)
        v = _plogsumexp(part, mesh, state_axis)
        T.append(v)
    T = torch.stack(T)
    ll = torch.logsumexp(T[-1], dim=-1)
    if not want_backward:
        return T, None, ll
    w = torch.zeros((m, b, q), dtype=C_l.dtype, device=C_l.device)
    S = [None] * P
    for p in range(P - 1, -1, -1):
        S[p] = w  # backward at chunk p's end, then fold chunk p
        w_rows = torch.logsumexp(C_l[p] + w[..., None, :], dim=-1)  # (m, b, q_l)
        w = C.all_gather_ad(w_rows, mesh, state_axis, dim=-1)
    return T, torch.stack(S), ll


def _check_state_block(E, q_l):
    if E.shape[-1] != q_l:
        raise ValueError(f"local E has {E.shape[-1]} states; a state block holds {q_l} (local_ranges)")


def _state_inputs(init, A, E, mesh, state_axis, data_axis, local, q_l):
    """init and A replicated over both axes; the global E split over the
    data rows, or under ``local`` the rank's (m, b_l, L, q_l) block as it
    is."""
    axes = (state_axis, data_axis)
    if local:
        _check_state_block(E, q_l)
    return (
        C.replicated(init, mesh, axes),
        C.replicated(A, mesh, axes),
        E if local else C.scatter(E, mesh, data_axis, 1),
    )


def _state_columns(E_d, mesh, state_axis, local):
    """Every state column of the rank's rows, for the border-split chunk
    operators: the global E's rows as they are (their gradient summed over
    the state ranks), or under ``local`` the blocks all-gathered over the
    state axis (its gradient the rank's block of that sum)."""
    if local:
        return C.all_gather_ad(E_d, mesh, state_axis, dim=3)
    return C.replicated(E_d, mesh, state_axis)


def _state_loglik(ll, mesh, state_axis, data_axis, local):
    """The rank's (m, b_l) loglik, gathered over the rows unless ``local``."""
    ll = C.replicated_out(ll, mesh, state_axis)
    return ll if local else C.gather(ll, mesh, data_axis, 1)


def _state_scan_forward(init_l, A_rows, E_l, mesh, state_axis, cols, want_outputs):
    """Scaled sequential forward over split columns: (log alpha (L, m, b,
    q_l) or None, loglik (m, b))."""
    Et = E_l.movedim(2, 0)  # (L, m, b, q_l)
    s = _clamped(Et[0]) * _clamped(init_l)[:, None, :]
    z = C.psum_ad(s.sum(-1, keepdim=True), mesh, state_axis)
    alpha, ll = s / z, torch.log(z[..., 0])
    outs = [torch.log(alpha) + ll[..., None]] if want_outputs else None
    for t in range(1, Et.shape[0]):
        r_full = C.psum_ad(torch.matmul(alpha, A_rows), mesh, state_axis)  # (m, b, q)
        s = _clamped(Et[t]) * _clamped(r_full[..., cols])
        z = C.psum_ad(s.sum(-1, keepdim=True), mesh, state_axis)
        alpha, ll = s / z, ll + torch.log(z[..., 0])
        if want_outputs:
            outs.append(torch.log(alpha) + ll[..., None])
    return (torch.stack(outs) if want_outputs else None), ll


def state_sharded_log_likelihood(
    init,
    A,
    E,
    mesh: Mesh,
    state_axis: str = "state",
    data_axis: str | None = None,
    parallel_factor: int = 1,
    local: bool = False,
):
    """Log-likelihood with the state dimension split over ``state_axis``.

    ``parallel_factor == 1``: sequential scaled scan; each rank holds the
    rows ``A[cols, :]`` and the alpha/emission columns ``cols``, and every
    step all-reduces the partial ``alpha_local @ A_local``.
    ``parallel_factor > 1``: the chunk operators' left-border rows are
    split (:func:`_border_sharded_chunk_operators`), so the summary pass
    makes no collective; the boundary fold makes one per chunk.

    Args:
        init: (m, q); A: (m, q, q) — global, on every rank; ``q``
            divisible by the state-axis size (pad upstream).
        E: (m, b, L, q), global; under ``local`` the rank's (m, b_l, L,
            q_l) block (:func:`~.collectives.local_ranges`, route
            ``"state"``).
    Returns:
        (m, b) log-likelihoods; under ``local`` the rank's rows (m, b_l).
    """
    n_state = mesh.shape[state_axis]
    q = A.shape[-1]
    _check_divisible(q, n_state, "q", "state axis")
    idx = mesh.index(state_axis)
    q_l = q // n_state
    cols = slice(idx * q_l, (idx + 1) * q_l)
    init_r, A_r, E_d = _state_inputs(init, A, E, mesh, state_axis, data_axis, local, q_l)
    if parallel_factor > 1:
        E_r = _state_columns(E_d, mesh, state_axis, local)
        C_l = _border_sharded_chunk_operators(A_r, E_r, parallel_factor, n_state, idx)
        _, _, ll = _sharded_boundary_folds(init_r, C_l, mesh, state_axis, q_l, idx, want_backward=False)
    else:
        E_l = E_d if local else C.scatter(E_d, mesh, state_axis, 3)
        _, ll = _state_scan_forward(init_r[:, cols], A_r[:, cols], E_l, mesh, state_axis, cols, False)
    return _state_loglik(ll, mesh, state_axis, data_axis, local)


def state_sharded_posterior(
    init,
    A,
    E,
    mesh: Mesh,
    state_axis: str = "state",
    data_axis: str | None = None,
    no_loglik: bool = False,
    parallel_factor: int = 1,
    local: bool = False,
):
    """Posterior state log-probabilities with the state dimension split.

    ``parallel_factor == 1``: sequential scaled forward and backward scans
    with the alpha/beta columns split; each step all-reduces its partial
    contraction against the local block of ``A`` (rows forward, columns
    backward). ``parallel_factor > 1``: border-split chunk operators, then
    the cheap O(L·q²) output passes run on whole state vectors on every
    rank, and each rank emits its posterior column block.

    Under ``local`` ``E`` is the rank's (m, b_l, L, q_l) block
    (:func:`~.collectives.local_ranges`, route ``"state"``) and the rank
    gets back its block of log gamma and its rows' loglik. At
    ``parallel_factor > 1`` the chunk operators need every column, so the
    call all-gathers the rank's rows of ``E`` over the state axis (its
    inputs and outputs stay the rank's blocks).

    Returns:
        (log_gamma (m, b, L, q), loglik (m, b)); under ``local``
        ((m, b_l, L, q_l), (m, b_l)).
    """
    n_state = mesh.shape[state_axis]
    q = A.shape[-1]
    _check_divisible(q, n_state, "q", "state axis")
    idx = mesh.index(state_axis)
    q_l = q // n_state
    cols = slice(idx * q_l, (idx + 1) * q_l)
    init_r, A_r, E_d = _state_inputs(init, A, E, mesh, state_axis, data_axis, local, q_l)

    if parallel_factor > 1:
        E_r = _state_columns(E_d, mesh, state_axis, local)
        C_l = _border_sharded_chunk_operators(A_r, E_r, parallel_factor, n_state, idx)
        T, S, ll = _sharded_boundary_folds(init_r, C_l, mesh, state_axis, q_l, idx)
        la = _forward_outputs(init_r, A_r, E_r, T, parallel_factor)
        lb = _backward_outputs(A_r, E_r, S, parallel_factor)
        lg = (la + lb)[..., cols]
    else:
        E_l = E_d if local else C.scatter(E_d, mesh, state_axis, 3)
        A_c = A_r[:, :, cols]  # (m, q, q_l): columns for the backward contraction
        la, ll = _state_scan_forward(init_r[:, cols], A_r[:, cols], E_l, mesh, state_axis, cols, True)
        m, b, L, _ = E_l.shape
        Et = E_l.movedim(2, 0)
        beta = torch.ones((m, b, q_l), dtype=E_l.dtype, device=E_l.device)
        bll = torch.zeros((m, b), dtype=E_l.dtype, device=E_l.device)
        outs = [torch.zeros_like(beta)]
        A_cT = A_c.transpose(-1, -2)
        for t in range(L - 1, 0, -1):
            r = _clamped(Et[t]) * beta  # local columns j
            s_full = C.psum_ad(torch.matmul(r, A_cT), mesh, state_axis)  # (m, b, q)
            s_l = _clamped(s_full[..., cols])
            # The rescale cancels in the emitted log beta: no gradient.
            z = C.pmax(s_l.detach().amax(-1, keepdim=True), mesh, state_axis)
            beta, bll = s_l / z, bll + torch.log(z[..., 0])
            outs.append(torch.log(beta) + bll[..., None])
        lb = torch.stack(outs[::-1])
        lg = (la + lb).movedim(0, 2)  # (m, b, L, q_l)
    if not no_loglik:
        lg = lg - ll[..., None, None]
    if not local:
        lg = C.gather(C.gather(lg, mesh, state_axis, 3), mesh, data_axis, 1)
    return lg, _state_loglik(ll, mesh, state_axis, data_axis, local)


@torch.no_grad()
def state_sharded_viterbi(
    init, A, E, mesh: Mesh, state_axis: str = "state", data_axis: str | None = None, local: bool = False
):
    """Viterbi decode with the state dimension split.

    A sequential max-plus scan with the delta columns and the rows of
    ``A`` split. Each step reduces the partial per-column maxima with a
    max all-reduce and resolves the global argmax with a min all-reduce
    over the tied candidates (rank d's state indices all precede rank
    d+1's, so the lowest tied index is ``argmax``'s). Backpointer columns
    stay local; the backtrace fetches each step's pointer from its owner
    with one masked all-reduce. The result is a backtrace, one valid path.

    Returns:
        states (m, b, L) int32; under ``local`` (``E`` the rank's (m, b_l,
        L, q_l) block) its rows' paths (m, b_l, L).
    """
    n_state = mesh.shape[state_axis]
    q = A.shape[-1]
    _check_divisible(q, n_state, "q", "state axis")
    q_l = q // n_state
    idx = mesh.index(state_axis)
    col0 = idx * q_l
    cols = slice(col0, col0 + q_l)
    if local:
        _check_state_block(E, q_l)
        E_l = E
    else:
        E_l = C.block(C.block(E, mesh, data_axis, 1), mesh, state_axis, 3)
    log_A_l = torch.log(_clamped(A[:, cols]))  # (m, q_l, q): local rows
    Et = torch.log(_clamped(E_l)).movedim(2, 0)  # (L, m, b, q_l)
    delta = torch.log(_clamped(init[:, cols]))[:, None, :] + Et[0]

    def resolve_argmax(best_l, arg_l):
        best = C.pmax(best_l, mesh, state_axis)
        arg = C.pmin(torch.where(best_l >= best, arg_l, torch.full_like(arg_l, q)), mesh, state_axis)
        return best, arg

    bps = []
    for t in range(1, Et.shape[0]):
        scores = delta[..., :, None] + log_A_l[:, None]  # (m, b, q_l, q)
        best_l, arg_l = scores.max(dim=-2)
        best, arg = resolve_argmax(best_l, arg_l + col0)
        delta = best[..., cols] + Et[t]
        bps.append(arg[..., cols])
    best_l, arg_l = delta.max(dim=-1)
    _, state = resolve_argmax(best_l, arg_l + col0)  # (m, b) global last state
    path = [state]
    for bp in reversed(bps):
        own = state - col0
        in_range = (own >= 0) & (own < q_l)
        val = torch.gather(bp, -1, own.clamp(0, q_l - 1)[..., None])[..., 0]
        state = C.psum(torch.where(in_range, val, torch.zeros_like(val)), mesh, state_axis)
        path.append(state)
    path = torch.stack(path[::-1], dim=-1).to(torch.int32)  # (m, b_l, L)
    return path if local else C.gather(path, mesh, data_axis, 1)


# ---------------------------------------------------------------------------
# Sequence-sharded routes (sequence/context-parallel analog)
# ---------------------------------------------------------------------------


def _seq_block(E, mesh, seq_axis, data_axis):
    """This rank's (rows, positions) block of E."""
    return C.block(C.block(E, mesh, data_axis, 1), mesh, seq_axis, 2).contiguous()


def _gather_seq(x, mesh, seq_axis, data_axis):
    """Positions over ``seq_axis`` (dim 2), then rows over ``data_axis``."""
    return C.gather(C.gather(x, mesh, seq_axis, 2), mesh, data_axis, 1)


def _seq_ll_local(init, A, E_l, mesh, seq_axis, P_local):
    """This rank's block reduced to one q x q operator (only the globally
    first block starts from the identity), the operators all-gathered and
    folded from ``init``: the (m, b_l) log-likelihoods."""
    m, b, _, q = E_l.shape
    idx = mesh.index(seq_axis)
    Cs, _ = _chunk_summaries(A, E_l, P_local, first_chunk_identity=(idx == 0))
    block = Cs[0]
    for p in range(1, P_local):
        block = logmatmul(block, Cs[p])
    blocks = C.all_gather(block, mesh, seq_axis)  # (n_seq, m, b, q, q)
    v = torch.log(_clamped(init))[:, None, :].expand(m, b, q)
    for d in range(blocks.shape[0]):
        v = logmatmul(v[..., None, :], blocks[d])[..., 0, :]
    return torch.logsumexp(v, dim=-1)


def _device_boundary_values(blocks, log_init_b):
    """Forward/backward values at every rank-block boundary from the
    gathered block operators (n, m, b, q, q), folded on every rank.
    Returns (v_ends, w_ends, loglik); w_ends[-1] = 0."""
    n = blocks.shape[0]
    v = log_init_b
    v_ends = []
    for d in range(n):
        v = logmatmul(v[..., None, :], blocks[d])[..., 0, :]
        v_ends.append(v)
    loglik = torch.logsumexp(v_ends[-1], dim=-1)
    w = torch.zeros_like(log_init_b)
    w_ends = [None] * n
    w_ends[n - 1] = w
    for d in range(n - 2, -1, -1):
        w = logmatmul(blocks[d + 1], w[..., :, None])[..., 0]
        w_ends[d] = w
    return v_ends, w_ends, loglik


def _seq_local_forward_backward(init, A, E_l, mesh, seq_axis, P_local):
    """This rank's log-forward/backward variables from one boundary
    exchange: ONE all-gather of q x q block operators, the boundary folds
    on every rank, then the chunked output passes conditioned on the
    block's entering/exiting values. Returns (la, lb (m, b, L_l, q), ll
    (m, b), v_enter (m, b, q) — the log-forward entering the block)."""
    m, b, _, q = E_l.shape
    idx = mesh.index(seq_axis)
    log_A = torch.log(_clamped(A))
    log_init_b = torch.log(_clamped(init))[:, None, :].expand(m, b, q)
    Cs, _ = _chunk_summaries(A, E_l, P_local, first_chunk_identity=(idx == 0))
    prefix = _prefix_logmatmul(Cs)  # prefix[-1] is the block operator
    blocks = C.all_gather(prefix[-1], mesh, seq_axis)  # (n, m, b, q, q)
    v_ends, w_ends, ll = _device_boundary_values(blocks, log_init_b)
    v_enter = log_init_b if idx == 0 else v_ends[idx - 1]
    w_exit = w_ends[idx]
    T = torch.logsumexp(v_enter[None, ..., None] + prefix, dim=-2)
    # suffix[p] = C_p ∘ ... ∘ C_{P-1}: the prefix of the flipped transposes.
    suffix = _prefix_logmatmul(Cs.flip(0).transpose(-1, -2)).flip(0).transpose(-1, -2)
    S_inner = logmatmul(suffix[1:], w_exit[None, ..., None])[..., 0]
    S = torch.cat([S_inner, w_exit[None]], dim=0)
    first_start = log_init_b if idx == 0 else logmatmul(v_enter[..., None, :], log_A[:, None])[..., 0, :]
    la = _forward_outputs(init, A, E_l, T, P_local, first_start_log=first_start)
    lb = _backward_outputs(A, E_l, S, P_local)
    return la, lb, ll, v_enter


def _check_seq(E, mesh, seq_axis, data_axis):
    _check_divisible(E.shape[2], mesh.shape[seq_axis], "L", "seq axis")
    if data_axis is not None:
        _check_divisible(E.shape[1], mesh.shape[data_axis], "b", "data axis")


class _SeqLoglik(torch.autograd.Function):
    """Sequence-sharded log-likelihood with the analytic Baum-Welch VJP:
    each rank computes its block's expected statistics from one boundary
    exchange, the cross-block transition pair rides the known
    ``v_enter``, and gA/ginit are all-reduced (``recursion._LoglikChunked``
    with a rank level)."""

    @staticmethod
    def forward(ctx, init, A, E, mesh, seq_axis, data_axis, P_local, local):
        E_l = E.contiguous() if local else _seq_block(E, mesh, seq_axis, data_axis)
        ctx.args = (mesh, seq_axis, data_axis, P_local, local)
        ctx.save_for_backward(init, A, E_l)
        ll = _seq_ll_local(init, A, E_l, mesh, seq_axis, P_local)
        return ll if local else C.gather(ll, mesh, data_axis, 1)

    @staticmethod
    def backward(ctx, ct):
        mesh, seq_axis, data_axis, P_local, local = ctx.args
        init, A, E_l = ctx.saved_tensors
        idx = mesh.index(seq_axis)
        reduce_axes = (seq_axis, data_axis)
        ct_l = ct if local else C.block(ct, mesh, data_axis, 1)
        la, lb, ll, v_enter = _seq_local_forward_backward(init, A, E_l, mesh, seq_axis, P_local)
        log_E = torch.log(_clamped(E_l))
        # Within-block statistics are the dense VJP's; ginit counts on the
        # first block only.
        ginit0, gA, gE = _loglik_bw_stats(init, A, E_l, la, lb, ll, ct_l)
        ginit = C.psum(ginit0 if idx == 0 else torch.zeros_like(ginit0), mesh, reduce_axes)
        if idx > 0:  # the pair (previous block's last, own first) rides v_enter
            csp = v_enter.amax(-1, keepdim=True)
            wp = torch.exp(v_enter - csp)
            up = torch.exp(lb[:, :, 0] + log_E[:, :, 0] - ll[..., None] + csp) * ct_l[..., None]
            gA = gA + torch.einsum("mbi,mbj->mij", wp, up)
        gA = C.psum(gA, mesh, reduce_axes)
        gE = gE if local else _gather_seq(gE, mesh, seq_axis, data_axis)
        return ginit, gA, gE, None, None, None, None, None


def seq_sharded_log_likelihood(
    init,
    A,
    E,
    mesh: Mesh,
    seq_axis: str = "seq",
    data_axis: str | None = None,
    local_parallel_factor: int = 1,
    local: bool = False,
):
    """Log-likelihood with the sequence axis split over ``seq_axis``.

    Each rank reduces its block to one ``q x q`` log-space operator (the
    chunked engine with ``local_parallel_factor`` inside the block), the
    operators are all-gathered and folded on every rank: one collective
    per call. The gradient is the analytic Baum-Welch VJP
    (:class:`_SeqLoglik`): one boundary exchange, no taped summary scan.

    Under ``local`` ``E`` is the rank's (m, b_l, L_l, q) block of rows and
    positions (:func:`~.collectives.local_ranges`, route ``"seq"``), the
    result its rows' (m, b_l), and ``E``'s gradient its block of the
    global one.
    """
    if not local:
        _check_seq(E, mesh, seq_axis, data_axis)
    return _SeqLoglik.apply(init, A, E, mesh, seq_axis, data_axis, max(local_parallel_factor, 1), local)


def _seq_post_local(init, A, E_l, mesh, seq_axis, P_local, no_loglik):
    la, lb, ll, _ = _seq_local_forward_backward(init, A, E_l, mesh, seq_axis, P_local)
    lg = la + lb
    if not no_loglik:
        lg = lg - ll[..., None, None]
    return lg, ll, la


def _fold_device_composite(comp):
    """Affine composition of a rank's chunk composites (right to left)."""
    q = comp.shape[-2]
    D = comp[-1]
    for p in range(comp.shape[0] - 2, -1, -1):
        K = torch.matmul(comp[p][..., :q], D[..., :q])
        o = comp[p][..., -1] + torch.matmul(comp[p][..., :q], D[..., -1:])[..., 0]
        D = torch.cat([K, o[..., None]], dim=-1)
    return D


def _global_right_edge(Dall, idx, flipped):
    """This rank's right-edge adjoint from the all-gathered rank
    composites: a right-to-left fold in EFFECTIVE rank order (the lb
    adjoint runs on the flipped time axis, which reverses it)."""
    n, m, b, q = Dall.shape[:4]
    x = torch.zeros((m, b, q), dtype=Dall.dtype, device=Dall.device)
    rights = [None] * n
    rights[n - 1] = x
    for dd in range(n - 1, 0, -1):
        Dd = Dall[n - 1 - dd if flipped else dd]
        x = Dd[..., -1] + torch.matmul(Dd[..., :q], x[..., None])[..., 0]
        rights[dd - 1] = x
    return rights[n - 1 - idx if flipped else idx]


def _seq_affine_solve2(B2, u2, v2, s2, P_local, mesh, seq_axis):
    """Both posterior adjoint solves as ONE stacked batch (B2 = [A; Aᵀ]),
    as the dense VJP: the first m models in rank order (la adjoint), the
    last m on the flipped time axis (lb adjoint). On CUDA at q <= 15 the
    composites and outputs are K4 and K5. Returns (x_fwd, x_bwd_flipped),
    each (m, b, L_l, q)."""
    m = B2.shape[0] // 2
    b = s2.shape[1]
    idx = mesh.index(seq_axis)
    kernels = recursion._use_affine_kernels(s2)  # the recursions' gate, looked up at the call
    if kernels:
        B2 = B2.contiguous()
        lanes = _affine_kernel_lanes(u2, v2, s2, P_local)
        comp = _affine_composites_kernels(B2, lanes, b)
    else:
        comp = _affine_composites(B2, u2, v2, s2, P_local)
    Dall = C.all_gather(_fold_device_composite(comp), mesh, seq_axis)
    x_right = torch.cat(
        [_global_right_edge(Dall[:, :m], idx, False), _global_right_edge(Dall[:, m:], idx, True)], dim=0
    )
    rights = _affine_boundary_fold(comp, x_right)
    if kernels:
        x2 = _affine_outputs_kernels(B2, lanes, b, rights)
    else:
        x2 = _affine_outputs(B2, u2, v2, s2, P_local, rights)
    return x2[:m], x2[m:]


def _seq_post_bwd(init, A, E_l, la, lg, ll, ct, ct_ll, mesh, seq_axis, data_axis, P_local, no_loglik):
    """Sequence-sharded analytic VJP of the chunked posterior
    (``recursion._posterior_analytic_vjp``, the same gamma-scalar plus
    centered-residual decomposition) with three distributed parts: the two
    affine adjoint solves gain a rank level and run stacked
    (:func:`_seq_affine_solve2`), the block-edge adjoint weights come from
    the neighbours' edge values, and the expected-transition sums add the
    cross-block pair and are all-reduced."""
    idx = mesh.index(seq_axis)
    n_seq = mesh.shape[seq_axis]
    reduce_axes = (seq_axis, data_axis)
    lb = lg - la
    if not no_loglik:
        lb = lb + ll[..., None, None]
    log_E = torch.log(_clamped(E_l))
    maskE = E_l >= EPS
    gam = torch.exp(la + lb - ll[..., None, None])

    # -- scalars -------------------------------------------------------------
    sig = ct.sum(-1)  # (m, b, L_l)
    sig_tot = C.psum(sig.sum(-1), mesh, seq_axis)  # (m, b)
    ct_ll_eff = ct_ll if no_loglik else ct_ll - sig_tot
    src = ct - gam * sig[..., None]

    # -- adjoint weights: the dense constructions, their zeroed edge slot
    # filled from the neighbour (gbar at a block's LAST step needs the next
    # block's first (la, log_E); fp at a block's FIRST step the previous
    # block's last lb; the global edges stay zero).
    la_next0 = C.shift_from_next(la[:, :, 0], mesh, seq_axis)
    logE_next0 = C.shift_from_next(log_E[:, :, 0], mesh, seq_axis)
    f, gbar = _forward_adjoint_weights(la, log_E)
    if idx < n_seq - 1:
        sM_last = la[:, :, -1].amax(-1, keepdim=True)
        gbar = gbar.clone()
        gbar[:, :, -1] = torch.exp(logE_next0 + sM_last - la_next0)
    lb_prev_last = C.shift_from_prev(lb[:, :, -1], mesh, seq_axis)
    fp, gp, sp, elb = _backward_adjoint_weights(lb, log_E)
    if idx > 0:
        fp = fp.clone()
        fp[:, :, 0] = torch.exp(sp[:, :, 0] - lb_prev_last)

    # -- the two rank-level affine solves, stacked as in the dense VJP -------
    A_T = A.transpose(-1, -2)
    bhat, chat_f = _seq_affine_solve2(
        torch.cat([A, A_T], dim=0),
        torch.cat([f, gp.flip(2)], dim=0),
        torch.cat([gbar, fp.flip(2)], dim=0),
        torch.cat([src, src.flip(2)], dim=0),
        P_local,
        mesh,
        seq_axis,
    )
    chat = chat_f.flip(2)
    # Project out drift along the growing gamma mode (exact residuals are
    # zero-sum; see the dense VJP).
    bhat = bhat - gam * bhat.sum(-1, keepdim=True)
    chat = chat - gam * chat.sum(-1, keepdim=True)

    # -- assemble --------------------------------------------------------------
    K = sig + ct_ll[..., None]
    if no_loglik:
        K = K + sig_tot[..., None]
    gE = (gam * K[..., None] + bhat + chat - ct) / _clamped(E_l) * maskE

    R0 = sig_tot + ct_ll_eff
    bar0 = gam[:, :, 0] * R0[..., None] + bhat[:, :, 0]
    ginit0 = bar0.sum(1) / _clamped(init) * (init >= EPS)
    ginit = C.psum(ginit0 if idx == 0 else torch.zeros_like(ginit0), mesh, reduce_axes)

    # gA: within-block pairs + the cross-block (last, first) pair.
    kappa = ct_ll + sig_tot if no_loglik else ct_ll
    F, G_of, csh = _forward_gA_factors(la, log_E)
    xi_u = torch.exp(lb[:, :, 1:] + log_E[:, :, 1:] - ll[..., None, None] + csh) * kappa[..., None, None]
    Fp_of, Gp = _backward_gA_factors(lb, sp, elb)
    gA = _xi_sum(F, xi_u + G_of(bhat)) + _xi_sum(Fp_of(chat), Gp)

    la_prev_last = C.shift_from_prev(la[:, :, -1], mesh, seq_axis)
    chat_prev_last = C.shift_from_prev(chat[:, :, -1], mesh, seq_axis)
    if idx > 0:
        cshp = la_prev_last.amax(-1, keepdim=True)
        F_pair = torch.exp(la_prev_last - cshp)
        xi_u_pair = torch.exp(lb[:, :, 0] + log_E[:, :, 0] - ll[..., None] + cshp) * kappa[..., None]
        G_pair = bhat[:, :, 0] * torch.exp(log_E[:, :, 0] - la[:, :, 0] + cshp)
        Fp_pair = chat_prev_last * torch.exp(sp[:, :, 0] - lb_prev_last)
        Gp_pair = torch.exp(elb[:, :, 0] - sp[:, :, 0])
        gA = gA + torch.einsum("mbi,mbj->mij", F_pair, xi_u_pair + G_pair)
        gA = gA + torch.einsum("mbi,mbj->mij", Fp_pair, Gp_pair)
    gA = C.psum(gA, mesh, reduce_axes)
    return ginit, gA, gE


class _SeqPosterior(torch.autograd.Function):
    """Sequence-sharded chunked posterior with its analytic VJP
    (:func:`_seq_post_bwd`)."""

    @staticmethod
    def forward(ctx, init, A, E, mesh, seq_axis, data_axis, P_local, no_loglik, local):
        E_l = E.contiguous() if local else _seq_block(E, mesh, seq_axis, data_axis)
        lg, ll, la = _seq_post_local(init, A, E_l, mesh, seq_axis, P_local, no_loglik)
        ctx.args = (mesh, seq_axis, data_axis, P_local, no_loglik, local)
        ctx.save_for_backward(init, A, E_l, la, lg, ll)
        if local:
            return lg, ll
        return _gather_seq(lg, mesh, seq_axis, data_axis), C.gather(ll, mesh, data_axis, 1)

    @staticmethod
    def backward(ctx, ct, ct_ll):
        mesh, seq_axis, data_axis, P_local, no_loglik, local = ctx.args
        init, A, E_l, la, lg, ll = ctx.saved_tensors
        if local:
            ct_l, ct_ll_l = ct.contiguous(), ct_ll
        else:
            ct_l = _seq_block(ct, mesh, seq_axis, data_axis)
            ct_ll_l = C.block(ct_ll, mesh, data_axis, 1)
        ginit, gA, gE = _seq_post_bwd(
            init, A, E_l, la, lg, ll, ct_l, ct_ll_l, mesh, seq_axis, data_axis, P_local, no_loglik
        )
        gE = gE if local else _gather_seq(gE, mesh, seq_axis, data_axis)
        return ginit, gA, gE, None, None, None, None, None, None


def seq_sharded_posterior(
    init,
    A,
    E,
    mesh: Mesh,
    seq_axis: str = "seq",
    data_axis: str | None = None,
    local_parallel_factor: int = 1,
    no_loglik: bool = False,
    local: bool = False,
):
    """Posterior state log-probabilities with the sequence axis split.

    Exact: each rank reduces its block to a ``q x q`` operator, the
    operators are all-gathered (one small collective), every rank folds
    the global boundary values, then runs the chunked output passes
    conditioned on its entering/exiting values. The gradient is the
    sequence-sharded analytic VJP (:func:`_seq_post_bwd`).

    Returns:
        (log_gamma (m, b, L, q), loglik (m, b)); under ``local`` (``E`` the
        rank's (m, b_l, L_l, q) block, as
        :func:`seq_sharded_log_likelihood` takes it) the rank's
        ((m, b_l, L_l, q), (m, b_l)).
    """
    if not local:
        _check_seq(E, mesh, seq_axis, data_axis)
    return _SeqPosterior.apply(
        init, A, E, mesh, seq_axis, data_axis, max(local_parallel_factor, 1), no_loglik, local
    )


@torch.no_grad()
def seq_sharded_viterbi(
    init,
    A,
    E,
    mesh: Mesh,
    seq_axis: str = "seq",
    data_axis: str | None = None,
    local_parallel_factor: int = 1,
    local: bool = False,
):
    """Viterbi decode with the sequence axis split: one all-gather of
    max-plus block operators, the rank-boundary backtrace on every rank,
    then the block's decode conditioned on its boundary states — the
    spliced result is one valid optimal path.

    Returns:
        states (m, b, L) int32; under ``local`` (``E`` the rank's (m, b_l,
        L_l, q) block) the rank's (m, b_l, L_l).
    """
    if not local:
        _check_seq(E, mesh, seq_axis, data_axis)
    P_local = max(local_parallel_factor, 1)
    n_seq = mesh.shape[seq_axis]
    idx = mesh.index(seq_axis)
    E_l = E.contiguous() if local else _seq_block(E, mesh, seq_axis, data_axis)
    m, b, L_l, q = E_l.shape
    log_A = torch.log(_clamped(A))
    log_init_b = torch.log(_clamped(init))[:, None, :].expand(m, b, q)
    Ec, _ = _split_chunks(torch.log(_clamped(E_l)), P_local)
    Et = Ec.movedim(2, 0)  # (c, m, bP, q)

    C_T = _viterbi_chunk_summaries(log_A, Et, P_local, first_chunk_identity=(idx == 0))
    # (C_0 ∘ ... ∘ C_p)^T = C_p^T ∘ (...)^T.
    block_T = C_T[0]
    for p in range(1, P_local):
        block_T = maxmatmul(C_T[p], block_T)
    blocks_T = C.all_gather(block_T, mesh, seq_axis)  # (n, m, b, q, q)

    v = log_init_b
    v_ends = []
    for d in range(n_seq):
        v = (blocks_T[d] + v[..., None, :]).amax(dim=-1)
        v_ends.append(v)
    j_dev = [None] * n_seq
    j_dev[n_seq - 1] = v_ends[-1].argmax(dim=-1)
    for d in range(n_seq - 1, 0, -1):
        row = torch.gather(blocks_T[d], -2, j_dev[d][..., None, None].expand(m, b, 1, q))[..., 0, :]
        j_dev[d - 1] = (v_ends[d - 1] + row).argmax(dim=-1)

    # The block's decode is conditioned on the decoded entry state: the
    # start vector is masked to it (under float32 near-ties an unmasked
    # start could favour another entry state than the one the first
    # chunk's delta pass is conditioned on).
    j_exit = j_dev[idx]
    if idx == 0:
        v_start = log_init_b
        first_start = log_init_b
    else:
        j_enter = j_dev[idx - 1]
        entry = torch.nn.functional.one_hot(j_enter, q).bool()
        v_start = torch.where(entry, v_ends[idx - 1], torch.full_like(v_ends[idx - 1], -1e30))
        models = torch.arange(m, device=A.device)[:, None]
        first_start = log_A[models, j_enter]  # A[j_enter, :]
    T = _viterbi_boundaries(v_start, C_T)
    j_end = _boundary_backtrace(T, C_T, j_last=j_exit)
    path = _viterbi_outputs(first_start, log_A, Et, j_end, P_local)
    return path if local else _gather_seq(path, mesh, seq_axis, data_axis)


# ---------------------------------------------------------------------------
# Data-parallel Baum-Welch (EM): distributed sufficient statistics
# ---------------------------------------------------------------------------


@torch.no_grad()
def data_parallel_em_step(
    init, A, E, mesh: Mesh, parallel_factor: int = 1, pseudocount: float = 0.0, data_axis: str = "data"
):
    """One Baum-Welch update of ``init``/``A`` with the batch split over
    ``data_axis``: each rank runs the exact E-step on its rows, the
    sufficient statistics ((m, q) t = 0 counts, (m, q, q) expected
    transitions) are all-reduced, and every rank applies the closed-form
    M-step (:func:`hmm_layer_torch.ops.em.em_step` on the whole batch, up
    to the order of the sums).

    Returns:
        (new_init (m, q), new_A (m, q, q), loglik (m, b)).
    """
    from ..ops.em import _m_step_A, _m_step_init_from_counts, expected_statistics

    gamma, xi_sum, ll = expected_statistics(init, A, C.block(E, mesh, data_axis, 1), parallel_factor)
    init_counts = C.psum(gamma[:, :, 0].sum(1), mesh, data_axis)
    xi_sum = C.psum(xi_sum, mesh, data_axis)
    return (
        _m_step_init_from_counts(init_counts, init, pseudocount),
        _m_step_A(xi_sum, A, pseudocount),
        C.all_gather(ll, mesh, data_axis, 1),
    )


@torch.no_grad()
def data_parallel_em_step_categorical(
    init, A, B, x, mesh: Mesh, parallel_factor: int = 1, pseudocount: float = 0.0, data_axis: str = "data"
):
    """One full Baum-Welch step for a lookup-table HMM (``E = x @ Bᵀ``)
    with the batch split: init, A and the emission table B from one split
    E-step; only the summed statistics cross ranks.

    Returns:
        (new_init, new_A, new_B, loglik (m, b)).
    """
    from ..ops.em import (
        _emission_counts,
        _m_step_A,
        _m_step_B_from_counts,
        _m_step_init_from_counts,
        expected_statistics,
    )

    x_l = C.block(x, mesh, data_axis, 1)
    E_l = torch.einsum("mbls,mqs->mblq", x_l, B)
    gamma, xi_sum, ll = expected_statistics(init, A, E_l, parallel_factor)
    init_counts = C.psum(gamma[:, :, 0].sum(1), mesh, data_axis)
    xi_sum = C.psum(xi_sum, mesh, data_axis)
    b_counts = C.psum(_emission_counts(gamma, x_l), mesh, data_axis)
    return (
        _m_step_init_from_counts(init_counts, init, pseudocount),
        _m_step_A(xi_sum, A, pseudocount),
        _m_step_B_from_counts(b_counts, pseudocount),
        C.all_gather(ll, mesh, data_axis, 1),
    )
