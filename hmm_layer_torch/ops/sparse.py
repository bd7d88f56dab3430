"""Sparse-transition HMM recursions over COO edge lists (port of
``hmm_layer_tpu/ops/sparse.py``).

For large multi-copy gene-prediction models (``q = 1 + 14k``) the dense
``(q, q)`` transition matrix costs O(q²) memory and O(q²) work per position
(k = 1000: 14001² float32 = 784 MB per model) while the grammar has only
``1 + 22k`` edges. These recursions do O(n_edges · b) work per position: a
gather of the carried vector at each edge's source (or destination), a
product with the edge weights and a segment sum over the edges sorted by
destination (or source).

The edges are sorted once on the host (:class:`EdgePlan`, memoised on the
index bytes) and the sort orders live on each device the plan is used on,
so a call copies no indices. The segment sums are ``torch.segment_reduce``
over the sorted edges: every state's in-edges are summed in edge order by
one thread, without atomics, so two identical calls give bit-equal results
on CUDA too (``index_add_`` would not). Max and min reductions (Viterbi,
sampling) are order-free.

The time loops are eager Python loops of plain torch ops: the JAX package
runs them as ``lax.scan``\\ s, and no TPU kernel lies on this path. Each
step keeps only what depends on the carry; the emission clamp is applied
once before the loop and ``log alpha + loglik`` is formed once after it.

Gradients: :func:`sparse_log_likelihood` and :func:`sparse_posterior`
carry analytic adjoints (``torch.autograd.Function``\\ s; the JAX
``custom_vjp``\\ s): Baum-Welch statistics for the log-likelihood, and the
gamma-centered adjoint recursions of the dense engine with the dense
matvec replaced by gather + segment sum, so the backward pass never builds
anything O(q²). ``analytic_vjp=False`` differentiates the loops by
autograd instead. ``backward_block`` (or :func:`set_sparse_posterior_block`,
seeded by ``HMM_SPARSE_POSTERIOR_BLOCK``) selects the time-blocked
recompute backward, and :func:`sparse_posterior_cross_entropy` fuses the
supervised objective so that the (m, b, L, q) posterior and its cotangent
never exist.

Edge probabilities come from
:func:`hmm_layer_torch.models.transition_utils.sparse_edge_softmax` or a
transition module's ``make_A_sparse``.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from . import recursion as _rec
from . import sampling as _sampling
from .semiring import EPS

__all__ = [
    "sparse_forward",
    "sparse_backward",
    "sparse_log_likelihood",
    "sparse_posterior",
    "sparse_viterbi",
    "sparse_sample_paths",
    "sparse_expected_statistics",
    "sparse_em_step",
    "sparse_posterior_cross_entropy",
    "set_sparse_posterior_block",
]

_NEG = -1e30

# Elements of one gathered (m, b, T, n_edges) product in _edge_outer_sum:
# the time chunk T is chosen to stay below it.
_OUTER_SUM_ELEMENTS = 1 << 22


def _clamped(x):
    return torch.clamp_min(x, EPS)


def _host_indices(indices) -> np.ndarray:
    """The (n_edges, 2) index array on the host. Only numpy arrays and CPU
    tensors are accepted: reading a CUDA tensor would synchronise the
    device on every call."""
    if isinstance(indices, torch.Tensor):
        if indices.device.type != "cpu":
            raise TypeError(
                "sparse edge `indices` must be a host array (numpy or a CPU "
                "tensor): the edge plan is sorted on the host, and reading a "
                f"{indices.device} tensor would synchronise the device on every "
                "call. Pass the indices from make_transition_indices() / "
                "make_A_sparse()."
            )
        indices = indices.numpy()
    indices = np.asarray(indices)
    if indices.ndim != 2 or indices.shape[1] != 2:
        raise ValueError(f"sparse edge `indices` must be (n_edges, 2), got {indices.shape}")
    return indices


class EdgePlan:
    """Host-side edge preprocessing: both sort orders (by destination for
    forward-direction reductions, by source for backward-direction ones)
    and the inverse permutation mapping destination-sorted edge values
    back to the caller's edge order. Hashable on the index bytes.

    :meth:`on` gives the plan's index tensors on a device (built once per
    device and state count, then cached).
    """

    __slots__ = (
        "n", "indices", "src_d", "dst_d", "perm_d", "inv_d",
        "src_s", "dst_s", "perm_s", "_key", "_devices",
    )

    def __init__(self, indices):
        indices = _host_indices(indices)
        self.indices = indices
        self.n = indices.shape[0]
        perm_d = np.argsort(indices[:, 1], kind="stable")
        self.src_d = indices[perm_d, 0]
        self.dst_d = indices[perm_d, 1]
        self.perm_d = perm_d
        inv = np.empty(self.n, np.int64)
        inv[perm_d] = np.arange(self.n)
        self.inv_d = inv
        perm_s = np.argsort(indices[:, 0], kind="stable")
        self.src_s = indices[perm_s, 0]
        self.dst_s = indices[perm_s, 1]
        self.perm_s = perm_s
        self._key = (indices.shape[0], indices.tobytes())
        self._devices = {}

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, EdgePlan) and self._key == other._key

    @staticmethod
    def cached(indices) -> "EdgePlan":
        """Memoised constructor, keyed on the index bytes (as int64)."""
        arr = np.ascontiguousarray(_host_indices(indices), np.int64)
        return _edge_plan_cached(arr.shape[0], arr.tobytes())

    def on(self, device, q: int) -> "_DevicePlan":
        """The plan's index tensors on ``device`` for ``q`` states."""
        key = (torch.device(device), int(q))
        plan = self._devices.get(key)
        if plan is None:
            plan = self._devices[key] = _DevicePlan(self, *key)
        return plan

    def matvec(self, edge_probs, y, q, transpose: bool = False):
        """``A @ y`` (or ``A.T @ y``) over the edge list; y: (m, b, q).

        ``(A @ y)[i] = sum_{e: src=i} w_e y[dst_e]``: gather at dst,
        segment-sum by src (src-sorted); ``transpose`` swaps the roles.
        """
        return self.on(y.device, q).matvec(edge_probs, y.shape[:-1], transpose)(y)


@lru_cache(maxsize=32)
def _edge_plan_cached(n, index_bytes):
    return EdgePlan(np.frombuffer(index_bytes, np.int64).reshape(n, 2))


def _offsets(sorted_ids, q):
    """(q + 1,) bounds of each state's run of edges in ``sorted_ids``."""
    return np.searchsorted(sorted_ids, np.arange(q + 1), side="left")


class _DevicePlan:
    """An :class:`EdgePlan`'s index tensors on one device for ``q`` states,
    and the segment bounds expanded to each leading shape they are used
    with (``torch.segment_reduce`` takes them per leading index). They are
    made outside inference mode, so that a plan first used in inference
    mode still serves taped autograd later (which saves them)."""

    def __init__(self, plan: EdgePlan, device: torch.device, q: int):
        def tensor(a):
            return torch.tensor(np.asarray(a, np.int64), device=device)

        if plan.n and int(plan.indices.max()) >= q:
            raise ValueError(f"edge indices reach state {int(plan.indices.max())}, but q = {q}")
        self.n = plan.n
        with torch.inference_mode(False):
            self.src_d, self.dst_d = tensor(plan.src_d), tensor(plan.dst_d)
            self.perm_d, self.inv_d = tensor(plan.perm_d), tensor(plan.inv_d)
            self.src_s, self.dst_s, self.perm_s = tensor(plan.src_s), tensor(plan.dst_s), tensor(plan.perm_s)
            self.src = tensor(plan.indices[:, 0])
            # Viterbi: the winning in-edge's source; edge id n is the
            # sentinel of a state without in-edges.
            self.src_lookup = tensor(np.concatenate([plan.src_d, [0]]))
            self.edge_ids = torch.arange(plan.n, dtype=torch.float32, device=device)
            self._bounds = {"d": tensor(_offsets(plan.dst_d, q)), "s": tensor(_offsets(plan.src_s, q))}
        self._expanded = {}

    def offsets(self, by: str, lead) -> torch.Tensor:
        """Segment bounds of the edges sorted by destination (``"d"``) or
        source (``"s"``), for data of leading shape ``lead``."""
        key = (by, tuple(lead))
        off = self._expanded.get(key)
        if off is None:
            with torch.inference_mode(False):
                bounds = self._bounds[by]
                off = self._expanded[key] = bounds.expand(tuple(lead) + bounds.shape).contiguous()
        return off

    def matvec(self, edge_probs, lead, transpose: bool):
        """``y -> A @ y`` (``A.T @ y`` with ``transpose``) for ``y`` of
        leading shape ``lead`` = (m, b); the edge weights are permuted
        once, here."""
        if transpose:
            w = edge_probs.index_select(-1, self.perm_d)[:, None, :]
            gather, off = self.src_d, self.offsets("d", lead)
        else:
            w = edge_probs.index_select(-1, self.perm_s)[:, None, :]
            gather, off = self.dst_s, self.offsets("s", lead)
        return lambda y: _segsum(y.index_select(-1, gather) * w, off)


def _segreduce(contrib, reduce, offsets):
    """Sorted segment reduction over the trailing edge axis -> trailing
    state axis; an empty segment gives the reduction's identity (0, -inf
    or +inf)."""
    return torch.segment_reduce(contrib, reduce, offsets=offsets, axis=contrib.dim() - 1, unsafe=True)


def _segsum(contrib, offsets):
    """Sorted segment sum: contrib (m, b, n) -> (m, b, q)."""
    return _segreduce(contrib, "sum", offsets)


def _scaled_fwd_step(matvec_T):
    """THE sum-normalised sparse forward step: the single source for
    :func:`sparse_forward`, the log-likelihood, the blocked-adjoint
    recompute (:func:`_blk_la`) and the streaming fold. The blocked
    backward's reconstruction and the streaming filter are exact only
    because their recompute is this same function (clamp placement and the
    sum normaliser); do not re-implement the body elsewhere. ``ec_t`` is
    the clamped emission."""

    def step(alpha, ll, ec_t):
        s = ec_t * _clamped(matvec_T(alpha))
        z = s.sum(-1, keepdim=True)
        return s / z, ll + torch.log(z[..., 0])

    return step


def _scaled_bwd_step(matvec):
    """THE max-normalised sparse backward step: the single source for
    :func:`sparse_backward` and the blocked-adjoint recompute
    (:func:`_blk_lb`); same contract as :func:`_scaled_fwd_step`."""

    def step(beta, ll, ec_next):
        s = _clamped(matvec(ec_next * beta))
        z = s.amax(-1, keepdim=True)
        return s / z, ll + torch.log(z[..., 0])

    return step


def _fwd_start(init, ec_0):
    s0 = ec_0 * _clamped(init)[:, None, :]
    z0 = s0.sum(-1, keepdim=True)
    return s0 / z0, torch.log(z0[..., 0])


def _log_values(vecs, lls):
    """log(vec) + ll for lists of per-position (m, b, q) vectors and (m, b)
    scales; (m, b, T, q)."""
    return torch.log(torch.stack(vecs, dim=2)) + torch.stack(lls, dim=2)[..., None]


def _forward_scan(dp, init, edge_probs, Ec):
    """The forward carries from the clamped emissions ``Ec``: lists of the
    normalised alpha (m, b, q) and its log-scale (m, b) at every position."""
    L = Ec.shape[2]
    step = _scaled_fwd_step(dp.matvec(edge_probs, Ec.shape[:2], transpose=True))
    alpha, ll = _fwd_start(init, Ec[:, :, 0])
    alphas, lls = [alpha], [ll]
    for t in range(1, L):
        alpha, ll = step(alpha, ll, Ec[:, :, t])
        alphas.append(alpha)
        lls.append(ll)
    return alphas, lls


def _backward_scan(dp, edge_probs, Ec):
    """The backward carries (normalised beta, log-scale) at every position,
    in time order."""
    m, b, L, q = Ec.shape
    step = _scaled_bwd_step(dp.matvec(edge_probs, (m, b), transpose=False))
    beta = torch.ones((m, b, q), dtype=Ec.dtype, device=Ec.device)
    ll = torch.zeros((m, b), dtype=Ec.dtype, device=Ec.device)
    betas, lls = [beta], [ll]
    for t in range(L - 2, -1, -1):
        beta, ll = step(beta, ll, Ec[:, :, t + 1])
        betas.append(beta)
        lls.append(ll)
    return betas[::-1], lls[::-1]


def _forward_values(dp, init, edge_probs, Ec):
    """(log alpha (m, b, L, q), loglik (m, b))."""
    alphas, lls = _forward_scan(dp, init, edge_probs, Ec)
    return _log_values(alphas, lls), lls[-1]


def _backward_values(dp, edge_probs, Ec):
    """log beta (m, b, L, q)."""
    return _log_values(*_backward_scan(dp, edge_probs, Ec))


def _plan(indices, E):
    return EdgePlan.cached(indices).on(E.device, E.shape[-1])


def sparse_forward(init, indices, edge_probs, E):
    """Scaled sequential forward with a sparse transition operator.

    Args:
        init: (m, q) initial distribution.
        indices: (n_edges, 2) host (numpy or CPU) (from, to) pairs.
        edge_probs: (m, n_edges) transition probabilities per edge (rows of
            the implied matrix sum to 1 over each state's out-edges).
        E: (m, b, L, q) emission probabilities.

    Returns:
        (log_alpha (m, b, L, q), loglik (m, b)), as
        :func:`hmm_layer_torch.ops.recursion.forward` to float tolerance.
    """
    return _forward_values(_plan(indices, E), init, edge_probs, _clamped(E))


def sparse_backward(indices, edge_probs, E):
    """Scaled sequential backward; log_beta (m, b, L, q)."""
    return _backward_values(_plan(indices, E), edge_probs, _clamped(E))


def sparse_log_likelihood(init, indices, edge_probs, E, analytic_vjp: bool = True):
    """(m, b) log-likelihoods over the edge list.

    ``analytic_vjp=True`` (default) attaches the Baum-Welch adjoint (one
    forward + one backward recompute, O(L·q) residuals); ``False``
    differentiates the loop by autograd (O(L·n_edges·b) residuals).
    """
    if analytic_vjp:
        return _SparseLoglik.apply(EdgePlan.cached(indices), init, edge_probs, E)
    return _loglik_taped(init, indices, edge_probs, E)


def _loglik_taped(init, indices, edge_probs, E):
    return _forward_scan(_plan(indices, E), init, edge_probs, _clamped(E))[1][-1]


def sparse_posterior(
    init,
    indices,
    edge_probs,
    E,
    no_loglik: bool = False,
    analytic_vjp: bool = True,
    backward_block: int | None = None,
):
    """Posterior state log-probabilities; (log_gamma, loglik).

    ``analytic_vjp=True`` (default) attaches the gamma-centered analytic
    adjoint (the edge-list form of the dense engine's posterior VJP);
    ``False`` differentiates the forward and backward loops by autograd.
    ``backward_block`` (or :func:`set_sparse_posterior_block`, seeded by
    ``HMM_SPARSE_POSTERIOR_BLOCK``) selects the time-blocked recompute
    backward: the same math with O(L/c) checkpoints instead of O(L·q)
    residuals and block-local intermediates, for CE training at config-5
    memory scale, at the cost of about two extra recursion passes.
    """
    if not analytic_vjp and backward_block is not None:
        raise ValueError(
            "backward_block requires analytic_vjp=True — the taped path "
            "stores its own O(L·q) residuals and would silently ignore the "
            "memory mode (the set_sparse_posterior_block global only "
            "applies to the analytic path for the same reason)"
        )
    if analytic_vjp:
        block = backward_block if backward_block is not None else _POSTERIOR_BLOCK
        plan = EdgePlan.cached(indices)
        if block:
            L = E.shape[2]
            if L % int(block):
                raise ValueError(f"backward_block {block} must divide L={L}")
            return _SparsePosteriorBlocked.apply(plan, bool(no_loglik), int(block), init, edge_probs, E)
        return _SparsePosterior.apply(plan, bool(no_loglik), init, edge_probs, E)
    return _posterior_taped(init, indices, edge_probs, E, no_loglik)


def _posterior_taped(init, indices, edge_probs, E, no_loglik=False):
    dp = _plan(indices, E)
    Ec = _clamped(E)
    la, ll = _forward_values(dp, init, edge_probs, Ec)
    lg = la + _backward_values(dp, edge_probs, Ec)
    if not no_loglik:
        lg = lg - ll[..., None, None]
    return lg, ll


@torch.no_grad()
def sparse_viterbi(init, indices, edge_probs, E):
    """Max-plus Viterbi decode over the edge list; (m, b, L) int32.

    A backtrace decode (sequential, no chunks): at each position every
    state records its attaining in-edge by a segment-min over the ids of
    the tied edges, so any attaining edge gives a valid optimal path.
    """
    dp = _plan(indices, E)
    m, b, L, q = E.shape
    n = dp.n
    log_w = torch.log(_clamped(edge_probs.index_select(-1, dp.perm_d)))[:, None, :]  # (m, 1, n)
    log_E = torch.log(_clamped(E))
    off = dp.offsets("d", (m, b))
    delta = torch.log(_clamped(init))[:, None, :] + log_E[:, :, 0]
    backptrs = []
    for t in range(1, L):
        contrib = delta.index_select(-1, dp.src_d) + log_w  # (m, b, n)
        best = torch.clamp_min(_segreduce(contrib, "max", off), _NEG)  # unreachable: -inf -> _NEG
        attained = contrib >= best.index_select(-1, dp.dst_d)
        win_edge = _segreduce(torch.where(attained, dp.edge_ids, float(n)), "min", off)
        backptrs.append(dp.src_lookup[win_edge.clamp_max(n).long()])  # (m, b, q) previous state
        delta = best + log_E[:, :, t]
    state = delta.argmax(-1)
    path = [state]
    for bp in reversed(backptrs):
        state = bp.gather(-1, state[..., None])[..., 0]
        path.append(state)
    return torch.stack(path[::-1], dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Analytic gradients (edge-list Baum-Welch and adjoint recursions)
# ---------------------------------------------------------------------------
#
# These mirror the dense engine's analytic VJPs (ops/recursion.py
# _loglik_bw_stats / _posterior_analytic_vjp) with the two dense-A
# touchpoints replaced by edge-list primitives: the affine adjoint solves
# use the plan's matvec (gather + sorted segment sum), and the gA
# contractions become per-edge gathered products summed over time chunks,
# so the backward pass builds nothing O(q²) or O(L · n_edges).


def _sparse_affine_solve(matvec, u, v, c, reverse: bool = True):
    """Sequential solve of ``x_t = c_t + u_t * (B @ (v_t * x_{t+1}))`` with
    ``x_L = 0`` (``reverse``), or of ``x_t = c_t + u_t * (B @ (v_t *
    x_{t-1}))`` with ``x_{-1} = 0``, which is the reverse solve of the
    time-flipped inputs; ``matvec`` applies B."""
    m, b, L, q = c.shape
    x = torch.zeros((m, b, q), dtype=c.dtype, device=c.device)
    xs = []
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        x = c[:, :, t] + u[:, :, t] * matvec(v[:, :, t] * x)
        xs.append(x)
    return torch.stack(xs[::-1] if reverse else xs, dim=2)


def _edge_outer_sum(dp, F, G):
    """``sum_{t,b} F[m,b,t,src_e] * G[m,b,t,dst_e]`` per edge; (m, n) in
    the caller's edge order. Summed over time chunks of at most
    ``_OUTER_SUM_ELEMENTS`` gathered products."""
    m, b, T, _ = F.shape
    acc = torch.zeros((m, dp.n), dtype=F.dtype, device=F.device)
    chunk = max(1, _OUTER_SUM_ELEMENTS // max(1, m * b * dp.n))
    for t0 in range(0, T, chunk):
        f = F[:, :, t0:t0 + chunk].index_select(-1, dp.src_d)
        g = G[:, :, t0:t0 + chunk].index_select(-1, dp.dst_d)
        acc = acc + (f * g).sum(dim=(1, 2))
    return acc.index_select(-1, dp.inv_d)


def _edge_xi(dp, la, lb, log_E, ll, weight):
    """``sum_{b,t} alpha_{t-1}(src_e) E_t(dst_e) beta_t(dst_e) / P(x)`` per
    edge, each sequence's terms times ``weight`` (m, b, 1, 1); (m, n).
    Balanced per-step shifts keep both factors in float32 range (their
    product is O(1); either alone would over/underflow at |ll| ~ L)."""
    csh = la[:, :, :-1].amax(-1, keepdim=True)
    W = torch.exp(la[:, :, :-1] - csh)
    U = torch.exp(lb[:, :, 1:] + log_E[:, :, 1:] - ll[..., None, None] + csh) * weight
    return _edge_outer_sum(dp, W, U)


def _zeros_if_none(ct, like):
    return torch.zeros_like(like) if ct is None else ct


class _SparseLoglik(torch.autograd.Function):
    """Log-likelihood over the edge list with the Baum-Welch VJP:

        dll/dE_t(j) = gamma_t(j) / E_t(j)
        dll/dw_e    = sum_t alpha_{t-1}(src_e) E_t(dst_e) beta_t(dst_e) / P(x)
        dll/dpi(i)  = E_0(i) beta_0(i) / P(x)

    with zero gradient where the init/E EPS clamps bind (edge
    probabilities are not clamped by the recursions, as A is not in the
    dense engine).
    """

    @staticmethod
    def forward(ctx, plan, init, edge_probs, E):
        ctx.plan = plan
        ctx.save_for_backward(init, edge_probs, E)
        return _loglik_taped(init, plan.indices, edge_probs, E)

    @staticmethod
    def backward(ctx, ct):
        init, edge_probs, E = ctx.saved_tensors
        dp = ctx.plan.on(E.device, E.shape[-1])
        Ec = _clamped(E)
        la, ll = _forward_values(dp, init, edge_probs, Ec)
        lb = _backward_values(dp, edge_probs, Ec)
        log_E = torch.log(Ec)
        lgam = la + lb - ll[..., None, None]
        gE = torch.exp(lgam - log_E) * (E >= EPS) * ct[..., None, None]
        ginit = (
            (torch.exp(log_E[:, :, 0] + lb[:, :, 0] - ll[..., None]) * ct[..., None]).sum(1)
            * (init >= EPS)
        )
        return None, ginit, _edge_xi(dp, la, lb, log_E, ll, ct[..., None, None]), gE


def _posterior_adjoint(dp, no_loglik, init, edge_probs, E, la, lb, ll, ct, ct_ll_direct):
    """The edge-list form of the dense gamma-centered posterior adjoint
    (ops/recursion.py ``_posterior_analytic_vjp``, whose docstring derives
    it; everything but the two affine solves and the gA contractions is
    elementwise in q and carries over verbatim). Returns (ginit, g_edge,
    gE)."""
    m, b, L, q = E.shape
    log_E = torch.log(_clamped(E))
    gam = torch.exp(la + lb - ll[..., None, None])

    sig = ct.sum(-1)
    sig_tot = sig.sum(-1)
    ct_ll_eff = ct_ll_direct if no_loglik else ct_ll_direct - sig_tot

    src_c = ct - gam * sig[..., None]
    f, gbar = _rec._forward_adjoint_weights(la, log_E)
    fp, gp, sp, elb = _rec._backward_adjoint_weights(lb, log_E)
    bhat = _sparse_affine_solve(dp.matvec(edge_probs, (m, b), transpose=False), f, gbar, src_c)
    chat = _sparse_affine_solve(dp.matvec(edge_probs, (m, b), transpose=True), gp, fp, src_c, reverse=False)
    # Project out numerical drift along the growing gamma mode (the exact
    # residuals are zero-sum; see the dense derivation).
    bhat = bhat - gam * bhat.sum(-1, keepdim=True)
    chat = chat - gam * chat.sum(-1, keepdim=True)

    K = sig + ct_ll_direct[..., None]
    if no_loglik:
        K = K + sig_tot[..., None]
    gE = (gam * K[..., None] + bhat + chat - ct) / _clamped(E) * (E >= EPS)

    R0 = sig_tot + ct_ll_eff
    bar0 = gam[:, :, 0] * R0[..., None] + bhat[:, :, 0]
    ginit = bar0.sum(1) / _clamped(init) * (init >= EPS)

    kappa = ct_ll_direct + (sig_tot if no_loglik else 0.0)
    F, G_of, csh = _rec._forward_gA_factors(la, log_E)
    xi_u = torch.exp(lb[:, :, 1:] + log_E[:, :, 1:] - ll[..., None, None] + csh) * kappa[..., None, None]
    Fp_of, Gp = _rec._backward_gA_factors(lb, sp, elb)
    g_edge = _edge_outer_sum(dp, F, xi_u + G_of(bhat)) + _edge_outer_sum(dp, Fp_of(chat), Gp)
    return ginit, g_edge, gE


class _SparsePosterior(torch.autograd.Function):
    """Posterior over the edge list with the gamma-centered analytic VJP;
    saves log alpha and log beta (O(L·q); the JAX package saves log gamma
    and subtracts log alpha again, which rounds log beta at the scale of
    the log-likelihood)."""

    @staticmethod
    def forward(ctx, plan, no_loglik, init, edge_probs, E):
        dp = plan.on(E.device, E.shape[-1])
        Ec = _clamped(E)
        la, ll = _forward_values(dp, init, edge_probs, Ec)
        lb = _backward_values(dp, edge_probs, Ec)
        lg = la + lb
        if not no_loglik:
            lg = lg - ll[..., None, None]
        ctx.plan, ctx.no_loglik = plan, no_loglik
        ctx.save_for_backward(init, edge_probs, E, la, lb, ll)
        return lg, ll

    @staticmethod
    def backward(ctx, ct, ct_ll):
        init, edge_probs, E, la, lb, ll = ctx.saved_tensors
        dp = ctx.plan.on(E.device, E.shape[-1])
        grads = _posterior_adjoint(
            dp, ctx.no_loglik, init, edge_probs, E, la, lb, ll,
            _zeros_if_none(ct, E), _zeros_if_none(ct_ll, ll),
        )
        return None, None, *grads


# ---------------------------------------------------------------------------
# FFBS posterior path sampling over edge lists
# ---------------------------------------------------------------------------

# Hard mask of structurally absent transitions (cf. ops/sampling.py _MASK):
# sampling has no gradient, so a hard mask is safe, and the guarantee that
# zero-probability transitions are never sampled needs it.
_SAMPLE_MASK = -1e30


@torch.no_grad()
def sparse_sample_paths(init, indices, edge_probs, E, generator=None, num_samples: int = 1):
    """Exact posterior path samples over the edge list; (m, b, S, L) int32.

    Forward-filter backward-sample (the sequential FFBS of
    :func:`hmm_layer_torch.ops.sampling.sample_posterior`) with the dense
    ``log A[:, s_{t+1}]`` column replaced by a segment-max over the
    source-sorted edges whose destination is the sampled next state: at
    most one edge joins a (src, dst) pair, so the max selects that edge's
    log-weight and every absent transition stays at the -1e30 mask. So
    transitions outside the edge list, or with probability exactly zero,
    are never sampled.

    The Gumbel noise comes from ``generator`` through
    :func:`hmm_layer_torch.ops.sampling._gumbel`, in the JAX function's
    shapes and order: one (m, b, S, q) draw for position L-1, then one per
    step for t = L-2 down to 0 (O(q) live, not O(L·q)).
    """
    dp = _plan(indices, E)
    la, _ = sparse_forward(init, indices, edge_probs, E)
    m, b, L, q = E.shape
    S = num_samples
    w_s = edge_probs.index_select(-1, dp.perm_s)  # (m, n) in src-sorted order
    log_w = torch.where(w_s > 0, torch.log(_clamped(w_s)), _SAMPLE_MASK)[:, None, None, :]
    off = dp.offsets("s", (m, b, S))

    g = _sampling._gumbel((m, b, S, q), generator, E.device)
    s = (la[:, :, -1][:, :, None, :] + g).argmax(-1)
    path = [s]
    for t in range(L - 2, -1, -1):
        g = _sampling._gumbel((m, b, S, q), generator, E.device)
        hit = dp.dst_s == s[..., None]  # (m, b, S, n)
        contrib = torch.where(hit, log_w, _SAMPLE_MASK)
        w_col = torch.clamp_min(_segreduce(contrib, "max", off), _SAMPLE_MASK)  # (m, b, S, q)
        s = (la[:, :, t][:, :, None, :] + w_col + g).argmax(-1)
        path.append(s)
    return torch.stack(path[::-1], dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Baum-Welch EM over edge lists
# ---------------------------------------------------------------------------


def sparse_expected_statistics(init, indices, edge_probs, E):
    """E-step statistics over the edge list.

    Returns:
        gamma: (m, b, L, q) posterior state probabilities (linear).
        xi_edge: (m, n_edges) expected transition counts per edge, summed
            over batch and time (caller edge order): the edge-list form of
            :func:`hmm_layer_torch.ops.em.expected_statistics`' dense
            ``xi_sum``, the loglik VJP's :func:`_edge_xi` times the edge
            probabilities.
        loglik: (m, b).
    """
    dp = _plan(indices, E)
    Ec = _clamped(E)
    la, ll = _forward_values(dp, init, edge_probs, Ec)
    lb = _backward_values(dp, edge_probs, Ec)
    log_E = torch.log(Ec)
    gamma = torch.exp(la + lb - ll[..., None, None])
    return gamma, edge_probs * _edge_xi(dp, la, lb, log_E, ll, 1.0), ll


def sparse_em_step(init, indices, edge_probs, E, pseudocount: float = 0.0):
    """One Baum-Welch update of the init distribution and edge probabilities.

    ``new_init(i) ∝ sum_b gamma_0(i)``; ``new_w_e ∝ xi_edge(e)`` normalised
    over each source state's out-edges (rows stay stochastic over the edge
    support: the grammar gains no transition, as the dense ``em_step``
    keeps its structural zeros). Edges with zero expected count and zero
    pseudocount keep probability 0.

    Returns:
        (new_init (m, q), new_edge_probs (m, n), loglik (m, b)); the loglik
        is the pre-update one (non-decreasing across steps).
    """
    dp = _plan(indices, E)
    gamma, xi_edge, ll = sparse_expected_statistics(init, indices, edge_probs, E)

    init_counts = (gamma[:, :, 0].sum(1) + pseudocount) * (init > 0)
    new_init = init_counts / torch.clamp_min(init_counts.sum(-1, keepdim=True), EPS)

    counts = xi_edge + pseudocount
    row = _segsum(counts.index_select(-1, dp.perm_s), dp.offsets("s", counts.shape[:-1]))  # (m, q)
    row_per_edge = row.index_select(-1, dp.src)
    new_w = torch.where(row_per_edge > 0, counts / torch.clamp_min(row_per_edge, EPS), edge_probs)
    return new_init, new_w, ll


# ---------------------------------------------------------------------------
# Time-blocked recompute backward for the posterior adjoint (memory mode)
# ---------------------------------------------------------------------------
#
# The unblocked posterior VJP saves log alpha and log gamma and its backward
# builds about a dozen O(m·b·L·q) intermediates at once. This variant plays
# the gradient-checkpointing trick: the forward saves only the O(L/c)
# carries (normalised vector and log-scale) of the forward and backward
# recursions at the block borders; the backward runs two passes over time
# blocks (a forward pass solving the chat adjoint, a reverse pass solving
# bhat), recomputing log alpha and log beta within each block from those
# carries with the same step, so the recompute reproduces the forward's
# values bit for bit (the JAX package restarts from the rounded log values
# instead). Its peak memory is the unavoidable O(m·b·L·q) tensors (E,
# the cotangent, gE) plus an O(m·b·c·q) working set. Cost: log alpha and log
# beta are recomputed twice each, about two extra recursion passes a step.

_POSTERIOR_BLOCK = int(os.environ.get("HMM_SPARSE_POSTERIOR_BLOCK", "0")) or None


def set_sparse_posterior_block(block):
    """Set the default time-block size of the sparse posterior backward
    (``None``: the unblocked path) and of the fused cross-entropy; returns
    the previous value. Read at each call."""
    global _POSTERIOR_BLOCK
    prev = _POSTERIOR_BLOCK
    _POSTERIOR_BLOCK = block
    return prev


def _blk_la(dp, edge_probs, init, Ec, k, c, ckpt):
    """Recompute block k of log alpha (m, b, c, q) from its left checkpoint."""
    step = _scaled_fwd_step(dp.matvec(edge_probs, Ec.shape[:2], transpose=True))
    if k == 0:
        alpha, ll = _fwd_start(init, Ec[:, :, 0])
        alphas, lls, t0 = [alpha], [ll], 1
    else:  # the forward carry at position k*c - 1
        alpha, ll = ckpt.alpha[:, :, k - 1], ckpt.alpha_ll[:, :, k - 1]
        alphas, lls, t0 = [], [], k * c
    for t in range(t0, (k + 1) * c):
        alpha, ll = step(alpha, ll, Ec[:, :, t])
        alphas.append(alpha)
        lls.append(ll)
    return _log_values(alphas, lls)


def _blk_lb(dp, edge_probs, Ec, k, c, nb, ckpt):
    """Recompute block k of log beta (m, b, c, q) from its right checkpoint."""
    m, b, L, q = Ec.shape
    step = _scaled_bwd_step(dp.matvec(edge_probs, (m, b), transpose=False))
    if k == nb - 1:
        beta = torch.ones((m, b, q), dtype=Ec.dtype, device=Ec.device)
        ll = torch.zeros((m, b), dtype=Ec.dtype, device=Ec.device)
        betas, lls, t1 = [beta], [ll], L - 2
    else:  # the backward carry at position (k+1)*c
        beta, ll = ckpt.beta[:, :, k], ckpt.beta_ll[:, :, k]
        betas, lls, t1 = [], [], (k + 1) * c - 1
    for t in range(t1, k * c - 1, -1):
        beta, ll = step(beta, ll, Ec[:, :, t + 1])
        betas.append(beta)
        lls.append(ll)
    return _log_values(betas[::-1], lls[::-1])


class _Checkpoints(NamedTuple):
    """The recursions' carries at the block borders: the forward's at
    k*c - 1 (k = 1..nb-1), the backward's at (k+1)*c (k = 0..nb-2);
    (m, b, nb - 1, q) vectors and (m, b, nb - 1) log-scales."""

    alpha: torch.Tensor
    alpha_ll: torch.Tensor
    beta: torch.Tensor
    beta_ll: torch.Tensor


def _stack_at(xs, positions):
    picked = [xs[t] for t in positions]
    if picked:
        return torch.stack(picked, dim=2)
    like = xs[0]
    return like.new_empty(like.shape[:2] + (0,) + like.shape[2:])


def _blocked_forward(dp, init, edge_probs, Ec, c):
    """(log alpha, log beta, loglik, checkpoints) of the blocked modes."""
    L = Ec.shape[2]
    alphas, a_ll = _forward_scan(dp, init, edge_probs, Ec)
    betas, b_ll = _backward_scan(dp, edge_probs, Ec)
    fwd, bwd = range(c - 1, L - 1, c), range(c, L, c)
    ckpt = _Checkpoints(_stack_at(alphas, fwd), _stack_at(a_ll, fwd), _stack_at(betas, bwd), _stack_at(b_ll, bwd))
    return _log_values(alphas, a_ll), _log_values(betas, b_ll), a_ll[-1], ckpt


class _SparsePosteriorBlocked(torch.autograd.Function):
    """Posterior with the two-pass blocked adjoint; saves O(L/c)
    checkpoints."""

    @staticmethod
    def forward(ctx, plan, no_loglik, block, init, edge_probs, E):
        dp = plan.on(E.device, E.shape[-1])
        la, lb, ll, ckpt = _blocked_forward(dp, init, edge_probs, _clamped(E), block)
        lg = la + lb
        if not no_loglik:
            lg = lg - ll[..., None, None]
        ctx.plan, ctx.no_loglik, ctx.block = plan, no_loglik, block
        ctx.save_for_backward(init, edge_probs, E, ll, *ckpt)
        return lg, ll

    @staticmethod
    def backward(ctx, ct, ct_ll):
        init, edge_probs, E, ll, *ckpt = ctx.saved_tensors
        ct = _zeros_if_none(ct, E)
        c = ctx.block
        grads = _blocked_posterior_adjoint(
            ctx.plan.on(E.device, E.shape[-1]), ctx.no_loglik, c, init, edge_probs, E, ll,
            _Checkpoints(*ckpt), lambda k: ct[:, :, k * c:(k + 1) * c], ct.sum(-1),
            _zeros_if_none(ct_ll, ll),
        )
        return None, None, None, *grads


def _blocked_posterior_adjoint(
    dp, no_loglik, block, init, edge_probs, E, ll, ckpt, ct_blk, sig, ct_ll_direct,
):
    """Core of the blocked posterior backward, over any posterior
    cotangent: ``ct_blk(k) -> (m, b, c, q)`` builds one block of it at a
    time and ``sig`` is its per-position sum over states (O(m·b·L), no q
    axis). The fused CE objective uses this: its cotangent is a scaled
    one-hot of the labels, so the full (m, b, L, q) tensor never exists."""
    m, b, L, q = E.shape
    c = block
    nb = L // c
    Ec = _clamped(E)
    mv = dp.matvec(edge_probs, (m, b), transpose=False)
    mv_T = dp.matvec(edge_probs, (m, b), transpose=True)

    sig_tot = sig.sum(-1)  # (m, b)
    ct_ll_eff = ct_ll_direct if no_loglik else ct_ll_direct - sig_tot
    K = sig + ct_ll_direct[..., None]
    if no_loglik:
        K = K + sig_tot[..., None]
    kappa = ct_ll_direct + (sig_tot if no_loglik else 0.0)

    def blk(x, k):
        return x[:, :, k * c:(k + 1) * c]

    def proj(x, gam):
        return x - gam * x.sum(-1, keepdim=True)

    def zeros():
        return torch.zeros((m, b, q), dtype=E.dtype, device=E.device)

    # ---- pass A (forward over blocks): the chat adjoint and its terms ----
    chat_raw = zeros()  # chat at k*c - 1
    chat_prev_proj = zeros()
    lb_prev = zeros()
    g_edge2 = torch.zeros((m, dp.n), dtype=E.dtype, device=E.device)
    gE_A_blocks = []
    for k in range(nb):
        la_b = _blk_la(dp, edge_probs, init, Ec, k, c, ckpt)
        lb_b = _blk_lb(dp, edge_probs, Ec, k, c, nb, ckpt)
        lE_b = torch.log(blk(Ec, k))  # block-local, not O(L·q)
        ct_b = ct_blk(k)
        gam_b = torch.exp(la_b + lb_b - ll[..., None, None])
        src_c_b = ct_b - gam_b * blk(sig[..., None], k)
        elb_b = lE_b + lb_b
        sp_b = elb_b.amax(-1, keepdim=True)
        gp_b = torch.exp(elb_b - sp_b)
        # fp[t] = exp(sp[t] - lb[t-1]); t = k*c uses the carry (0 for k = 0)
        lb_shift = torch.cat([lb_prev[:, :, None], lb_b[:, :, :-1]], dim=2)
        fp_b = torch.exp(sp_b - lb_shift)
        if k == 0:
            fp_b[:, :, 0] = 0.0
        x = chat_raw
        chat_list = []
        for t in range(c):
            x = src_c_b[:, :, t] + gp_b[:, :, t] * mv_T(fp_b[:, :, t] * x)
            chat_list.append(x)
        chat_raw = x
        chat_pb = proj(torch.stack(chat_list, dim=2), gam_b)
        gE_A_blocks.append(
            (gam_b * blk(K[..., None], k) + chat_pb - ct_b) / blk(Ec, k) * (blk(E, k) >= EPS)
        )
        # g_edge term 2, the pairs owned by this block: t in [k*c-1, k*c+c-2]
        Fp_pair = torch.cat([chat_prev_proj[:, :, None], chat_pb[:, :, :-1]], dim=2) * torch.exp(
            sp_b - lb_shift
        )
        Gp_pair = torch.exp(elb_b - sp_b)
        if k == 0:  # no pair at t = -1
            Fp_pair, Gp_pair = Fp_pair[:, :, 1:], Gp_pair[:, :, 1:]
        g_edge2 = g_edge2 + _edge_outer_sum(dp, Fp_pair, Gp_pair)
        chat_prev_proj = chat_pb[:, :, -1]
        lb_prev = lb_b[:, :, -1]

    # ---- pass B (reverse over blocks): the bhat adjoint and its terms ----
    bhat_raw = zeros()  # bhat at (k+1)*c
    bhat_next_proj = zeros()
    la_next, lb_next, lE_next = zeros(), zeros(), zeros()
    g_edge1 = torch.zeros((m, dp.n), dtype=E.dtype, device=E.device)
    gE_blocks = [None] * nb
    ginit = None
    for k in range(nb - 1, -1, -1):
        la_b = _blk_la(dp, edge_probs, init, Ec, k, c, ckpt)
        lb_b = _blk_lb(dp, edge_probs, Ec, k, c, nb, ckpt)
        lE_b = torch.log(blk(Ec, k))
        gam_b = torch.exp(la_b + lb_b - ll[..., None, None])
        src_c_b = ct_blk(k) - gam_b * blk(sig[..., None], k)
        s_b = la_b.amax(-1, keepdim=True)
        f_b = torch.exp(la_b - s_b)
        # gbar[t] = exp(logE[t+1] + s[t] - la[t+1]); t = (k+1)c-1 uses the carry
        la_shift = torch.cat([la_b[:, :, 1:], la_next[:, :, None]], dim=2)
        lE_shift = torch.cat([lE_b[:, :, 1:], lE_next[:, :, None]], dim=2)
        gbar_b = torch.exp(lE_shift + s_b - la_shift)
        if k == nb - 1:
            gbar_b[:, :, -1] = 0.0
        x = bhat_raw
        bhat_list = []
        for t in range(c - 1, -1, -1):
            x = src_c_b[:, :, t] + f_b[:, :, t] * mv(gbar_b[:, :, t] * x)
            bhat_list.append(x)
        bhat_raw = x
        bhat_pb = proj(torch.stack(bhat_list[::-1], dim=2), gam_b)
        # this block's pass-A part folds in here: one final concatenation
        gE_blocks[k] = gE_A_blocks[k] + bhat_pb / blk(Ec, k) * (blk(E, k) >= EPS)
        gE_A_blocks[k] = None
        # g_edge term 1, the pairs owned by this block: t in [k*c, (k+1)c-1]
        # (the pair at t = (k+1)c-1 takes position (k+1)c from the carries;
        # the last block has no such pair)
        F_pair = torch.exp(la_b - s_b)
        lb_shift = torch.cat([lb_b[:, :, 1:], lb_next[:, :, None]], dim=2)
        bh_shift = torch.cat([bhat_pb[:, :, 1:], bhat_next_proj[:, :, None]], dim=2)
        xi_u_b = torch.exp(lb_shift + lE_shift - ll[..., None, None] + s_b) * kappa[..., None, None]
        G1_pair = xi_u_b + bh_shift * torch.exp(lE_shift - la_shift + s_b)
        if k == nb - 1:  # no pair at t = L-1
            F_pair, G1_pair = F_pair[:, :, :-1], G1_pair[:, :, :-1]
        g_edge1 = g_edge1 + _edge_outer_sum(dp, F_pair, G1_pair)
        bhat_next_proj = bhat_pb[:, :, 0]
        la_next, lb_next, lE_next = la_b[:, :, 0], lb_b[:, :, 0], lE_b[:, :, 0]
        if k == 0:
            R0 = sig_tot + ct_ll_eff
            bar0 = gam_b[:, :, 0] * R0[..., None] + bhat_pb[:, :, 0]
            ginit = bar0.sum(1) / _clamped(init) * (init >= EPS)

    return ginit, g_edge1 + g_edge2, torch.cat(gE_blocks, dim=2)


# ---------------------------------------------------------------------------
# Fused posterior cross-entropy (supervised training at config-5 memory scale)
# ---------------------------------------------------------------------------


def sparse_posterior_cross_entropy(
    init,
    indices,
    edge_probs,
    E,
    labels,
    label_mask=None,
    no_loglik: bool = False,
    backward_block: int | None = None,
):
    """Mean label cross-entropy of the sparse posterior, fused to a scalar.

    Exactly ``-mean(gather(sparse_posterior(...)[0], labels))``
    (mask-weighted when ``label_mask`` is given: the sum over the mask's
    sum, at least 1), but the (m, b, L, q) posterior and its cotangent
    never exist: the backward runs the blocked gamma-centered adjoint with
    the cotangent built per block as a scaled one-hot of the labels.
    ``backward_block`` defaults to :func:`set_sparse_posterior_block`'s
    value, else one block of length L. ``label_mask`` receives its true
    gradient (a soft or learned mask is a real operand).
    """
    plan = EdgePlan.cached(indices)
    L = E.shape[2]
    block = backward_block if backward_block is not None else _POSTERIOR_BLOCK
    block = int(block) if block else L
    if L % block:
        raise ValueError(f"backward_block {block} must divide L={L}")
    labels = torch.as_tensor(labels, device=E.device)
    if labels.dim() == E.dim() - 2:
        labels = labels[None]
    labels = labels.expand(E.shape[:3]).long()
    if label_mask is None:
        w = torch.ones(E.shape[:3], dtype=E.dtype, device=E.device)
    else:
        w = torch.as_tensor(label_mask, dtype=E.dtype, device=E.device).expand(E.shape[:3])
    return _SparseCEFused.apply(plan, bool(no_loglik), block, init, edge_probs, E, labels, w)


class _SparseCEFused(torch.autograd.Function):
    """The fused cross-entropy: forward through log alpha and log beta,
    backward through :func:`_blocked_posterior_adjoint` with a one-hot
    cotangent built per block."""

    @staticmethod
    def forward(ctx, plan, no_loglik, block, init, edge_probs, E, labels, w):
        dp = plan.on(E.device, E.shape[-1])
        la, lb, ll, ckpt = _blocked_forward(dp, init, edge_probs, _clamped(E), block)
        lab = labels[..., None]
        lg_lab = la.gather(-1, lab)[..., 0] + lb.gather(-1, lab)[..., 0]
        if not no_loglik:
            lg_lab = lg_lab - ll[..., None]
        ce = -(lg_lab * w).sum() / torch.clamp_min(w.sum(), 1.0)
        ctx.plan, ctx.no_loglik, ctx.block = plan, no_loglik, block
        # lg_lab and ce ride along for the label_mask gradient: O(m·b·L).
        ctx.save_for_backward(init, edge_probs, E, ll, labels, w, lg_lab, ce, *ckpt)
        return ce

    @staticmethod
    def backward(ctx, g):
        init, edge_probs, E, ll, labels, w, lg_lab, ce, *ckpt = ctx.saved_tensors
        m, b, L, q = E.shape
        c = ctx.block
        N = torch.clamp_min(w.sum(), 1.0)
        sig = w * (-g / N)  # per-position sum over q of the one-hot cotangent

        def ct_blk(k):
            lab_b = labels[:, :, k * c:(k + 1) * c, None]
            sig_b = sig[:, :, k * c:(k + 1) * c, None]
            return torch.zeros((m, b, c, q), dtype=E.dtype, device=E.device).scatter_(-1, lab_b, sig_b)

        ginit, g_edge, gE = _blocked_posterior_adjoint(
            ctx.plan.on(E.device, q), ctx.no_loglik, c, init, edge_probs, E, ll, _Checkpoints(*ckpt),
            ct_blk, sig, torch.zeros_like(ll),
        )
        # d ce / d w_t: the quotient rule on -S/N with N = max(sum(w), 1);
        # the -ce/N term exists only while the clamp is inactive (sum(w) > 1;
        # below it N is the constant 1 and only the numerator varies).
        dN = (w.sum() > 1.0).to(w.dtype)
        g_w = g * (-lg_lab - ce * dN) / N
        return None, None, None, ginit, g_edge, gE, None, g_w
