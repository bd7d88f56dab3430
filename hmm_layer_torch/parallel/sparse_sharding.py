"""State-sharded sparse HMM recursions over partitioned COO edge lists
(port of ``hmm_layer_tpu/parallel/sparse_sharding.py``) over
``torch.distributed``.

The distributed form of the large-q sparse engine (:mod:`..ops.sparse`;
config 5, ``q = 1 + 14k`` multi-copy gene-pred grammars whose dense
``(q, q)`` matrix is not built). The edge list is partitioned by the
DESTINATION state block for the forward direction (by the SOURCE block for
the backward), so each rank computes exactly its ``q_local = q_pad / n``
slice of every recursion vector with a sorted segment sum over its own
edges. The per-step collectives are one all-gather of the ``(m, b,
q_local)`` carry and one reduction for the normaliser (a sum forward, a max
backward): O(q) bytes a step, as the dense state route, with
O(n_edges / n · b) work a step instead of O(q² / n · b).

What state sharding buys the sparse engine:

* CAPACITY, not speed. Sparse grammars have ``n_edges ≈ 1.6 q`` edges, so
  the work of a step is tiny and the scan is latency-bound; per-step
  collectives can only slow a step down. The gain is that the recursions'
  O(L·q) intermediates (the forward and backward variables, the Viterbi
  backpointers during the scan) and the Baum-Welch VJP's residuals are
  ``1/n`` per rank. Two modes:

  - global (``local=False``, the default): every rank is given the GLOBAL
    ``init``, ``edge_probs`` and ``E`` and returns the global result, so a
    rank holds the whole ``E`` and the gathered outputs;
  - rank-local (``local=True``): ``init`` and ``edge_probs`` stay global,
    but ``E`` comes in and log gamma goes out as the rank's (m, b_l, L,
    q_l) block (JAX's ``P(None, data_axis, None, state_axis)`` specs), the
    loglik as its rows (m, b_l), the paths as (m, b_l, L)
    (:func:`~.collectives.local_ranges` gives the ranges), so every
    O(L·q) tensor of the call is ``1/n`` per rank. The one exception is
    the decode's all-gather of its int32 backpointers for the backtrace
    (as JAX backtraces on the global view). Gradients: the ``E`` block's
    is the rank's block of the global gradient; ``init``'s and
    ``edge_probs``'s are the global ones on every rank.
* Training: :func:`edge_sharded_log_likelihood` carries the sharded
  Baum-Welch VJP (an ``autograd.Function``; its backward recomputes the
  forward and backward variables as local blocks);
  :func:`edge_sharded_posterior` is differentiated by taping the scans
  (its per-step residuals include the gathered full-q carry, so CE
  training does not get the memory gain).

``q`` need not divide the axis size: states are padded to a multiple
(``q_pad``) with edge-less, zero-init, zero-emission states whose scaled
mass is EPS² ≈ 1e-32 a step (invisible in float32 against normalisers of
the order of the mean emission); outputs are sliced back to ``q``. ``E``'s
batch rows must divide the data axis (a ``ValueError`` otherwise, as
``shard_map`` raises).

The edge order inside each destination's run is the single-device plan's
(``EdgePlan.perm_d``: a stable sort by destination), so the segment sums
add in the same order and the decode's segment-min over edge ids picks the
same edge as :func:`~hmm_layer_torch.ops.sparse.sparse_viterbi`. Unlike
the JAX plan, a rank holds only its own bucket's edges: no weight-0
padding to the largest bucket (each rank's shapes are its own).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.semiring import EPS
from ..ops.sparse import (
    _NEG,
    _OUTER_SUM_ELEMENTS,
    _clamped,
    _host_indices,
    _log_values,
    _offsets,
    _segreduce,
    _segsum,
)
from . import collectives as C
from .collectives import Mesh

__all__ = [
    "ShardedEdgePlan",
    "edge_sharded_log_likelihood",
    "edge_sharded_posterior",
    "edge_sharded_viterbi",
]

class _Bucket(NamedTuple):
    """One shard's edges of one direction, sorted stably by their
    reduction key: caller-order edge ids, local reduction key (destination
    forward, source backward, minus the block's first state) and the other
    endpoint (global)."""

    sel: np.ndarray
    key: np.ndarray
    other: np.ndarray


class ShardedEdgePlan:
    """Host-side partition of a COO edge list over the state blocks of a
    mesh axis of ``n_shards`` ranks.

    For each direction the edges are bucketed by the block of their
    reduction key (``fwd``: by destination, ``bwd``: by source) and sorted
    stably by that key within the bucket; ``fwd[d]`` / ``bwd[d]`` are shard
    ``d``'s buckets. Memoised on the index bytes by :meth:`cached`;
    :meth:`on` gives a shard's index tensors on a device.
    """

    def __init__(self, indices, q: int, n_shards: int):
        indices = np.ascontiguousarray(_host_indices(indices), np.int64)
        self.indices = indices
        self.n = indices.shape[0]
        self.q = int(q)
        self.n_shards = int(n_shards)
        self.q_pad = -(-self.q // self.n_shards) * self.n_shards
        self.q_local = self.q_pad // self.n_shards
        if self.n and int(indices.max()) >= self.q:
            raise ValueError(f"edge indices reach state {int(indices.max())}, but q = {self.q}")
        self.fwd = self._partition(key_col=1)
        self.bwd = self._partition(key_col=0)
        # The largest forward bucket: it sizes the edge gradient's time
        # chunks, which every rank must cut alike (one collective each).
        self.n_max = max(len(b.sel) for b in self.fwd)
        self._devices = {}

    def _partition(self, key_col: int) -> list[_Bucket]:
        key = self.indices[:, key_col]
        blocks = key // self.q_local
        out = []
        for d in range(self.n_shards):
            sel = np.nonzero(blocks == d)[0]
            sel = sel[np.argsort(key[sel], kind="stable")]
            out.append(_Bucket(sel, key[sel] - d * self.q_local, self.indices[sel, 1 - key_col]))
        return out

    @staticmethod
    def cached(indices, q: int, n_shards: int) -> "ShardedEdgePlan":
        """Memoised constructor, keyed on the index bytes (as int64), q and
        the shard count."""
        arr = np.ascontiguousarray(_host_indices(indices), np.int64)
        return _plan_cached(arr.shape[0], arr.tobytes(), int(q), int(n_shards))

    def on(self, device, shard: int) -> "_ShardPlan":
        """Shard ``shard``'s index tensors on ``device`` (built once)."""
        key = (torch.device(device), int(shard))
        plan = self._devices.get(key)
        if plan is None:
            plan = self._devices[key] = _ShardPlan(self, *key)
        return plan


@lru_cache(maxsize=16)
def _plan_cached(n, index_bytes, q, n_shards):
    return ShardedEdgePlan(np.frombuffer(index_bytes, np.int64).reshape(n, 2), q, n_shards)


class _ShardPlan:
    """One shard's index tensors on one device, and the segment bounds
    expanded to each leading shape they are used with. Made outside
    inference mode, so that autograd can save them later."""

    def __init__(self, plan: ShardedEdgePlan, device: torch.device, shard: int):
        fwd, bwd = plan.fwd[shard], plan.bwd[shard]
        with torch.inference_mode(False):

            def tensor(a):
                return torch.tensor(np.asarray(a, np.int64), device=device)

            self.f_sel, self.f_key, self.f_other = tensor(fwd.sel), tensor(fwd.key), tensor(fwd.other)
            self.b_sel, self.b_other = tensor(bwd.sel), tensor(bwd.other)
            # Viterbi: the winning in-edge's source; local edge id k is the
            # sentinel of a state without in-edges.
            self.src_lookup = tensor(np.concatenate([fwd.other, [0]]))
            self.edge_ids = torch.arange(len(fwd.sel), dtype=torch.float32, device=device)
            self._bounds = {"f": tensor(_offsets(fwd.key, plan.q_local)), "b": tensor(_offsets(bwd.key, plan.q_local))}
        self.k = len(fwd.sel)
        self._expanded = {}

    def offsets(self, by: str, lead) -> torch.Tensor:
        """Segment bounds of the forward (``"f"``) or backward (``"b"``)
        bucket for data of leading shape ``lead``."""
        key = (by, tuple(lead))
        off = self._expanded.get(key)
        if off is None:
            with torch.inference_mode(False):
                bounds = self._bounds[by]
                off = self._expanded[key] = bounds.expand(tuple(lead) + bounds.shape).contiguous()
        return off


class _Local(NamedTuple):
    """This rank's part of a call: its shard plan, init columns (m, q_l),
    clamped emission block (m, b_l, L, q_l), the unclamped block (for the
    gradient masks; under ``local`` its real states only) and the edge
    weights of its forward and backward buckets (m, 1, k)."""

    sp: _ShardPlan
    init: torch.Tensor
    Ec: torch.Tensor
    E: torch.Tensor
    wf: torch.Tensor
    wb: torch.Tensor


def _local(plan, mesh, state_axis, data_axis, init, edge_probs, E, local=False) -> _Local:
    """This rank's block of the inputs. ``init`` and ``edge_probs`` enter
    through ``replicated``; the global ``E`` through ``scatter`` (data rows,
    then state columns after padding q to ``q_pad``), so taped gradients
    are those of the global inputs on every rank. Under ``local`` ``E`` is
    the rank's block already (its real states), padded here to
    ``q_local`` (the clamped block is padded, so no padded copy of ``E``
    lives through the call)."""
    idx = mesh.index(state_axis)
    ql, pad = plan.q_local, plan.q_pad - plan.q
    sp = plan.on(E.device, idx)
    axes = (state_axis, data_axis)
    init, probs = C.replicated(init, mesh, axes), C.replicated(edge_probs, mesh, axes)
    if pad:
        init = F.pad(init, (0, pad))
    if local:
        start, stop = C.state_block(plan.q, plan.n_shards, idx)
        real = stop - start
        if E.shape[-1] != real:
            raise ValueError(f"local E has {E.shape[-1]} states; shard {idx} holds {real} (local_ranges)")
        E_l, Ec = E, _clamped(E)
        if real < ql:
            Ec = F.pad(Ec, (0, ql - real), value=EPS)
    else:
        E = C.scatter(E, mesh, data_axis, 1)
        if pad:
            E = F.pad(E, (0, pad))
        E_l = C.scatter(E, mesh, state_axis, 3)
        Ec = _clamped(E_l)
    return _Local(
        sp,
        init[:, idx * ql:(idx + 1) * ql],
        Ec,
        E_l,
        probs.index_select(-1, sp.f_sel)[:, None, :],
        probs.index_select(-1, sp.b_sel)[:, None, :],
    )


def _fwd_scan(loc: _Local, mesh, axis, want_outputs: bool):
    """This rank's slice of the scaled forward (the step of
    ``ops.sparse._scaled_fwd_step`` over the gathered carry): (log alpha
    (m, b, L, q_l) or None, loglik (m, b)). Two collectives a step: the
    carry's all-gather and the normaliser's sum."""
    Ec, sp = loc.Ec, loc.sp
    m, b, L, _ = Ec.shape
    off = sp.offsets("f", (m, b))
    s = Ec[:, :, 0] * _clamped(loc.init)[:, None, :]
    z = C.psum_ad(s.sum(-1, keepdim=True), mesh, axis)
    alpha, ll = s / z, torch.log(z[..., 0])
    alphas, lls = [alpha], [ll]
    for t in range(1, L):
        full = C.all_gather_ad(alpha, mesh, axis, dim=-1)
        s = Ec[:, :, t] * _clamped(_segsum(full.index_select(-1, sp.f_other) * loc.wf, off))
        z = C.psum_ad(s.sum(-1, keepdim=True), mesh, axis)
        alpha, ll = s / z, ll + torch.log(z[..., 0])
        if want_outputs:
            alphas.append(alpha)
            lls.append(ll)
    return (_log_values(alphas, lls) if want_outputs else None), ll


def _global_max(s, mesh, axis):
    """(m, b, 1) max of ``s`` over every rank's states: the ranks' maxima
    all-gathered, then ``amax``, as the JAX function does (``lax.pmax`` has
    no JVP there). Its gradient splits equally among ties, as ``jnp.max``'s
    does; in the emitted log beta the normaliser cancels except where the
    EPS clamp binds."""
    return C.all_gather_ad(s.amax(-1, keepdim=True), mesh, axis, dim=-1).amax(-1, keepdim=True)


def _bwd_scan(loc: _Local, mesh, axis):
    """This rank's slice of the scaled backward (the step of
    ``ops.sparse._scaled_bwd_step``): log beta (m, b, L, q_l). Two
    collectives a step: the all-gather of ``e ⊙ beta`` and the global
    max."""
    Ec, sp = loc.Ec, loc.sp
    m, b, L, ql = Ec.shape
    off = sp.offsets("b", (m, b))
    beta = torch.ones((m, b, ql), dtype=Ec.dtype, device=Ec.device)
    ll = torch.zeros((m, b), dtype=Ec.dtype, device=Ec.device)
    betas, lls = [beta], [ll]
    for t in range(L - 2, -1, -1):
        full = C.all_gather_ad(Ec[:, :, t + 1] * beta, mesh, axis, dim=-1)
        s = _clamped(_segsum(full.index_select(-1, sp.b_other) * loc.wb, off))
        z = _global_max(s, mesh, axis)
        beta, ll = s / z, ll + torch.log(z[..., 0])
        betas.append(beta)
        lls.append(ll)
    return _log_values(betas[::-1], lls[::-1])


def _plan_for(indices, init, mesh, state_axis) -> ShardedEdgePlan:
    return ShardedEdgePlan.cached(indices, init.shape[-1], mesh.shape[state_axis])


# ---------------------------------------------------------------------------
# Log-likelihood with the sharded Baum-Welch VJP
# ---------------------------------------------------------------------------


def edge_sharded_log_likelihood(
    init,
    indices,
    edge_probs,
    E,
    mesh: Mesh,
    state_axis: str = "state",
    data_axis: str | None = None,
    local: bool = False,
):
    """(m, b) log-likelihoods with the states split over ``state_axis``
    (and the batch rows over ``data_axis``).

    Args:
        init: (m, q); indices: (n_edges, 2) host (numpy or CPU) (from, to)
            pairs; edge_probs: (m, n_edges) — global, on every rank.
        E: (m, b, L, q), the global emissions on every rank; under
            ``local`` the rank's block (m, b_l, L, q_l) of its rows and
            real states (:func:`~.collectives.local_ranges`, route
            ``"edge"``), and the result is its rows' (m, b_l).

    Differentiable through the sharded Baum-Welch VJP, whose per-rank
    residuals are O(L·q_local·b_local) local blocks (nothing O(L·q_pad) is
    built), unlike taped autodiff through the gathered carries. Under
    ``local`` the gradient of ``E`` is the rank's block of the global one.
    """
    plan = _plan_for(indices, init, mesh, state_axis)
    return _EdgeLoglik.apply(init, edge_probs, E, plan, mesh, state_axis, data_axis, local)


def _edge_grad(loc: _Local, la, lb, log_E, ll, ct, plan, mesh, axis):
    """``sum_{b,t} alpha_{t-1}(src_e) E_t(dst_e) beta_t(dst_e) / P(x)``
    times ``ct`` for this rank's destination bucket, in caller edge order
    (zero elsewhere): (m, n). The per-step shift is the GLOBAL max of log
    alpha (the single-device ``_edge_xi``'s). The sources' alpha is
    all-gathered in time chunks of at most ``_OUTER_SUM_ELEMENTS`` gathered
    products (one collective a chunk, the same chunks on every rank), not
    once a step as in the JAX scan, and nothing O(L·q_pad) is kept."""
    sp = loc.sp
    csh = C.pmax(la[:, :, :-1].amax(-1, keepdim=True), mesh, axis)
    W = torch.exp(la[:, :, :-1] - csh)
    U = torch.exp(lb[:, :, 1:] + log_E[:, :, 1:] - ll[..., None, None] + csh) * ct[..., None, None]
    m, b, T, _ = W.shape
    acc = torch.zeros((m, sp.k), dtype=W.dtype, device=W.device)
    chunk = max(1, _OUTER_SUM_ELEMENTS // (m * b * max(plan.n_max, plan.q_pad)))
    for t0 in range(0, T, chunk):
        f = C.all_gather(W[:, :, t0:t0 + chunk], mesh, axis, dim=-1).index_select(-1, sp.f_other)
        g = U[:, :, t0:t0 + chunk].index_select(-1, sp.f_key)
        acc = acc + (f * g).sum(dim=(1, 2))
    return torch.zeros((m, plan.n), dtype=W.dtype, device=W.device).index_copy_(-1, sp.f_sel, acc)


class _EdgeLoglik(torch.autograd.Function):
    """Edge-sharded log-likelihood with the Baum-Welch VJP of
    ``ops.sparse._SparseLoglik`` (see there for the formulas), computed
    from local blocks: ``gE`` and ``ginit`` per rank (gathered over the
    state columns, ``ginit`` summed over the data rows), the edge gradient
    per destination bucket, summed over the state and data ranks (each edge
    lives in one bucket, so the state sum adds disjoint parts). Every rank
    returns the global gradients of ``init`` and the edge probabilities,
    and of ``E`` the global one, or under ``local`` its own block."""

    @staticmethod
    def forward(ctx, init, edge_probs, E, plan, mesh, state_axis, data_axis, local):
        ctx.args = (plan, mesh, state_axis, data_axis, local)
        ctx.save_for_backward(init, edge_probs, E)
        loc = _local(plan, mesh, state_axis, data_axis, init, edge_probs, E, local)
        _, ll = _fwd_scan(loc, mesh, state_axis, want_outputs=False)
        return ll if local else C.gather(ll, mesh, data_axis, 1)

    @staticmethod
    def backward(ctx, ct):
        plan, mesh, state_axis, data_axis, local = ctx.args
        init, edge_probs, E = ctx.saved_tensors
        loc = _local(plan, mesh, state_axis, data_axis, init, edge_probs, E, local)
        if not local:
            ct = C.block(ct, mesh, data_axis, 1)
        la, ll = _fwd_scan(loc, mesh, state_axis, want_outputs=True)
        lb = _bwd_scan(loc, mesh, state_axis)
        log_E = torch.log(loc.Ec)
        lgam = la + lb - ll[..., None, None]
        real = loc.E.shape[-1]  # q_l, or under local the real states
        gE = torch.exp(lgam - log_E)[..., :real] * (loc.E >= EPS) * ct[..., None, None]
        ginit = (
            (torch.exp(log_E[:, :, 0] + lb[:, :, 0] - ll[..., None]) * ct[..., None]).sum(1)
            * (loc.init >= EPS)
        )
        g_edge = _edge_grad(loc, la, lb, log_E, ll, ct, plan, mesh, state_axis)
        q = plan.q
        ginit = C.all_gather(C.psum(ginit, mesh, data_axis), mesh, state_axis, -1)[..., :q]
        if not local:
            gE = C.gather(C.gather(gE, mesh, state_axis, 3), mesh, data_axis, 1)[..., :q]
        g_edge = C.psum(g_edge, mesh, (state_axis, data_axis))
        return ginit, g_edge, gE, None, None, None, None, None


# ---------------------------------------------------------------------------
# Posterior (taped) and Viterbi
# ---------------------------------------------------------------------------


def edge_sharded_posterior(
    init,
    indices,
    edge_probs,
    E,
    mesh: Mesh,
    state_axis: str = "state",
    data_axis: str | None = None,
    no_loglik: bool = False,
    local: bool = False,
):
    """Posterior state log-probabilities with the states split;
    (log_gamma (m, b, L, q), loglik (m, b)).

    Under ``local`` the rank passes its block of ``E`` (m, b_l, L, q_l),
    its rows and real states (:func:`~.collectives.local_ranges`, route
    ``"edge"``; the function pads the block to ``q_local`` itself), and
    gets back log gamma on the same block and its rows' loglik (m, b_l):
    no rank holds a global (m, b, L, q) tensor.

    Differentiable by TAPING the sharded scans (``psum_ad`` and
    ``all_gather_ad`` inside the recursions): exact, but each step's
    residuals include the gathered full-q carry, so training through the
    posterior does not get the per-rank memory gain of the recursions;
    the MAP objective (:func:`edge_sharded_log_likelihood`) does.
    """
    plan = _plan_for(indices, init, mesh, state_axis)
    loc = _local(plan, mesh, state_axis, data_axis, init, edge_probs, E, local)
    la, ll = _fwd_scan(loc, mesh, state_axis, want_outputs=True)
    lg = la + _bwd_scan(loc, mesh, state_axis)
    if not no_loglik:
        lg = lg - ll[..., None, None]
    ll = C.replicated_out(ll, mesh, state_axis)
    if local:
        return lg[..., :E.shape[-1]], ll
    lg = C.gather(C.gather(lg, mesh, state_axis, 3), mesh, data_axis, 1)[..., :plan.q]
    return lg, C.gather(ll, mesh, data_axis, 1)


@torch.no_grad()
def edge_sharded_viterbi(
    init,
    indices,
    edge_probs,
    E,
    mesh: Mesh,
    state_axis: str = "state",
    data_axis: str | None = None,
    local: bool = False,
):
    """Max-plus Viterbi decode with the states split; (m, b, L) int32, or
    under ``local`` (``E`` the rank's block, as
    :func:`edge_sharded_posterior` takes it) its rows' paths (m, b_l, L).

    The delta recursion runs sharded, each rank over its destination
    bucket: one all-gather of delta a step, a segment max, and the lowest
    attaining edge id by a segment min (the single-device edge order, so
    the same edge as :func:`~hmm_layer_torch.ops.sparse.sparse_viterbi`).
    Padded states are held at -1e30 and never win. The backpointers stay
    local during the scan; one all-gather of the (L-1, m, b, q_local) int32
    blocks at the end gives the global view, on which the O(L·b) backtrace
    runs (``argmax`` takes the first maximum, as JAX's does); this gather,
    O(L·b_l·q_pad) int32, is the one global-size buffer of the local mode.
    """
    plan = _plan_for(indices, init, mesh, state_axis)
    loc = _local(plan, mesh, state_axis, data_axis, init, edge_probs, E, local)
    sp = loc.sp
    m, b, L, ql = loc.Ec.shape
    off = sp.offsets("f", (m, b))
    log_w = torch.log(_clamped(loc.wf))  # (m, 1, k)
    log_E = torch.log(loc.Ec)
    states = mesh.index(state_axis) * ql + torch.arange(ql, device=log_E.device)
    real = states < plan.q
    delta = torch.where(real, torch.log(_clamped(loc.init))[:, None, :] + log_E[:, :, 0], _NEG)
    backptrs = torch.empty((L - 1, m, b, ql), dtype=torch.int32, device=log_E.device)
    for t in range(1, L):
        contrib = C.all_gather(delta, mesh, state_axis, dim=-1).index_select(-1, sp.f_other) + log_w  # (m, b, k)
        best = torch.clamp_min(_segreduce(contrib, "max", off), _NEG)  # unreachable: -inf -> _NEG
        attained = contrib >= best.index_select(-1, sp.f_key)
        win_edge = _segreduce(torch.where(attained, sp.edge_ids, float(sp.k)), "min", off)
        backptrs[t - 1] = sp.src_lookup[win_edge.clamp_max(sp.k).long()]  # (m, b, q_l)
        delta = torch.where(real, best + log_E[:, :, t], _NEG)
    state = C.all_gather(delta, mesh, state_axis, dim=-1).argmax(-1)
    path = [state]
    if L > 1:
        shards = C.all_gather(backptrs, mesh, state_axis)  # (n, L-1, m, b, q_l), shard d's states d·q_l + j
        rows = (torch.arange(m, device=state.device)[:, None], torch.arange(b, device=state.device)[None, :])
        for t in range(L - 2, -1, -1):
            state = shards[:, t][state // ql, *rows, state % ql].long()
            path.append(state)
    path = torch.stack(path[::-1], dim=-1).to(torch.int32)
    return path if local else C.gather(path, mesh, data_axis, 1)
