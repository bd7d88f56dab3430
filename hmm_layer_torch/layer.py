"""Top-level HMM layer (port of ``hmm_layer_tpu/layer.py``, dense route).

:class:`HMMLayer` is an ``nn.Module`` that owns its transition and emission
modules and so their parameters. Its methods take the raw inputs
(m, b, L, s) and return log-space results, like the JAX layer's methods
with their ``params`` argument dropped. The layer lives on one device:
the GPU unless the caller asks for another (``device="cpu"``).

Training objectives: :meth:`HMMLayer.loss` (MAP: weighted mean
log-likelihood, scaled prior, auxiliary losses) and
:meth:`HMMLayer.posterior_cross_entropy` (supervised, against state
labels); their gradients at ``parallel_factor`` > 1 are the analytic
chunked VJPs of :mod:`.ops.recursion`. The recursions take the JAX
layer's ``return_prior`` and then append the unscaled prior and the
auxiliary loss.

:meth:`HMMLayer.sample_paths` draws exact posterior paths (FFBS,
:mod:`.ops.sampling`).

Routes: :meth:`~HMMLayer.state_posterior_log_probs`,
:meth:`~HMMLayer.log_likelihood` (so :meth:`~HMMLayer.loss` and
``forward``) and :meth:`~HMMLayer.viterbi` take their engine from one
table, keyed by the route and by whether the transitions are built with
``sparse_forward=True``:

=======  ====================================  =========================================
route    dense transitions                     sparse-forward transitions
=======  ====================================  =========================================
dense    :mod:`.ops.recursion`                 :mod:`.ops.sparse` (edge lists; no (q, q))
data     the same, on each rank's rows         the same, on each rank's rows
seq      ``parallel.sharding.seq_sharded_*``   raises
state    ``parallel.sharding.state_sharded_*`` ``parallel.sparse_sharding.edge_sharded_*``
=======  ====================================  =========================================

The route is ``dense`` without a ``mesh``; with a
:class:`hmm_layer_torch.parallel.Mesh` over the ranks of
``torch.distributed`` and a ``partition``, ``state`` or ``seq`` where the
partition names that axis, else ``data`` under ``{"batch": axis}``. The
dense route's log-likelihood takes the structured O(L) Plan7 matvec
(:mod:`.ops.plan7`) for profile transitions built with
``structured_forward=True`` where the parallel factor is 1. The dense
``state`` route pads q to a multiple of the state-axis size and trims the
posterior back to q. The cross-entropy of sparse-forward transitions on
the dense and data routes is the fused objective
(:func:`~hmm_layer_torch.ops.sparse.sparse_posterior_cross_entropy`); every
other cross-entropy picks the labels from the posterior.
:meth:`~HMMLayer.sample_paths` takes the sparse FFBS for sparse-forward
transitions; it, ``forward_recursion`` and ``backward_recursion`` (the dense
engine, as in the JAX layer) have no ``seq`` or ``state`` form. Every rank
is given the whole batch; the parameters are replicated and their
gradients are those of the whole batch on every rank.

Rank-local mode: the same methods, :meth:`~HMMLayer.loss`,
:meth:`~HMMLayer.posterior_cross_entropy` and ``forward`` take
``local=True``, which changes only the engine's inputs and its ``local``
flag. The emitters compute only the rank's block of ``E``
(:meth:`HMMLayer.local_ranges`: rows and states under ``state``, rows and
positions under ``seq``), the sharded functions run in their
``local=True`` mode, and the rank gets back its block: log gamma (m, b_l,
L, q_l) or (m, b_l, L_l, q), logliks (m, b_l) and paths of its rows (and
positions). No rank holds a global (m, b, L, q) tensor, as each device of
the JAX layer's ``shard_map`` holds only its block. The losses are the
global values on every rank (the cross-entropy's partial sums are summed
over the ranks once; the log-likelihood is already the same on the ranks
of a ``state`` or ``seq`` axis), and the gradients are the global ones on
every rank: the emitters' parameters enter each rank's block through
:func:`~hmm_layer_torch.parallel.collectives.replicated_many` (their
gradients summed over the route's axes in one all-reduce), while ``init``
and ``A`` (or the edge probabilities) come back global from the sharded
functions and are not summed again. Under the data route the emitters
compute only the rank's rows and the results stay gathered, as in the
global mode.
"""

from __future__ import annotations

import inspect

import torch
from torch import nn

from .ops import plan7, recursion, sampling
from .ops import sparse as sparse_ops
from .utils.profiling import span

__all__ = ["HMMLayer"]


def _resolve_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "HMMLayer runs on the GPU unless told otherwise, and no CUDA "
            "device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


class HMMLayer(nn.Module):
    """Log-likelihoods and posterior state probabilities for batches of
    observations under one or more HMMs.

    Args:
        transitions: transition module (``matrices() -> (init, A)``).
        emissions: emission module or list of modules; their per-state
            probabilities are multiplied.
        num_seqs: dataset size used to scale the prior.
        use_prior: add the prior to the training objective.
        sequence_weights: optional per-sequence weights, looked up by the
            ``indices`` argument of :meth:`loss` (a buffer, not a
            parameter: it is left out of ``state_dict`` and checkpoints).
        parallel_factor: chunked-parallel factor along the sequence axis
            (must divide the sequence length), or ``"auto"`` for
            :func:`~hmm_layer_torch.ops.recursion.recommended_parallel_factor`
            of each input's shape. Under sequence sharding it is the
            rank-local factor (applied to ``L / mesh.shape[seq_axis]``).
        device: where the layer and its computation live; ``None`` means
            the GPU and raises when there is none.
        mesh: optional :class:`~hmm_layer_torch.parallel.Mesh`; with
            ``partition`` it routes the layer through the distributed
            engine.
        partition: logical axes to mesh axis names, e.g. ``{"batch":
            "data"}`` (data parallel), ``{"batch": "data", "seq": "seq"}``
            (``L`` divisible by the seq-axis size) or ``{"batch": "data",
            "state": "state"}`` (``q`` is padded to a multiple of the
            state-axis size). ``"seq"`` and ``"state"`` exclude each
            other. Sparse-forward transitions take ``"batch"`` and
            ``"state"`` (the edge-sharded routes), not ``"seq"``.
    """

    _LOGICAL_AXES = ("batch", "seq", "state")

    def __init__(
        self,
        transitions,
        emissions,
        num_seqs: int | None = None,
        use_prior: bool = True,
        sequence_weights=None,
        parallel_factor: int | str = 1,
        device=None,
        mesh=None,
        partition: dict | None = None,
    ):
        super().__init__()
        if parallel_factor != "auto" and not (
            isinstance(parallel_factor, int) and parallel_factor >= 1
        ):
            raise ValueError(
                f"parallel_factor must be a positive int or 'auto', got {parallel_factor!r}"
            )
        self.transitions = transitions
        self.emissions = nn.ModuleList(
            emissions if isinstance(emissions, (list, tuple)) else [emissions]
        )
        # Whether every emitter computes a block of E (the rank-local mode).
        self._emitters_take_block = all(
            "block" in inspect.signature(em.emissions).parameters for em in self.emissions
        )
        self.num_seqs = num_seqs
        self.use_prior = use_prior
        self.register_buffer(
            "sequence_weights",
            None if sequence_weights is None
            else torch.as_tensor(sequence_weights, dtype=torch.float32),
            persistent=False,
        )
        self.parallel_factor = parallel_factor
        self.mesh = mesh
        self.partition = dict(partition) if partition else {}
        self._check_partition()
        self.to(_resolve_device(device))

    def _check_partition(self):
        if self.partition and self.mesh is None:
            raise ValueError("`partition` given without a `mesh`")
        unknown = set(self.partition) - set(self._LOGICAL_AXES)
        if unknown:
            raise ValueError(f"unknown partition axes {sorted(unknown)}; valid: {self._LOGICAL_AXES}")
        if "seq" in self.partition and "state" in self.partition:
            raise NotImplementedError(
                "combined sequence+state sharding is deliberately unsupported: "
                "seq sharding's q*q chunk summaries cost O(q^3) and lose above "
                "q~16, exactly where state sharding starts to pay. Use state "
                "(+batch) sharding for big-q long-L models; either axis combines "
                "with 'batch'."
            )
        if self.mesh is not None:
            for logical, name in self.partition.items():
                if name not in self.mesh.shape:
                    raise ValueError(
                        f"partition {logical!r} -> {name!r} is not an axis of the "
                        f"mesh (axes: {dict(self.mesh.shape)})"
                    )

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _pf(self, E, for_viterbi: bool = False) -> int:
        """The parallel factor for a global (m, b, L, q) problem: ``E`` or
        its shape."""
        m, _, L, q = getattr(E, "shape", E)
        if self._route() == "seq":
            L = L // self.mesh.shape[self.partition["seq"]]  # rank-local under seq sharding
        if self.parallel_factor == "auto":
            return recursion.recommended_parallel_factor(L, q, m, for_viterbi)
        return self.parallel_factor

    # -- distributed routing ----------------------------------------------------

    def _route(self) -> str:
        if self.mesh is None:
            return "dense"
        if "state" in self.partition:
            return "state"
        if "seq" in self.partition:
            return "seq"
        if "batch" in self.partition:
            return "data"
        return "dense"

    def _sparse(self) -> bool:
        """Whether the transitions ask for the sparse edge-list engines
        (``sparse_forward``); they serve every route but ``seq``, which
        raises."""
        if not getattr(self.transitions, "sparse_forward", False):
            return False
        if self._route() == "seq":
            raise NotImplementedError(
                "sparse_forward does not compose with sequence sharding: the "
                "cross-device boundary combine carries dense (q, q) chunk "
                "summaries — O(q^2) memory/work per chunk, exactly what the "
                "sparse engine exists to avoid at large q. Use state (+batch) "
                "sharding for big-q models (partition={'state': ..., 'batch': ...})."
            )
        return True

    def _require_dense(self, what: str):
        if self._route() in ("seq", "state"):
            raise NotImplementedError(
                f"{what} has no sequence/state-sharded implementation; construct "
                "a dense HMMLayer (mesh=None or batch-only partition) for it, or "
                "call the functions in hmm_layer_torch.parallel.sharding directly"
            )

    def _on_rows(self, fn, replicated, E, *extra, total=None):
        """``fn(*replicated, E_rows, *extra_rows)`` on this rank's rows of the
        batch (dim 1 of E and of each extra: labels and masks), through
        :func:`~hmm_layer_torch.parallel.sharding.data_parallel_fn`: the
        ``replicated`` tensors shared, tensor results gathered along dim 1,
        0-d results averaged over the ranks by their rows. With ``total``
        ``E`` is already the rank's rows of a ``total``-row batch (the
        rank-local mode), and the extras (whole) are cut to them."""
        from .parallel.sharding import data_parallel_fn, run_on_rows

        axis = self.partition["batch"]
        call = lambda shared, x: fn(*shared, *x)  # noqa: E731
        if total is None:
            return data_parallel_fn(call, self.mesh, axis)(tuple(replicated), (E, *extra))
        rows = slice(*self._local_rows(total))
        return run_on_rows(call, tuple(replicated), (E, *(t[:, rows] for t in extra)), total, self.mesh, axis)

    def _rows(self, fn, init, trans, E, total):
        """A one-device engine ``fn(init, trans, E)`` on this rank's rows
        (:meth:`_on_rows`); the host edge indices of sparse-forward
        transitions pass whole."""
        if isinstance(trans, tuple):
            indices, probs = trans
            return self._on_rows(lambda i, p, e: fn(i, (indices, p), e), (init, probs), E, total=total)
        return self._on_rows(fn, (init, trans), E, total=total)

    def _q_pad(self, q: int) -> int:
        """The states the engine takes: on the dense ``state`` route ``q``
        rounded up to a multiple of the state-axis size (the edge-sharded
        functions pad their own), elsewhere ``q``."""
        if self._route() != "state" or self._sparse():
            return q
        n = self.mesh.shape[self.partition["state"]]
        return -(-q // n) * n

    def _pad_transitions(self, init, A):
        """``init`` and ``A`` padded to :meth:`_q_pad` states. Pad states
        have zero init, all-zero A rows/columns and zero emissions: the EPS
        clamps give them per-step mass ~1e-32 (invisible in float32 against
        real normalisers) and max-plus scores ~-74 a step below any real
        path, so they never change a result."""
        dp = self._q_pad(init.shape[-1]) - init.shape[-1]
        if dp == 0:
            return init, A
        pad = torch.nn.functional.pad
        return pad(init, (0, dp)), pad(A, (0, dp, 0, dp))

    def _axes(self, route):
        return {
            "mesh": self.mesh,
            f"{route}_axis": self.partition[route],
            "data_axis": self.partition.get("batch"),
        }

    def _engine(self, kind: str, inputs, end_hints, training, local, **kw):
        """``kind`` — ``"posterior"`` ((log gamma, loglik); ``no_loglik`` in
        ``kw``), ``"loglik"`` or ``"viterbi"`` — on :meth:`_inputs`, by the
        engine of the one table of (route, sparse-forward transitions). The
        global and the rank-local mode take the same entry and differ only
        in the inputs and the ``local`` flag: the sharded functions take it
        as their own ``local``, and the data route as this rank's rows of
        the batch. Returns (result, the ranges of its block of the global
        (m, b, L, q) — under the dense ``state`` route of q padded —, the
        global (m, b, L, q))."""
        from .parallel import sharding, sparse_sharding

        route, sparse, local = self._route(), self._sparse(), self._local(local)
        structured = kind == "loglik" and route == "dense" and getattr(self.transitions, "structured_forward", False)
        init, trans, E, r, shape = self._inputs(inputs, end_hints, training, local, "plan7" if structured else None)
        pf = self._pf(shape, for_viterbi=kind == "viterbi")
        ax, pad = self._axes, self._pad_transitions
        seq = {"local_parallel_factor": pf, "local": local}
        state = {"parallel_factor": pf, "local": local}
        dense = (
            lambda i, a, e: recursion.posterior(i, a, e, pf, **kw),
            lambda i, a, e: self._plan7_log_likelihood(e, pf) if structured else recursion.log_likelihood(i, a, e, pf),
            lambda i, a, e: recursion.viterbi(i, a, e, pf),
        )
        edges = (
            lambda i, t, e: sparse_ops.sparse_posterior(i, *t, e, **kw),
            lambda i, t, e: sparse_ops.sparse_log_likelihood(i, *t, e),
            lambda i, t, e: sparse_ops.sparse_viterbi(i, *t, e),
        )
        total = shape[1] if local else None
        table = {  # (route, sparse-forward) -> (posterior, loglik, viterbi), each fn(init, trans, E)
            ("dense", False): dense,
            ("dense", True): edges,
            ("data", False): tuple(lambda i, t, e, f=f: self._rows(f, i, t, e, total) for f in dense),
            ("data", True): tuple(lambda i, t, e, f=f: self._rows(f, i, t, e, total) for f in edges),
            ("seq", False): (
                lambda i, a, e: sharding.seq_sharded_posterior(i, a, e, **ax("seq"), **seq, **kw),
                lambda i, a, e: sharding.seq_sharded_log_likelihood(i, a, e, **ax("seq"), **seq),
                lambda i, a, e: sharding.seq_sharded_viterbi(i, a, e, **ax("seq"), **seq),
            ),
            ("state", False): (
                lambda i, a, e: sharding.state_sharded_posterior(*pad(i, a), e, **ax("state"), **state, **kw),
                lambda i, a, e: sharding.state_sharded_log_likelihood(*pad(i, a), e, **ax("state"), **state),
                lambda i, a, e: sharding.state_sharded_viterbi(*pad(i, a), e, **ax("state"), local=local),
            ),
            ("state", True): (
                lambda i, t, e: sparse_sharding.edge_sharded_posterior(i, *t, e, **ax("state"), local=local, **kw),
                lambda i, t, e: sparse_sharding.edge_sharded_log_likelihood(i, *t, e, **ax("state"), local=local),
                lambda i, t, e: sparse_sharding.edge_sharded_viterbi(i, *t, e, **ax("state"), local=local),
            ),
        }
        fn = table[route, sparse][("posterior", "loglik", "viterbi").index(kind)]
        if route == "data":  # the rows' results come back gathered
            r = r._replace(rows=(0, shape[1]))
        return fn(init, trans, E), r, shape

    def _plan7_log_likelihood(self, E, pf):
        """The structured O(L) Plan7 log-likelihood where the parallel
        factor is 1 (the implicit A is never built), the dense engine on
        ``matrices()`` otherwise, as in the JAX layer."""
        if pf == 1:
            return plan7.structured_log_likelihood(self.transitions, E)
        return recursion.log_likelihood(*self.transitions.matrices(), E, pf)

    def _tensor(self, x):
        if x is None:
            return None
        with span("hmm.layer.inputs"):  # a host array's copy to the device
            return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # -- building blocks -------------------------------------------------------

    @span("hmm.layer.emissions")
    def emission_probs(self, inputs, end_hints=None, training=False, block=None):
        """Product of all emitters' per-state probabilities; (m, b, L, q),
        or with ``block`` (rows, positions, states ranges, e.g.
        :meth:`local_ranges`) only ``E[:, rows, positions, states]``, each
        emitter computing only its block."""
        inputs, end_hints = self._tensor(inputs), self._tensor(end_hints)
        kwargs = {"end_hints": end_hints, "training": training}
        if block is not None:
            if not self._emitters_take_block:
                names = [type(em).__name__ for em in self.emissions]
                raise NotImplementedError(
                    f"an emitter of {names} takes no `block` in its `emissions`: it cannot compute a "
                    "rank's block of the emissions; call the layer without local=True"
                )
            kwargs["block"] = block
        probs = self.emissions[0].emissions(inputs, **kwargs)
        for em in self.emissions[1:]:
            probs = probs * em.emissions(inputs, **kwargs)
        return probs

    def _inputs(self, inputs, end_hints=None, training=False, local=False, form=None):
        """The engine's inputs: (init, trans, E, ranges, the global (m, b,
        L, q)).

        ``trans`` takes the ``form`` the engine reads: ``"A"``, the dense
        matrix; ``"edges"``, (host edge indices, edge probs); ``"plan7"``,
        nothing (``init`` None too: the structured matvec reads the
        transitions); None, the transitions' own (edges for sparse-forward
        ones, A otherwise).

        ``E`` is the whole emissions, on the dense ``state`` route padded
        with zero columns to :meth:`_q_pad` states, and ``ranges`` covers
        them. Under the rank-local mode (:meth:`_local`) ``E`` is the rank's
        block (:meth:`local_ranges`), its real states computed by emitters
        that read their parameters replicated, under the dense ``state``
        route padded with zero columns to the block width (the last ranks'
        pad states)."""
        from .parallel.collectives import LocalRanges, replicated_many

        form = form or ("edges" if self._sparse() else "A")
        if form == "edges":
            trans = self.transitions.make_A_sparse()
            init = self.transitions.make_initial_distribution()
        elif form == "A":
            with span("hmm.layer.transitions"):
                init, trans = self.transitions.matrices()
        else:
            init = trans = None
        if self._local(local):
            inputs = self._tensor(inputs)
            shape = (*inputs.shape[:3], init.shape[-1])
            r = self.local_ranges(shape)
            q, (s0, s1) = shape[-1], r.states
            # The emitters read their parameters through `replicated_many`:
            # each rank's block gives them its share of their gradient,
            # summed over the ranks in one all-reduce.
            named = {name: p for name, p in self.emissions.named_parameters() if p.requires_grad}
            replicas = replicated_many(list(named.values()), self.mesh, self._local_axes())
            E = torch.func.functional_call(
                _Call(self.emissions, self.emission_probs),
                {f"inner.{name}": t for name, t in zip(named, replicas)},
                (inputs, end_hints, training),
                {"block": LocalRanges(r.rows, r.positions, (min(s0, q), min(s1, q)))},
            )
        else:
            E = self.emission_probs(inputs, end_hints, training)
            shape = tuple(E.shape)
            r = LocalRanges((0, shape[1]), (0, shape[2]), (0, self._q_pad(shape[-1])))
        pad = r.states[1] - r.states[0] - E.shape[-1]
        if pad:
            E = torch.nn.functional.pad(E, (0, pad))
        return init, trans, E, r, shape

    # -- rank-local mode ---------------------------------------------------------

    def _local(self, local: bool) -> bool:
        """Whether a call with ``local`` takes the rank-local mode (a mesh
        route; without one every result is the rank's already)."""
        return bool(local) and self._route() != "dense"

    def _blocks(self, local: bool) -> bool:
        """Whether a call with ``local`` returns the rank's block of the
        results: the rank-local mode of the ``state`` and ``seq`` routes
        (the data route gathers its rows' results, as in the global
        mode)."""
        return self._local(local) and self._route() != "data"

    def _local_axes(self):
        """The mesh axes over which the ranks split the emissions in the
        rank-local mode: the route's axis and the data axis."""
        route = self._route()
        axes = [self.partition[route]] if route in ("state", "seq") else []
        return tuple(axes + ([self.partition["batch"]] if "batch" in self.partition else []))

    def _local_rows(self, b: int):
        """This rank's ``[start, stop)`` of the ``b`` batch rows."""
        data = self.partition.get("batch")
        if data is None:
            return 0, b
        from .parallel.collectives import row_sizes

        sizes = row_sizes(b, self.mesh.shape[data])
        k = self.mesh.index(data)
        return sum(sizes[:k]), sum(sizes[: k + 1])

    def local_ranges(self, shape):
        """This rank's block of the global (m, b, L, q) emissions in the
        rank-local mode: a :class:`~hmm_layer_torch.parallel.LocalRanges`
        of rows, positions and states (rows over the data axis, positions
        over the ``seq`` axis, states in blocks of ``ceil(q / n)`` over the
        ``state`` axis). Under the dense ``state`` route the last blocks
        may reach past ``q`` into the pad states, which are zero emission
        columns; the emitters compute the real ones. Rows (and positions)
        must divide by their axes, as in the global mode, except under
        the data route, whose blocks may differ by one row."""
        from .parallel.collectives import LocalRanges
        from .parallel.collectives import local_ranges as ranges

        m, b, L, q = shape
        route, data = self._route(), self.partition.get("batch")
        if route in ("dense", "data"):
            return LocalRanges(self._local_rows(b), (0, L), (0, q))
        if data is not None and b % self.mesh.shape[data]:
            raise ValueError(f"b={b} not divisible by data axis size {self.mesh.shape[data]}")
        if route == "seq":
            axis = self.partition["seq"]
            if L % self.mesh.shape[axis]:
                raise ValueError(f"L={L} not divisible by seq axis size {self.mesh.shape[axis]}")
            return ranges(self.mesh, "seq", shape, seq_axis=axis, data_axis=data)
        axis = self.partition["state"]
        if self._sparse():
            return ranges(self.mesh, "edge", shape, state_axis=axis, data_axis=data)
        return ranges(self.mesh, "state", (m, b, L, self._q_pad(q)), state_axis=axis, data_axis=data)

    def _local_mean(self, ll, indices, b: int):
        """The weighted mean log-likelihood of the whole batch
        (:meth:`apply_sequence_weights` with ``aggregate``) from this
        rank's rows of it, ``ll`` (m, b_l): each rank's part, summed over
        the data axis (each rank's cotangent its own part's)."""
        from .parallel.collectives import sum_out

        rows = slice(*self._local_rows(b))
        if self.sequence_weights is not None:
            w = self._weights(indices)
            part = ((ll * w[:, rows]).sum(1) / w.sum(1)).mean()
        else:
            part = ll.sum() / (ll.shape[0] * b)
        return sum_out(part, self.mesh, self.partition.get("batch"))

    def _aggregate(self, ll, indices, local, b):
        """The weighted mean log-likelihood; ``ll`` is this rank's rows
        when the call returns blocks (:meth:`_blocks`)."""
        if self._blocks(local):
            return self._local_mean(ll, indices, b)
        return self.apply_sequence_weights(ll, indices, aggregate=True)

    # -- inference -------------------------------------------------------------

    def _prior_and_aux(self):
        """(unscaled prior (m,), aux loss): what ``return_prior`` appends."""
        return self.compute_prior(scaled=False), self.aux_loss()

    def forward_recursion(self, inputs, end_hints=None, return_prior=False, training=False):
        """(log_forward (m, b, L, q), loglik (m, b)[, prior, aux_loss])."""
        self._require_dense("forward_recursion")
        init, A, E, _, _ = self._inputs(inputs, end_hints, training, form="A")
        la, ll = recursion.forward(init, A, E, self._pf(E))
        return (la, ll, *self._prior_and_aux()) if return_prior else (la, ll)

    def backward_recursion(self, inputs, end_hints=None, return_prior=False, training=False):
        """log_backward (m, b, L, q)[, prior, aux_loss]."""
        self._require_dense("backward_recursion")
        init, A, E, _, _ = self._inputs(inputs, end_hints, training, form="A")
        lb = recursion.backward(init, A, E, self._pf(E))
        return (lb, *self._prior_and_aux()) if return_prior else lb

    def _posterior(self, inputs, end_hints, training, no_loglik, local):
        """(log gamma on the real states, the ranges of E, the global (m, b,
        L, q)): under the state route the pad states trimmed, globally
        (``s0 = 0``) and from the rank's block alike."""
        (lg, _), r, shape = self._engine("posterior", inputs, end_hints, training, local, no_loglik=no_loglik)
        keep = max(min(shape[-1] - r.states[0], lg.shape[-1]), 0)
        # A slice that keeps every state would still copy the whole cotangent in the backward.
        return (lg[..., :keep] if keep < lg.shape[-1] else lg), r, shape

    def state_posterior_log_probs(
        self, inputs, end_hints=None, return_prior=False, training=False, no_loglik=False, local=False
    ):
        """log P(s_t = q | x); (m, b, L, q)[, prior, aux_loss]. ``no_loglik``
        skips the loglik normalisation. With ``return_prior`` the unscaled
        prior (m,) and the auxiliary loss follow, as in the JAX layer.
        ``local``: the rank's block (:meth:`local_ranges`; the real
        states only) under a ``state`` or ``seq`` partition."""
        lg = self._posterior(inputs, end_hints, training, no_loglik, local)[0]
        return (lg, *self._prior_and_aux()) if return_prior else lg

    def log_likelihood(self, inputs, end_hints=None, training=False, local=False):
        """Per-model per-sequence loglik; (m, b), or under ``local`` this
        rank's rows (m, b_l) (the same on every rank of a ``state`` or
        ``seq`` axis).

        Profile-family transitions built with ``structured_forward=True``
        take the structured O(L) Plan7 matvec (:mod:`.ops.plan7`) where the
        parallel factor is 1, and the dense engine otherwise, as in the JAX
        layer; the implicit A is then never built.
        """
        return self._engine("loglik", inputs, end_hints, training, local)[0]

    @span("hmm.layer.viterbi")
    @torch.no_grad()
    def viterbi(self, inputs, end_hints=None, local=False):
        """Most likely state paths; (m, b, L) int32, or under ``local`` this
        rank's rows (m, b_l, L) (``state``) or rows and positions (m, b_l,
        L_l) (``seq``).

        ``end_hints`` clamp chunk-border emissions as in
        :meth:`state_posterior_log_probs` (hint-constrained MAP decoding).
        """
        return self._engine("viterbi", inputs, end_hints, False, local)[0]

    @torch.no_grad()
    def sample_paths(self, inputs, num_samples: int = 1, end_hints=None, generator=None):
        """Exact posterior path samples; (m, b, num_samples, L) int32.

        Gumbel noise comes from ``generator`` (a ``torch.Generator``, best
        on the layer's device; the device's default generator when
        ``None``). Every sampled transition has ``A > 0`` and every first
        state ``init > 0``. Sparse-forward transitions take the edge-list
        FFBS (:func:`~hmm_layer_torch.ops.sparse.sparse_sample_paths`,
        sequential; ``parallel_factor`` is ignored), whose samples stay on
        the edge support. Under the data route every rank samples the
        whole batch.
        """
        sparse = self._sparse()
        self._require_dense("sample_paths")
        init, trans, E, _, _ = self._inputs(inputs, end_hints, False)
        if sparse:
            return sparse_ops.sparse_sample_paths(init, *trans, E, generator, num_samples)
        return sampling.sample_posterior(init, trans, E, generator, num_samples, self._pf(E))

    # -- model surgery -----------------------------------------------------------

    def resize(self, new_lengths, keep=None, generator: torch.Generator | None = None):
        """Param-preserving profile length adaptation at the layer level.

        Every component (transitions and all emitters) must have a
        ``resize`` (the profile family:
        :meth:`~hmm_layer_torch.models.ProfileTransitions.resize`); the
        surviving parameters carry over and new columns draw from
        ``generator``. Returns a new :class:`HMMLayer` with this layer's
        settings on its device; build a fresh optimizer for it
        (``Trainer.init_from_params``).
        """
        for comp in [self.transitions, *self.emissions]:
            if not hasattr(comp, "resize"):
                raise NotImplementedError(
                    f"{type(comp).__name__} does not support resize — "
                    "length adaptation is a profile-family capability "
                    "(ProfileTransitions/ProfileEmissions); gene-pred "
                    "components have fixed grammar-defined state counts"
                )
        transitions = self.transitions.resize(new_lengths, keep, generator)
        emissions = [em.resize(new_lengths, keep, generator) for em in self.emissions]
        return HMMLayer(
            transitions,
            emissions,
            num_seqs=self.num_seqs,
            use_prior=self.use_prior,
            sequence_weights=self.sequence_weights,
            parallel_factor=self.parallel_factor,
            device=self.device,
            mesh=self.mesh,
            partition=self.partition or None,
        )

    # -- priors / weights / losses ------------------------------------------------

    def reset_parameters(self, generator: torch.Generator | None = None, input_dim: int | None = None):
        """Every component back to its initial parameters (the JAX
        ``init_params``): transition noise and the embedding kernels drawn
        from ``generator``, emission kernels ``input_dim`` class channels
        wide."""
        self.transitions.reset_parameters(generator)
        for em in self.emissions:
            em.reset_parameters(input_dim, generator)

    @span("hmm.layer.prior")
    def compute_prior(self, scaled: bool = True):
        """Summed parameter prior per model; (m,)."""
        prior = self.transitions.prior_log_density()
        for em in self.emissions:
            prior = prior + em.prior_log_density()
        return self._scale_prior(prior) if scaled else prior

    def _scale_prior(self, prior):
        if self.sequence_weights is not None:
            return prior / self.sequence_weights.sum()
        if self.num_seqs is not None:
            return prior / self.num_seqs
        return prior

    def aux_loss(self):
        return sum(em.aux_loss() for em in self.emissions)

    def _weights(self, indices):
        """The sequence weights of the batch's ``indices``."""
        if indices is None:
            raise ValueError(
                "sequence_weights are set but no batch `indices` were "
                "passed — weights are looked up per sequence; indexing "
                "with None would silently add an axis instead"
            )
        return self.sequence_weights[torch.as_tensor(indices, device=self.device).long()]

    def apply_sequence_weights(self, loglik, indices, aggregate: bool = False):
        """``loglik`` (m, b) times each sequence's weight (looked up by
        ``indices``); with ``aggregate`` the weighted mean, a scalar."""
        if self.sequence_weights is not None:
            weights = self._weights(indices)
            loglik = loglik * weights
            if aggregate:
                loglik = (loglik.sum(1) / weights.sum(1)).mean()
        elif aggregate:
            loglik = loglik.mean()
        return loglik

    @span("hmm.layer.loss")
    def loss(self, inputs, indices=None, training=True, end_hints=None, local=False):
        """Negative (MAP) training objective, scalar: mean weighted loglik
        + scaled prior − aux losses, negated. ``end_hints`` clamp
        chunk-border emissions (hint-constrained MAP training). ``local``:
        the rank-local mode (the whole batch's value on every rank; the
        global gradients)."""
        ll = self.log_likelihood(inputs, end_hints=end_hints, training=training, local=local)
        objective = self._aggregate(ll, indices, local, self._tensor(inputs).shape[1])
        if self.use_prior:
            objective = objective + self.compute_prior().mean()
        return -objective + self.aux_loss()

    def posterior_cross_entropy(
        self,
        inputs,
        labels,
        label_mask=None,
        end_hints=None,
        training=True,
        no_loglik=False,
        local=False,
    ):
        """Supervised training objective: mean cross-entropy between the
        posterior state marginals and per-position state labels, scalar.

        The Tiberius training mode of the gene-pred family; labels come
        from reference annotations via
        :func:`~hmm_layer_torch.models.annotation.genes_to_states`.

        Args:
          labels: int state tracks, ``(m, b, L)`` or ``(b, L)`` (broadcast
            over models).
          label_mask: optional weights of the same shape (mask padding or
            unannotated positions); the mean is over their sum (at least 1).
          no_loglik: skip the loglik normalisation inside the posterior (the
            CE then also penalises total mass).
          local: the rank-local mode: each rank's posterior block, its
            labels' partial sum summed over the ranks once; the whole
            batch's value and the global gradients on every rank.

        Sparse-forward transitions take the fused objective
        (:func:`~hmm_layer_torch.ops.sparse.sparse_posterior_cross_entropy`):
        the (m, b, L, q) posterior and its cotangent never exist, and the
        time block of its backward is
        :func:`~hmm_layer_torch.ops.sparse.set_sparse_posterior_block`'s.
        Under a ``state`` partition they take the unfused objective through
        the taped edge-sharded posterior, as the JAX layer does.

        Returns:
          scalar loss: mean CE − scaled prior (if ``use_prior``) + aux.
        """
        if self._fuses_cross_entropy():
            loss = self._sparse_cross_entropy(inputs, labels, label_mask, end_hints, training, no_loglik, local)
        else:
            loss = self._label_cross_entropy(inputs, labels, label_mask, end_hints, training, no_loglik, local)
        if self.use_prior:
            loss = loss - self.compute_prior().mean()
        return loss + self.aux_loss()

    def _fuses_cross_entropy(self) -> bool:
        """Whether the cross-entropy is the fused sparse objective:
        sparse-forward transitions on the dense and data routes."""
        return self._sparse() and self._route() in ("dense", "data")

    def _sparse_cross_entropy(self, inputs, labels, label_mask, end_hints, training, no_loglik, local=False):
        """The fused objective of the whole batch, or under the data route
        of each rank's rows (in the rank-local mode the rank's rows of E)."""
        init, (indices, probs), E, _, (_, total, _, _) = self._inputs(inputs, end_hints, training, local)
        if self._route() != "data":
            return sparse_ops.sparse_posterior_cross_entropy(
                init, indices, probs, E, labels, label_mask=label_mask, no_loglik=no_loglik
            )
        # Data route: each rank's fused CE is a mean over its rows; its sum
        # (mean times max(mask sum, 1), exact for any mask sum) is summed
        # over the ranks and divided by the whole mask's sum.
        shape = (E.shape[0], total, E.shape[2])
        labels = torch.as_tensor(labels, device=E.device)
        if labels.dim() == 2:
            labels = labels[None].expand(shape)
        mask = torch.ones(labels.shape, dtype=E.dtype, device=E.device) if label_mask is None else (
            torch.as_tensor(label_mask, dtype=E.dtype, device=E.device).expand(labels.shape)
        )

        def local_sum(i, p, e, lab, msk):
            mean = sparse_ops.sparse_posterior_cross_entropy(
                i, indices, p, e, lab, label_mask=msk, no_loglik=no_loglik
            )
            return mean * msk.sum().clamp_min(1.0) * (total / e.shape[1])

        # the row-weighted mean of b/b_k * sum
        summed = self._on_rows(local_sum, (init, probs), E, labels, mask, total=total if self._local(local) else None)
        return summed / mask.sum().clamp_min(1.0)

    def _label_cross_entropy(self, inputs, labels, label_mask, end_hints, training, no_loglik, local=False):
        """The mean cross-entropy of the labels picked from the block of log
        gamma the call returns. The whole tensor: their mean, or masked sum
        over the mask's sum. The rank's block (:meth:`_blocks`): the labels
        that fall in its states (and positions) picked, their masked sum
        summed over the ranks once
        (:func:`~hmm_layer_torch.parallel.collectives.sum_out`), over the
        whole mask's sum; each rank's cotangent reaches only its block, and
        the sharded function's backward does the rest."""
        from .parallel.collectives import sum_out

        lg, r, (m, b, L, _) = self._posterior(inputs, end_hints, training, no_loglik, local)
        labels = torch.as_tensor(labels, device=lg.device).long()
        if labels.dim() == 2:
            labels = labels[None]
        block = (slice(None), slice(*r.rows), slice(*r.positions))
        labels = labels.expand(m, b, L)[block]
        mask = None if label_mask is None else (
            torch.as_tensor(label_mask, dtype=lg.dtype, device=lg.device).expand(m, b, L)
        )
        if not self._blocks(local):  # the whole tensor: nothing to sum over the ranks
            ce = -torch.gather(lg, -1, labels[..., None])[..., 0]
            return ce.mean() if mask is None else (ce * mask).sum() / mask.sum().clamp_min(1.0)
        s0, width = r.states[0], lg.shape[-1]
        inside = (labels >= s0) & (labels < s0 + width)
        if width:
            picked = torch.gather(lg, -1, (labels - s0).clamp(0, width - 1)[..., None])[..., 0]
        else:  # a block past q: no label falls in it, but its graph stays connected
            picked = lg.sum(-1)
        ce = -torch.where(inside, picked, torch.zeros_like(picked))
        if mask is None:
            part, count = ce.sum(), m * b * L
        else:
            part, count = (ce * mask[block]).sum(), mask.sum().clamp_min(1.0)
        return sum_out(part, self.mesh, self._local_axes()) / count

    def forward(self, inputs, indices=None, training=False, end_hints=None, local=False):
        """``layer(inputs)``: (loglik (m, b), aggregated loglik[, prior
        (m,), aux_loss]); under ``local`` the rank's loglik rows and the
        whole batch's aggregate."""
        ll = self.log_likelihood(inputs, end_hints=end_hints, training=training, local=local)
        ll_mean = self._aggregate(ll, indices, local, self._tensor(inputs).shape[1])
        if self.use_prior:
            return ll, ll_mean, self.compute_prior(), self.aux_loss()
        return ll, ll_mean

    # -- config -----------------------------------------------------------------

    def get_config(self) -> dict:
        """Config in the JAX layer's format: components by class name plus
        their own configs."""

        def spec(component):
            return {"class": type(component).__name__, "config": component.get_config()}

        return {
            "transitions": spec(self.transitions),
            "emissions": [spec(em) for em in self.emissions],
            "num_seqs": self.num_seqs,
            "use_prior": self.use_prior,
            "sequence_weights": (
                None
                if self.sequence_weights is None
                else self.sequence_weights.cpu().numpy().tolist()
            ),
            "parallel_factor": self.parallel_factor,
        }

    @classmethod
    def from_config(cls, config: dict, device=None, mesh=None, partition=None):
        """The layer :meth:`get_config` describes, its components built by
        class name from :mod:`hmm_layer_torch.models`, on ``device`` (the
        GPU unless told otherwise); ``mesh``/``partition`` are runtime
        objects and are supplied here, as in the JAX layer."""
        from . import models

        def build(spec):
            component_cls = getattr(models, spec["class"], None)
            if component_cls is None:
                raise ValueError(
                    f"unknown component class {spec['class']!r} (must be "
                    "exported from hmm_layer_torch.models)"
                )
            return component_cls.from_config(spec["config"])

        return cls(
            build(config["transitions"]),
            [build(s) for s in config["emissions"]],
            num_seqs=config.get("num_seqs"),
            use_prior=config.get("use_prior", True),
            sequence_weights=config.get("sequence_weights"),
            parallel_factor=config.get("parallel_factor", 1),
            device=device,
            mesh=mesh,
            partition=partition,
        )


class _Call(nn.Module):
    """``fn(*args, **kwargs)`` as the forward of a module that holds
    ``inner``, whose parameters :func:`torch.func.functional_call`
    replaces for the call."""

    def __init__(self, inner, fn):
        super().__init__()
        self.inner = inner
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

