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

Transitions built with ``sparse_forward=True`` route
:meth:`~HMMLayer.state_posterior_log_probs`, :meth:`~HMMLayer.log_likelihood`
(so :meth:`~HMMLayer.loss` and ``forward``), :meth:`~HMMLayer.viterbi`,
:meth:`~HMMLayer.sample_paths` (sequential; ``parallel_factor`` ignored) and
:meth:`~HMMLayer.posterior_cross_entropy` (the fused objective) through the
sparse edge-list engine (:mod:`.ops.sparse`) over the transitions'
``make_A_sparse``; the dense (q, q) matrix is never built. Under a
``state`` partition the posterior, the log-likelihood and the decode take
the edge-sharded functions of :mod:`.parallel.sparse_sharding`; there the
cross-entropy is the unfused objective through the taped edge-sharded
posterior, and ``sample_paths`` raises. ``forward_recursion`` and
``backward_recursion`` keep the dense engine, as in the JAX layer.

Profile-family transitions built with ``structured_forward=True`` route
the sequential :meth:`~HMMLayer.log_likelihood` (so :meth:`~HMMLayer.loss`)
through the structured O(L) Plan7 matvec (:mod:`.ops.plan7`).
:meth:`HMMLayer.resize` re-targets a profile layer to new model lengths,
carrying the trained parameters over (learnMSA's length adaptation).

Multi-device routes: with ``mesh`` (a :class:`hmm_layer_torch.parallel.Mesh`
over the ranks of ``torch.distributed``) and ``partition`` the layer
sends :meth:`~HMMLayer.loss`, :meth:`~HMMLayer.log_likelihood`,
:meth:`~HMMLayer.state_posterior_log_probs` (so the cross-entropy) and
:meth:`~HMMLayer.viterbi` through :mod:`hmm_layer_torch.parallel.sharding`
(sparse-forward transitions: the ``batch`` route, and the ``state`` route
of :mod:`hmm_layer_torch.parallel.sparse_sharding`). Every rank is given
the whole batch and returns the whole result; under ``{"batch": axis}``
each rank runs the layer's own engine (on CUDA its kernels) on its rows.
The parameters are replicated and their gradients are those of the whole
batch on every rank.

Rank-local mode: :meth:`~HMMLayer.state_posterior_log_probs`,
:meth:`~HMMLayer.log_likelihood`, :meth:`~HMMLayer.viterbi`,
:meth:`~HMMLayer.loss`, :meth:`~HMMLayer.posterior_cross_entropy` and
``forward`` take ``local=True``. Every rank is still given the whole
inputs, but the emitters compute only the rank's block of ``E``
(:meth:`HMMLayer.local_ranges`: rows and states under ``state``, rows and
positions under ``seq``), the sharded functions run in their ``local=True``
mode, and the rank gets back its block: log gamma (m, b_l, L, q_l) or (m,
b_l, L_l, q), logliks (m, b_l) and paths of its rows (and positions). No
rank holds a global (m, b, L, q) tensor, as each device of the JAX
layer's ``shard_map`` holds only its block. The losses are the global
values on every rank (the cross-entropy's partial sums are summed over the
ranks once; the log-likelihood is already the same on the ranks of a
``state`` or ``seq`` axis), and the gradients are the global ones on
every rank: the emitters' parameters enter each rank's block through
:func:`~hmm_layer_torch.parallel.collectives.replicated_many` (their
gradients summed over the route's axes in one all-reduce), while ``init``
and ``A`` (or the edge probabilities) come back global from the sharded
functions and are not summed again. Under ``{"batch": ...}`` alone the
emitters compute only the rank's rows and the results stay gathered, as
in the global mode.
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

    def _pad_state(self, init, A, E):
        """Pad q up to a multiple of the state-axis size. Pad states have
        zero init, all-zero A rows/columns and zero emissions: the EPS
        clamps give them per-step mass ~1e-32 (invisible in float32 against
        real normalisers) and max-plus scores ~-74 a step below any real
        path, so they never change a result. Returns the original q too."""
        q = E.shape[-1]
        init, A = self._pad_transitions(init, A)
        dp = init.shape[-1] - q
        return init, A, (torch.nn.functional.pad(E, (0, dp)) if dp else E), q

    def _pad_transitions(self, init, A):
        """``init`` and ``A`` padded as :meth:`_pad_state` pads them."""
        n = self.mesh.shape[self.partition["state"]]
        q = init.shape[-1]
        dp = -(-q // n) * n - q
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

    def _dispatch_log_likelihood(self, init, A, E, total=None):
        route = self._route()
        if route == "dense":
            return recursion.log_likelihood(init, A, E, self._pf(E))
        if route == "data":
            return self._on_rows(
                lambda i, a, e: recursion.log_likelihood(i, a, e, self._pf(e)), (init, A), E, total=total
            )
        from .parallel import sharding

        if route == "state":
            pf = self._pf(E)
            init, A, E, _ = self._pad_state(init, A, E)
            return sharding.state_sharded_log_likelihood(init, A, E, **self._axes("state"), parallel_factor=pf)
        return sharding.seq_sharded_log_likelihood(init, A, E, **self._axes("seq"), local_parallel_factor=self._pf(E))

    def _dispatch_posterior(self, init, A, E, no_loglik, total=None):
        route = self._route()
        if route == "dense":
            return recursion.posterior(init, A, E, self._pf(E), no_loglik=no_loglik)
        if route == "data":
            return self._on_rows(
                lambda i, a, e: recursion.posterior(i, a, e, self._pf(e), no_loglik=no_loglik), (init, A), E,
                total=total,
            )
        from .parallel import sharding

        if route == "state":
            pf = self._pf(E)
            init, A, E, q = self._pad_state(init, A, E)
            lg, ll = sharding.state_sharded_posterior(
                init, A, E, **self._axes("state"), no_loglik=no_loglik, parallel_factor=pf
            )
            return lg[..., :q], ll
        return sharding.seq_sharded_posterior(
            init, A, E, **self._axes("seq"), local_parallel_factor=self._pf(E), no_loglik=no_loglik
        )

    def _dispatch_viterbi(self, init, A, E, total=None):
        route = self._route()
        if route == "dense":
            return recursion.viterbi(init, A, E, self._pf(E, for_viterbi=True))
        if route == "data":
            return self._on_rows(
                lambda i, a, e: recursion.viterbi(i, a, e, self._pf(e, for_viterbi=True)), (init, A), E, total=total
            )
        from .parallel import sharding

        if route == "state":
            init, A, E, _ = self._pad_state(init, A, E)
            return sharding.state_sharded_viterbi(init, A, E, **self._axes("state"))
        return sharding.seq_sharded_viterbi(
            init, A, E, **self._axes("seq"), local_parallel_factor=self._pf(E, for_viterbi=True)
        )

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

    def _ingredients(self, inputs, end_hints, training):
        with span("hmm.layer.transitions"):
            init, A = self.transitions.matrices()
        return init, A, self.emission_probs(inputs, end_hints, training)

    # -- rank-local mode ---------------------------------------------------------

    def _local(self, local: bool) -> bool:
        """Whether a call with ``local`` takes the rank-local mode (a mesh
        route; without one every result is the rank's already)."""
        return bool(local) and self._route() != "dense"

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
        if self._sparse_state_route():
            return ranges(self.mesh, "edge", shape, state_axis=axis, data_axis=data)
        n = self.mesh.shape[axis]
        return ranges(self.mesh, "state", (m, b, L, -(-q // n) * n), state_axis=axis, data_axis=data)

    def _local_ingredients(self, inputs, end_hints, training):
        """The rank-local mode's ingredients: (init, the transitions — A,
        or (edge indices, edge probs) for sparse-forward transitions —, the
        rank's block of E, its ranges, the global (m, b, L, q)). The block
        holds the real states; under the dense state route it is padded
        with zero columns to the block width (the last ranks' pad states)."""
        from .parallel.collectives import LocalRanges, replicated_many

        inputs = self._tensor(inputs)
        self._sparse_route()  # sparse-forward transitions under `seq` raise, as in the global mode
        if getattr(self.transitions, "sparse_forward", False):
            trans = self.transitions.make_A_sparse()
            init = self.transitions.make_initial_distribution()
        else:
            init, trans = self.transitions.matrices()
        m, b, L = inputs.shape[:3]
        shape = (m, b, L, init.shape[-1])
        r = self.local_ranges(shape)
        q, (s0, s1) = shape[-1], r.states
        real = (min(s0, q), min(s1, q))
        # The emitters read their parameters through `replicated_many`: each
        # rank's block gives them its share of their gradient, summed over
        # the ranks in one all-reduce.
        named = {name: p for name, p in self.emissions.named_parameters() if p.requires_grad}
        replicas = replicated_many(list(named.values()), self.mesh, self._local_axes())
        E = torch.func.functional_call(
            _Call(self.emissions, self.emission_probs),
            {f"inner.{name}": t for name, t in zip(named, replicas)},
            (inputs, end_hints, training),
            {"block": LocalRanges(r.rows, r.positions, real)},
        )
        pad = (s1 - s0) - (real[1] - real[0])
        if pad:
            E = torch.nn.functional.pad(E, (0, pad))
        return init, trans, E, r, shape

    def _local_call(self, kind, inputs, end_hints, training, no_loglik=False):
        """The rank's block of ``kind`` — ``"posterior"`` (log gamma,
        loglik), ``"loglik"`` or ``"viterbi"`` — in the rank-local mode,
        and the block's ranges. Under the data route the results are
        gathered, as in the global mode."""
        from .parallel import sharding

        init, trans, E, r, shape = self._local_ingredients(inputs, end_hints, training)
        route = self._route()
        sparse = getattr(self.transitions, "sparse_forward", False)
        for_viterbi = kind == "viterbi"
        if route == "data" and sparse:
            fn = {"posterior": lambda *a: sparse_ops.sparse_posterior(*a, no_loglik=no_loglik),
                  "loglik": sparse_ops.sparse_log_likelihood, "viterbi": sparse_ops.sparse_viterbi}[kind]
            return self._sparse_call(fn, init, *trans, E, total=shape[1]), r
        if route == "data":
            if kind == "posterior":
                return self._dispatch_posterior(init, trans, E, no_loglik, total=shape[1]), r
            dispatch = self._dispatch_viterbi if for_viterbi else self._dispatch_log_likelihood
            return dispatch(init, trans, E, total=shape[1]), r
        if route == "seq":
            kw = dict(self._axes("seq"), local_parallel_factor=self._pf(shape, for_viterbi), local=True)
            if kind == "posterior":
                return sharding.seq_sharded_posterior(init, trans, E, no_loglik=no_loglik, **kw), r
            fn = sharding.seq_sharded_viterbi if for_viterbi else sharding.seq_sharded_log_likelihood
            return fn(init, trans, E, **kw), r
        if sparse:
            name = {"posterior": "edge_sharded_posterior", "loglik": "edge_sharded_log_likelihood",
                    "viterbi": "edge_sharded_viterbi"}[kind]
            kw = {"no_loglik": no_loglik} if kind == "posterior" else {}
            return self._edge_sharded(name, init, *trans, E, local=True, **kw), r
        init, A = self._pad_transitions(init, trans)
        if for_viterbi:
            return sharding.state_sharded_viterbi(init, A, E, **self._axes("state"), local=True), r
        kw = dict(self._axes("state"), parallel_factor=self._pf(shape), local=True)
        if kind == "loglik":
            return sharding.state_sharded_log_likelihood(init, A, E, **kw), r
        lg, ll = sharding.state_sharded_posterior(init, A, E, no_loglik=no_loglik, **kw)
        q, (s0, _) = shape[-1], r.states
        return (lg[..., : max(min(q - s0, lg.shape[-1]), 0)], ll), r

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
        under the rank-local mode of the ``state`` and ``seq`` routes."""
        if self._local(local) and self._route() != "data":
            return self._local_mean(ll, indices, b)
        return self.apply_sequence_weights(ll, indices, aggregate=True)

    def _local_cross_entropy(self, inputs, labels, label_mask, end_hints, training, no_loglik):
        """The mean posterior cross-entropy of the whole batch from this
        rank's block of log gamma: the labels that fall in its states (and
        positions) picked, their masked sum summed over the ranks once
        (:func:`~hmm_layer_torch.parallel.collectives.sum_out`), over the
        whole mask's sum. Each rank's cotangent reaches only its block;
        the sharded function's backward does the rest."""
        from .parallel.collectives import sum_out

        (lg, _), r = self._local_call("posterior", inputs, end_hints, training, no_loglik)
        m, b, L = self._tensor(inputs).shape[:3]
        labels = torch.as_tensor(labels, device=lg.device).long()
        if labels.dim() == 2:
            labels = labels[None]
        block = (slice(None), slice(*r.rows), slice(*r.positions))
        labels = labels.expand(m, b, L)[block]
        s0, width = r.states[0], lg.shape[-1]
        inside = (labels >= s0) & (labels < s0 + width)
        if width:
            picked = torch.gather(lg, -1, (labels - s0).clamp(0, width - 1)[..., None])[..., 0]
        else:  # a block past q: no label falls in it, but its graph stays connected
            picked = lg.sum(-1)
        ce = -torch.where(inside, picked, torch.zeros_like(picked))
        if label_mask is None:
            part, count = ce.sum(), m * b * L
        else:
            mask = torch.as_tensor(label_mask, dtype=ce.dtype, device=ce.device).expand(m, b, L)
            part, count = (ce * mask[block]).sum(), mask.sum().clamp_min(1.0)
        return sum_out(part, self.mesh, self._local_axes()) / count

    # -- inference -------------------------------------------------------------

    def _sparse_route(self) -> bool:
        """Whether the transitions ask for the sparse edge-list engine
        (single device, or data parallel under ``{"batch": ...}``); the
        ``state`` partition takes :meth:`_sparse_state_route`."""
        if not getattr(self.transitions, "sparse_forward", False):
            return False
        route = self._route()
        if route == "seq":
            raise NotImplementedError(
                "sparse_forward does not compose with sequence sharding: the "
                "cross-device boundary combine carries dense (q, q) chunk "
                "summaries — O(q^2) memory/work per chunk, exactly what the "
                "sparse engine exists to avoid at large q. Use state (+batch) "
                "sharding for big-q models (partition={'state': ..., 'batch': ...})."
            )
        return route != "state"

    def _sparse_state_route(self) -> bool:
        """Whether the edge-sharded state routes serve this layer
        (sparse-forward transitions under a ``state`` partition)."""
        return getattr(self.transitions, "sparse_forward", False) and self._route() == "state"

    def _edge_sharded(self, name, *args, **kwargs):
        """``parallel.sparse_sharding.<name>`` on this layer's mesh and
        partition."""
        from .parallel import sparse_sharding

        return getattr(sparse_sharding, name)(*args, **self._axes("state"), **kwargs)

    def _sparse_call(self, fn, init, indices, probs, E, *extra, total=None):
        """A sparse engine function on the whole batch, or on this rank's
        rows under the data route (``total``: see :meth:`_on_rows`)."""
        if self._route() == "data":
            return self._on_rows(lambda i, p, e, *x: fn(i, indices, p, e, *x), (init, probs), E, *extra, total=total)
        return fn(init, indices, probs, E, *extra)

    def _sparse_ingredients(self, inputs, end_hints, training):
        """(init (m, q), host edge indices, edge probs (m, n), E)."""
        indices, probs = self.transitions.make_A_sparse()
        init = self.transitions.make_initial_distribution()
        return init, indices, probs, self.emission_probs(inputs, end_hints, training)

    def _prior_and_aux(self):
        """(unscaled prior (m,), aux loss): what ``return_prior`` appends."""
        return self.compute_prior(scaled=False), self.aux_loss()

    def forward_recursion(self, inputs, end_hints=None, return_prior=False, training=False):
        """(log_forward (m, b, L, q), loglik (m, b)[, prior, aux_loss])."""
        self._require_dense("forward_recursion")
        init, A, E = self._ingredients(inputs, end_hints, training)
        la, ll = recursion.forward(init, A, E, self._pf(E))
        return (la, ll, *self._prior_and_aux()) if return_prior else (la, ll)

    def backward_recursion(self, inputs, end_hints=None, return_prior=False, training=False):
        """log_backward (m, b, L, q)[, prior, aux_loss]."""
        self._require_dense("backward_recursion")
        init, A, E = self._ingredients(inputs, end_hints, training)
        lb = recursion.backward(init, A, E, self._pf(E))
        return (lb, *self._prior_and_aux()) if return_prior else lb

    def state_posterior_log_probs(
        self, inputs, end_hints=None, return_prior=False, training=False, no_loglik=False, local=False
    ):
        """log P(s_t = q | x); (m, b, L, q)[, prior, aux_loss]. ``no_loglik``
        skips the loglik normalisation. With ``return_prior`` the unscaled
        prior (m,) and the auxiliary loss follow, as in the JAX layer.
        ``local``: the rank's block (:meth:`local_ranges`; the real
        states only) under a ``state`` or ``seq`` partition."""
        if self._local(local):
            (lg, _), _ = self._local_call("posterior", inputs, end_hints, training, no_loglik)
        elif self._sparse_route():
            lg, _ = self._sparse_call(
                lambda *a: sparse_ops.sparse_posterior(*a, no_loglik=no_loglik),
                *self._sparse_ingredients(inputs, end_hints, training),
            )
        elif self._sparse_state_route():
            lg, _ = self._edge_sharded(
                "edge_sharded_posterior", *self._sparse_ingredients(inputs, end_hints, training), no_loglik=no_loglik
            )
        else:
            init, A, E = self._ingredients(inputs, end_hints, training)
            lg, _ = self._dispatch_posterior(init, A, E, no_loglik)
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
        if self._local(local):
            return self._local_call("loglik", inputs, end_hints, training)[0]
        if getattr(self.transitions, "structured_forward", False) and self._route() == "dense":
            E = self.emission_probs(inputs, end_hints, training)
            P = self._pf(E)
            if P == 1:
                return plan7.structured_log_likelihood(self.transitions, E)
            return recursion.log_likelihood(*self.transitions.matrices(), E, P)
        if self._sparse_route():
            return self._sparse_call(
                sparse_ops.sparse_log_likelihood, *self._sparse_ingredients(inputs, end_hints, training)
            )
        if self._sparse_state_route():
            return self._edge_sharded(
                "edge_sharded_log_likelihood", *self._sparse_ingredients(inputs, end_hints, training)
            )
        init, A, E = self._ingredients(inputs, end_hints, training)
        return self._dispatch_log_likelihood(init, A, E)

    @span("hmm.layer.viterbi")
    def viterbi(self, inputs, end_hints=None, local=False):
        """Most likely state paths; (m, b, L) int32, or under ``local`` this
        rank's rows (m, b_l, L) (``state``) or rows and positions (m, b_l,
        L_l) (``seq``).

        ``end_hints`` clamp chunk-border emissions as in
        :meth:`state_posterior_log_probs` (hint-constrained MAP decoding).
        """
        if self._local(local):
            with torch.no_grad():
                return self._local_call("viterbi", inputs, end_hints, False)[0]
        if self._sparse_route():
            return self._sparse_call(sparse_ops.sparse_viterbi, *self._sparse_ingredients(inputs, end_hints, False))
        if self._sparse_state_route():
            return self._edge_sharded("edge_sharded_viterbi", *self._sparse_ingredients(inputs, end_hints, False))
        init, A, E = self._ingredients(inputs, end_hints, False)
        return self._dispatch_viterbi(init, A, E)

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
        if self._sparse_route():
            init, indices, probs, E = self._sparse_ingredients(inputs, end_hints, False)
            return sparse_ops.sparse_sample_paths(init, indices, probs, E, generator, num_samples)
        self._require_dense("sample_paths")
        init, A, E = self._ingredients(inputs, end_hints, False)
        return sampling.sample_posterior(init, A, E, generator, num_samples, self._pf(E))

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
        if self._local(local) and self._route() != "data":
            loss = self._local_cross_entropy(inputs, labels, label_mask, end_hints, training, no_loglik)
        elif self._sparse_route():
            loss = self._sparse_cross_entropy(inputs, labels, label_mask, end_hints, training, no_loglik, local)
        else:
            loss = self._dense_cross_entropy(inputs, labels, label_mask, end_hints, training, no_loglik, local)
        if self.use_prior:
            loss = loss - self.compute_prior().mean()
        return loss + self.aux_loss()

    def _sparse_cross_entropy(self, inputs, labels, label_mask, end_hints, training, no_loglik, local=False):
        local = self._local(local)
        if local:  # the data route: this rank's rows of E
            init, (indices, probs), E, _, (_, total, _, _) = self._local_ingredients(inputs, end_hints, training)
        else:
            init, indices, probs, E = self._sparse_ingredients(inputs, end_hints, training)
            total = E.shape[1]
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
        summed = self._on_rows(local_sum, (init, probs), E, labels, mask, total=total if local else None)
        return summed / mask.sum().clamp_min(1.0)

    def _dense_cross_entropy(self, inputs, labels, label_mask, end_hints, training, no_loglik, local=False):
        lg = self.state_posterior_log_probs(
            inputs, end_hints=end_hints, training=training, no_loglik=no_loglik, local=local
        )
        labels = torch.as_tensor(labels, device=lg.device).long()
        if labels.dim() == lg.dim() - 2:
            labels = labels[None].expand(lg.shape[:-1])
        ce = -torch.gather(lg, -1, labels[..., None])[..., 0]
        if label_mask is not None:
            mask = torch.as_tensor(label_mask, dtype=ce.dtype, device=ce.device).expand(ce.shape)
            return (ce * mask).sum() / mask.sum().clamp_min(1.0)
        return ce.mean()

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

