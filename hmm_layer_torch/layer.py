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
"""

from __future__ import annotations

import torch
from torch import nn

from .ops import plan7, recursion, sampling
from .ops import sparse as sparse_ops

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
        m, _, L, q = E.shape
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

    def _on_rows(self, fn, replicated, E, *extra):
        """``fn(*replicated, E_rows, *extra_rows)`` on this rank's rows of the
        batch (dim 1 of E and of each extra: labels and masks), through
        :func:`~hmm_layer_torch.parallel.sharding.data_parallel_fn`: the
        ``replicated`` tensors shared, tensor results gathered along dim 1,
        0-d results averaged over the ranks by their rows."""
        from .parallel.sharding import data_parallel_fn

        run = data_parallel_fn(lambda shared, rows: fn(*shared, *rows), self.mesh, self.partition["batch"])
        return run(tuple(replicated), (E, *extra))

    def _pad_state(self, init, A, E):
        """Pad q up to a multiple of the state-axis size. Pad states have
        zero init, all-zero A rows/columns and zero emissions: the EPS
        clamps give them per-step mass ~1e-32 (invisible in float32 against
        real normalisers) and max-plus scores ~-74 a step below any real
        path, so they never change a result. Returns the original q too."""
        n = self.mesh.shape[self.partition["state"]]
        q = E.shape[-1]
        dp = -(-q // n) * n - q
        if dp == 0:
            return init, A, E, q
        pad = torch.nn.functional.pad
        return pad(init, (0, dp)), pad(A, (0, dp, 0, dp)), pad(E, (0, dp)), q

    def _axes(self, route):
        return {
            "mesh": self.mesh,
            f"{route}_axis": self.partition[route],
            "data_axis": self.partition.get("batch"),
        }

    def _dispatch_log_likelihood(self, init, A, E):
        route = self._route()
        if route == "dense":
            return recursion.log_likelihood(init, A, E, self._pf(E))
        if route == "data":
            return self._on_rows(lambda i, a, e: recursion.log_likelihood(i, a, e, self._pf(e)), (init, A), E)
        from .parallel import sharding

        if route == "state":
            pf = self._pf(E)
            init, A, E, _ = self._pad_state(init, A, E)
            return sharding.state_sharded_log_likelihood(init, A, E, **self._axes("state"), parallel_factor=pf)
        return sharding.seq_sharded_log_likelihood(init, A, E, **self._axes("seq"), local_parallel_factor=self._pf(E))

    def _dispatch_posterior(self, init, A, E, no_loglik):
        route = self._route()
        if route == "dense":
            return recursion.posterior(init, A, E, self._pf(E), no_loglik=no_loglik)
        if route == "data":
            return self._on_rows(
                lambda i, a, e: recursion.posterior(i, a, e, self._pf(e), no_loglik=no_loglik), (init, A), E
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

    def _dispatch_viterbi(self, init, A, E):
        route = self._route()
        if route == "dense":
            return recursion.viterbi(init, A, E, self._pf(E, for_viterbi=True))
        if route == "data":
            return self._on_rows(
                lambda i, a, e: recursion.viterbi(i, a, e, self._pf(e, for_viterbi=True)), (init, A), E
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
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # -- building blocks -------------------------------------------------------

    def emission_probs(self, inputs, end_hints=None, training=False):
        """Product of all emitters' per-state probabilities; (m, b, L, q)."""
        inputs, end_hints = self._tensor(inputs), self._tensor(end_hints)
        probs = self.emissions[0].emissions(inputs, end_hints=end_hints, training=training)
        for em in self.emissions[1:]:
            probs = probs * em.emissions(inputs, end_hints=end_hints, training=training)
        return probs

    def _ingredients(self, inputs, end_hints, training):
        init, A = self.transitions.matrices()
        return init, A, self.emission_probs(inputs, end_hints, training)

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

    def _sparse_call(self, fn, init, indices, probs, E, *extra):
        """A sparse engine function on the whole batch, or on this rank's
        rows under the data route."""
        if self._route() == "data":
            return self._on_rows(lambda i, p, e, *x: fn(i, indices, p, e, *x), (init, probs), E, *extra)
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
        self, inputs, end_hints=None, return_prior=False, training=False, no_loglik=False
    ):
        """log P(s_t = q | x); (m, b, L, q)[, prior, aux_loss]. ``no_loglik``
        skips the loglik normalisation. With ``return_prior`` the unscaled
        prior (m,) and the auxiliary loss follow, as in the JAX layer."""
        if self._sparse_route():
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

    def log_likelihood(self, inputs, end_hints=None, training=False):
        """Per-model per-sequence loglik; (m, b).

        Profile-family transitions built with ``structured_forward=True``
        take the structured O(L) Plan7 matvec (:mod:`.ops.plan7`) where the
        parallel factor is 1, and the dense engine otherwise, as in the JAX
        layer; the implicit A is then never built.
        """
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

    def viterbi(self, inputs, end_hints=None):
        """Most likely state paths; (m, b, L) int32.

        ``end_hints`` clamp chunk-border emissions as in
        :meth:`state_posterior_log_probs` (hint-constrained MAP decoding).
        """
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

    def apply_sequence_weights(self, loglik, indices, aggregate: bool = False):
        """``loglik`` (m, b) times each sequence's weight (looked up by
        ``indices``); with ``aggregate`` the weighted mean, a scalar."""
        if self.sequence_weights is not None:
            if indices is None:
                raise ValueError(
                    "sequence_weights are set but no batch `indices` were "
                    "passed — weights are looked up per sequence; indexing "
                    "with None would silently add an axis instead"
                )
            weights = self.sequence_weights[torch.as_tensor(indices, device=self.device).long()]
            loglik = loglik * weights
            if aggregate:
                loglik = (loglik.sum(1) / weights.sum(1)).mean()
        elif aggregate:
            loglik = loglik.mean()
        return loglik

    def loss(self, inputs, indices=None, training=True, end_hints=None):
        """Negative (MAP) training objective, scalar: mean weighted loglik
        + scaled prior − aux losses, negated. ``end_hints`` clamp
        chunk-border emissions (hint-constrained MAP training)."""
        ll = self.log_likelihood(inputs, end_hints=end_hints, training=training)
        objective = self.apply_sequence_weights(ll, indices, aggregate=True)
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
        if self._sparse_route():
            loss = self._sparse_cross_entropy(inputs, labels, label_mask, end_hints, training, no_loglik)
        else:
            loss = self._dense_cross_entropy(inputs, labels, label_mask, end_hints, training, no_loglik)
        if self.use_prior:
            loss = loss - self.compute_prior().mean()
        return loss + self.aux_loss()

    def _sparse_cross_entropy(self, inputs, labels, label_mask, end_hints, training, no_loglik):
        init, indices, probs, E = self._sparse_ingredients(inputs, end_hints, training)
        if self._route() != "data":
            return sparse_ops.sparse_posterior_cross_entropy(
                init, indices, probs, E, labels, label_mask=label_mask, no_loglik=no_loglik
            )
        # Data route: each rank's fused CE is a mean over its rows; its sum
        # (mean times max(mask sum, 1), exact for any mask sum) is summed
        # over the ranks and divided by the whole mask's sum.
        labels = torch.as_tensor(labels, device=E.device)
        if labels.dim() == 2:
            labels = labels[None].expand(E.shape[:3])
        mask = torch.ones(labels.shape, dtype=E.dtype, device=E.device) if label_mask is None else (
            torch.as_tensor(label_mask, dtype=E.dtype, device=E.device).expand(labels.shape)
        )

        def local_sum(i, p, e, lab, msk):
            mean = sparse_ops.sparse_posterior_cross_entropy(
                i, indices, p, e, lab, label_mask=msk, no_loglik=no_loglik
            )
            return mean * msk.sum().clamp_min(1.0) * (E.shape[1] / e.shape[1])

        total = self._on_rows(local_sum, (init, probs), E, labels, mask)  # row-weighted mean of b/b_k * sum
        return total / mask.sum().clamp_min(1.0)

    def _dense_cross_entropy(self, inputs, labels, label_mask, end_hints, training, no_loglik):
        lg = self.state_posterior_log_probs(
            inputs, end_hints=end_hints, training=training, no_loglik=no_loglik
        )
        labels = torch.as_tensor(labels, device=lg.device).long()
        if labels.dim() == lg.dim() - 2:
            labels = labels[None].expand(lg.shape[:-1])
        ce = -torch.gather(lg, -1, labels[..., None])[..., 0]
        if label_mask is not None:
            mask = torch.as_tensor(label_mask, dtype=ce.dtype, device=ce.device).expand(ce.shape)
            return (ce * mask).sum() / mask.sum().clamp_min(1.0)
        return ce.mean()

    def forward(self, inputs, indices=None, training=False, end_hints=None):
        """``layer(inputs)``: (loglik (m, b), aggregated loglik[, prior
        (m,), aux_loss])."""
        ll = self.log_likelihood(inputs, end_hints=end_hints, training=training)
        ll_mean = self.apply_sequence_weights(ll, indices, aggregate=True)
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
