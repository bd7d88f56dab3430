"""Gene-prediction (Tiberius-style) HMM transition grammars (port of
``hmm_layer_tpu/models/gene_pred_transitions.py``).

* :class:`SimpleGenePredTransitions` — 7 states ``Ir, I0-2, E0-2``, 15 edges.
* :class:`GenePredTransitions` — 15 states adding ``START, EI0-2, IE0-2,
  STOP`` that enforce the gene grammar, 23 edges.
* :class:`GenePredMultiTransitions` — ``k`` gene-model copies sharing one
  intergenic state, ``1 + 14k`` states, ``1 + 22k`` edges.

Each module owns its parameters: one logit per allowed edge
(``transition_kernel``) and the starting-distribution logits
(``starting_distribution_kernel``). At ``init_component_sd=0`` (the default
of the first two) they are deterministic and equal the JAX package's
``init_params``; the multi-copy grammar draws noise by default (sd 0.2), so
compare it with JAX on parameters carried across
(:func:`~hmm_layer_torch.convert.load_jax_params`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .transition_utils import masked_row_softmax_from_edges, sparse_edge_softmax

__all__ = ["SimpleGenePredTransitions", "GenePredTransitions", "GenePredMultiTransitions"]


class SimpleGenePredTransitions(nn.Module):
    """7-state exon/intron/intergenic grammar.

    State order: ``Ir, I0, I1, I2, E0, E1, E2``.

    Args:
        sparse_forward: route the layer's inference and training through
            the sparse edge-list engine (:mod:`hmm_layer_torch.ops.sparse`)
            over :meth:`make_A_sparse`; the dense (q, q) matrix is never
            built. For large multi-copy models (q = 1 + 14k).
        generator: draws the ``init_component_sd`` noise of the
            intergenic out-edges (none is drawn at the default sd of 0).
    """

    num_states = 7
    k = 1

    def __init__(
        self,
        num_models: int = 1,
        initial_exon_len: int = 100,
        initial_intron_len: int = 10000,
        initial_ir_len: int = 10000,
        starting_distribution_trainable: bool = True,
        transitions_trainable: bool = True,
        init_component_sd: float = 0.0,
        sparse_forward: bool = False,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.sparse_forward = sparse_forward
        self.num_models = num_models
        self.initial_exon_len = initial_exon_len
        self.initial_intron_len = initial_intron_len
        self.initial_ir_len = initial_ir_len
        self.starting_distribution_trainable = starting_distribution_trainable
        self.transitions_trainable = transitions_trainable
        self.init_component_sd = init_component_sd
        self.indices = self.make_transition_indices()
        self.num_transitions = len(self.indices)
        # The edge list on the module's device: no host-to-device copy
        # (and so no stream sync) when the matrices are built.
        self.register_buffer(
            "edge_indices", torch.from_numpy(self.indices), persistent=False
        )
        self.transition_kernel = nn.Parameter(
            torch.from_numpy(self.make_transition_init(generator)),
            requires_grad=transitions_trainable,
        )
        self.starting_distribution_kernel = nn.Parameter(
            torch.zeros(self.num_states),
            requires_grad=starting_distribution_trainable,
        )

    # -- static structure ---------------------------------------------------

    def make_transition_indices(self) -> np.ndarray:
        """(n_edges, 2) allowed (from, to) pairs."""
        Ir = 0
        I = list(range(1, 4))
        E = list(range(4, 7))
        edges = [(Ir, Ir), (Ir, E[0]), (E[2], Ir)]
        for cds in range(3):
            edges.append((E[cds], E[(cds + 1) % 3]))
            edges.append((E[cds], I[cds]))
            edges.append((I[cds], I[cds]))
            edges.append((I[cds], E[(cds + 1) % 3]))
        assert len(edges) == 15
        return np.asarray(edges, np.int64)

    def _is_intergenic_loop(self, e):
        return e[0] == e[1] == 0

    def _is_intron_loop(self, e):
        return e[0] == e[1] and 0 < e[0] < 1 + 3 * self.k

    def _is_exon_transition(self, e):
        off = 1 + 3 * self.k
        return (
            off <= e[0] < off + 3 * self.k
            and e[1] - off == (e[0] - off + self.k) % (3 * self.k)
        )

    def _is_exon_1_out(self, e):
        return 1 + 4 * self.k <= e[0] < 1 + 5 * self.k and e[0] != e[1]

    def _is_intergenic_out(self, e):
        return e[0] == 0 and e[1] != 0

    def make_transition_init(self, generator=None) -> np.ndarray:
        """Length-geometry logits: loops get logit(1 - 1/len)."""

        def geo(length):
            p = 1.0 - 1.0 / length
            return float(-np.log(1.0 / p - 1.0))

        noise = np.zeros(len(self.indices), np.float32)
        if self.init_component_sd:
            noise = (
                torch.randn(len(self.indices), generator=generator)
                * self.init_component_sd
            ).numpy()
        init = []
        for j, e in enumerate(self.indices):
            if self._is_intergenic_loop(e):
                init.append(geo(self.initial_ir_len))
            elif self._is_intron_loop(e):
                init.append(geo(self.initial_intron_len))
            elif self._is_exon_transition(e):
                init.append(geo(self.initial_exon_len))
            elif self._is_exon_1_out(e):
                init.append(float(np.log(0.5)))
            elif self._is_intergenic_out(e):
                init.append(float(np.log(1.0 / self.k)) + float(noise[j]))
            else:
                init.append(0.0)
        return np.asarray(init, np.float32)

    # -- matrices -------------------------------------------------------------

    def make_A(self) -> torch.Tensor:
        """(num_models, q, q) row-stochastic transition matrix."""
        A = masked_row_softmax_from_edges(
            self.edge_indices, self.transition_kernel, self.num_states
        )
        return A.expand((self.num_models,) + tuple(A.shape))

    def make_A_sparse(self):
        """Edge-list transition probabilities, never densified.

        Returns ``(indices (n_edges, 2), probs (num_models, n_edges))``:
        ``indices`` is the host (numpy) edge list, which keys the sparse
        engine's edge plan (:mod:`hmm_layer_torch.ops.sparse`).
        """
        probs = sparse_edge_softmax(self.edge_indices, self.transition_kernel, self.num_states)
        return self.indices, probs.expand(self.num_models, self.num_transitions)

    def make_log_A_sparse(self):
        """Edge-list log-probabilities; the layout of :meth:`make_A_sparse`."""
        indices, probs = self.make_A_sparse()
        return indices, torch.log(torch.clamp_min(probs, 1e-32))

    def make_initial_distribution(self) -> torch.Tensor:
        """(num_models, q)."""
        p = torch.softmax(self.starting_distribution_kernel, dim=-1)
        return p.expand(self.num_models, self.num_states)

    def matrices(self):
        """(init (m, q), A (m, q, q))."""
        return self.make_initial_distribution(), self.make_A()

    def prior_log_density(self) -> torch.Tensor:
        """(num_models,) zeros: the grammar carries no prior by default."""
        return torch.zeros(self.num_models, device=self.transition_kernel.device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Back to the initial logits, with fresh ``init_component_sd``
        noise from ``generator``."""
        init = torch.from_numpy(self.make_transition_init(generator))
        self.transition_kernel.copy_(init)
        self.starting_distribution_kernel.zero_()

    def get_config(self) -> dict:
        return {
            "num_models": self.num_models,
            "initial_exon_len": self.initial_exon_len,
            "initial_intron_len": self.initial_intron_len,
            "initial_ir_len": self.initial_ir_len,
            "starting_distribution_trainable": self.starting_distribution_trainable,
            "transitions_trainable": self.transitions_trainable,
            "init_component_sd": self.init_component_sd,
            "sparse_forward": self.sparse_forward,
        }

    @classmethod
    def from_config(cls, config):
        return cls(**config)


class GenePredTransitions(SimpleGenePredTransitions):
    """15-state grammar with START/donor/acceptor/STOP structure states.

    State order: ``Ir, I0-2, E0-2, START, EI0-2, IE0-2, STOP``.

    ``use_experimental_prior`` adds a Dirichlet prior on the binary
    (stay, leave) distributions of the loop states and (advance, other) of
    the exon states. Its concentration ``prior_alpha`` (1 + 6k, 2) is a
    buffer, left out of ``state_dict``: the binary probabilities of the
    initial matrix times 1e3, drawn with the transition init's noise from
    ``generator`` after the kernel's own draw (no noise at the default
    ``init_component_sd`` of 0, where it equals the JAX package's). Set it
    from a JAX layer's with :func:`~hmm_layer_torch.convert.set_prior_alpha`.
    """

    num_states = 15

    def __init__(
        self,
        use_experimental_prior: bool = False,
        generator: torch.Generator | None = None,
        **kwargs,
    ):
        super().__init__(generator=generator, **kwargs)
        self.use_experimental_prior = use_experimental_prior
        self.register_buffer(
            "prior_alpha",
            self.make_prior_alpha(generator) if use_experimental_prior else None,
            persistent=False,
        )

    def make_transition_indices(self) -> np.ndarray:
        Ir = 0
        I = list(range(1, 4))
        E = list(range(4, 7))
        START = 7
        EI = list(range(8, 11))
        IE = list(range(11, 14))
        STOP = 14
        edges = [(Ir, Ir), (Ir, START), (STOP, Ir), (START, E[1]), (E[1], STOP)]
        for cds in range(3):
            edges.append((E[cds], E[(cds + 1) % 3]))
            edges.append((E[cds], EI[cds]))
            edges.append((EI[cds], I[cds]))
            edges.append((I[cds], I[cds]))
            edges.append((I[cds], IE[cds]))
            edges.append((IE[cds], E[cds]))
        assert len(edges) == 23
        return np.asarray(edges, np.int64)

    # -- experimental Dirichlet prior -----------------------------------------

    def gather_binary_probs(self, A):
        """(1 + 6k, 2): (stay, leave) of the intergenic and intron states,
        then (advance, other) of the exon states, from one (q, q) ``A``."""
        k = self.k
        n = 1 + 3 * k
        diag = torch.diagonal(A[:n, :n])
        probs_loop = torch.stack([diag, A[:n].sum(-1) - diag], dim=1)
        rows = []
        for i in range(3):
            for j in range(k):
                e = 1 + (i + 3) * k + j
                next_e = 1 + 3 * k + ((i + 1) % 3) * k + j
                rows.append(torch.stack([A[e, next_e], A[e].sum() - A[e, next_e]]))
        return torch.cat([probs_loop, torch.stack(rows)], dim=0)

    def make_prior_alpha(self, generator=None, n: float = 1e3) -> torch.Tensor:
        """Dirichlet concentration anchored at the length-geometry init."""
        p0 = torch.from_numpy(self.make_transition_init(generator))
        A0 = masked_row_softmax_from_edges(torch.from_numpy(self.indices), p0, self.num_states)
        return self.gather_binary_probs(A0) * n

    def prior_log_density(self) -> torch.Tensor:
        """(num_models,): the Dirichlet log-density (up to its constant) of
        model 0's binary probabilities, with ``use_experimental_prior``;
        zeros otherwise."""
        if not self.use_experimental_prior:
            return super().prior_log_density()
        binary = self.gather_binary_probs(self.make_A()[0])
        log_p = torch.log(torch.clamp_min(binary, 1e-16))
        prior = ((self.prior_alpha - 1.0) * log_p).sum()
        return prior.expand(self.num_models)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Back to the initial logits with fresh noise from ``generator``,
        and (with the prior) a fresh ``prior_alpha`` drawn after it."""
        super().reset_parameters(generator)
        if self.use_experimental_prior:
            self.prior_alpha = self.make_prior_alpha(generator).to(self.transition_kernel.device)

    def get_config(self) -> dict:
        config = super().get_config()
        config["use_experimental_prior"] = self.use_experimental_prior
        return config


class GenePredMultiTransitions(GenePredTransitions):
    """``k`` gene-model copies sharing one intergenic state.

    State order: ``Ir, I0*k, I1*k, I2*k, E0*k, E1*k, E2*k, START*k,
    EI0*k, EI1*k, EI2*k, IE0*k, IE1*k, IE2*k, STOP*k``.
    """

    def __init__(self, k: int = 1, init_component_sd: float = 0.2, **kwargs):
        # Set before the base class builds the edge list and parameters.
        self.k = k
        self.num_states = 1 + 14 * k
        super().__init__(init_component_sd=init_component_sd, **kwargs)

    def make_transition_indices(self) -> np.ndarray:
        k = self.k
        Ir = 0
        I = list(range(1, 1 + 3 * k))
        E = list(range(1 + 3 * k, 1 + 6 * k))
        START = list(range(1 + 6 * k, 1 + 7 * k))
        EI = list(range(1 + 7 * k, 1 + 10 * k))
        IE = list(range(1 + 10 * k, 1 + 13 * k))
        STOP = list(range(1 + 13 * k, 1 + 14 * k))
        edges = [(Ir, Ir)]
        for h in range(k):
            edges += [(Ir, START[h]), (STOP[h], Ir), (START[h], E[k + h]), (E[k + h], STOP[h])]
            for cds in range(3):
                edges += [
                    (E[k * cds + h], E[k * ((cds + 1) % 3) + h]),
                    (E[k * cds + h], EI[k * cds + h]),
                    (EI[k * cds + h], I[k * cds + h]),
                    (I[k * cds + h], I[k * cds + h]),
                    (I[k * cds + h], IE[k * cds + h]),
                    (IE[k * cds + h], E[k * cds + h]),
                ]
        assert len(edges) == 1 + 22 * k
        return np.asarray(edges, np.int64)

    def get_config(self) -> dict:
        config = super().get_config()
        config["k"] = self.k
        return config
