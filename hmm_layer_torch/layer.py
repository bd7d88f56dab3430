"""Top-level HMM layer (port of ``hmm_layer_tpu/layer.py``, dense route).

:class:`HMMLayer` is an ``nn.Module`` that owns its transition and emission
modules and so their parameters. Its methods take the raw inputs
(m, b, L, s) and return log-space results, like the JAX layer's methods
with their ``params`` argument dropped. The layer lives on one device:
the GPU unless the caller asks for another (``device="cpu"``).

Not ported yet: ``loss``, ``posterior_cross_entropy``,
``sample_paths``, the prior and sequence weights (ROADMAP Queue 1 items
5-9), and the ``mesh``/``partition`` routes (item 13).
"""

from __future__ import annotations

import torch
from torch import nn

from .ops import recursion

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
        num_seqs: dataset size used to scale the prior (kept in the config;
            the prior itself is not ported yet).
        use_prior: add the prior to the training objective (kept in the
            config; likewise).
        parallel_factor: chunked-parallel factor along the sequence axis
            (must divide the sequence length), or ``"auto"`` for
            :func:`~hmm_layer_torch.ops.recursion.recommended_parallel_factor`
            of each input's shape.
        device: where the layer and its computation live; ``None`` means
            the GPU and raises when there is none.
    """

    def __init__(
        self,
        transitions,
        emissions,
        num_seqs: int | None = None,
        use_prior: bool = True,
        parallel_factor: int | str = 1,
        device=None,
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
        self.parallel_factor = parallel_factor
        self.to(_resolve_device(device))

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _pf(self, E, for_viterbi: bool = False) -> int:
        if self.parallel_factor == "auto":
            m, _, L, q = E.shape
            return recursion.recommended_parallel_factor(L, q, m, for_viterbi)
        return self.parallel_factor

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

    def forward_recursion(self, inputs, end_hints=None, training=False):
        """(log_forward (m, b, L, q), loglik (m, b))."""
        init, A, E = self._ingredients(inputs, end_hints, training)
        return recursion.forward(init, A, E, self._pf(E))

    def backward_recursion(self, inputs, end_hints=None, training=False):
        """log_backward (m, b, L, q)."""
        init, A, E = self._ingredients(inputs, end_hints, training)
        return recursion.backward(init, A, E, self._pf(E))

    def state_posterior_log_probs(
        self, inputs, end_hints=None, training=False, no_loglik=False
    ):
        """log P(s_t = q | x); (m, b, L, q). ``no_loglik`` skips the loglik
        normalisation."""
        init, A, E = self._ingredients(inputs, end_hints, training)
        lg, _ = recursion.posterior(init, A, E, self._pf(E), no_loglik=no_loglik)
        return lg

    def log_likelihood(self, inputs, end_hints=None, training=False):
        """Per-model per-sequence loglik; (m, b)."""
        init, A, E = self._ingredients(inputs, end_hints, training)
        return recursion.log_likelihood(init, A, E, self._pf(E))

    def viterbi(self, inputs, end_hints=None):
        """Most likely state paths; (m, b, L) int32.

        ``end_hints`` clamp chunk-border emissions as in
        :meth:`state_posterior_log_probs` (hint-constrained MAP decoding).
        """
        init, A, E = self._ingredients(inputs, end_hints, False)
        return recursion.viterbi(init, A, E, self._pf(E, for_viterbi=True))

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
            "sequence_weights": None,
            "parallel_factor": self.parallel_factor,
        }
