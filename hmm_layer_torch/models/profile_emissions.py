"""Profile-HMM emission model: match multinomials over amino acids (port of
``hmm_layer_tpu/models/profile_emissions.py``).

* Per model a match kernel ``(L, s)`` and one insertion kernel ``(s,)``
  (frozen by default), parameters ``emission_kernel.{i}`` and
  ``insertion_kernel.{i}`` under the JAX params' tree paths.
* Emission matrix rows ordered ``[insert(left flank), match x L,
  insert x (L-1), unannotated, right flank, terminal one-hot]``, a zero
  column appended for the terminal symbol, padded with zero rows and
  stacked across models.
* Scoring is the input distribution times Bᵀ, an IEEE float32 ``einsum``.
* Dirichlet amino-acid prior (:class:`~.priors.AminoAcidPrior`).
* ``duplicate`` and ``resize`` model surgery.
"""

from __future__ import annotations

import enum

import numpy as np
import torch
from torch import nn

from .emission_utils import apply_end_hints, block_ranges
from .priors import AminoAcidPrior
from .profile_transitions import ProfileTransitions, get_num_states

__all__ = ["ProfileEmissions", "TemperatureMode"]


class TemperatureMode(enum.Enum):
    """Softmax-temperature schedule selectors.

    Carried for config parity: the enum labels which schedule an outer
    training loop should apply; no mode changes emission scoring, and
    :class:`ProfileEmissions` itself does not read it."""

    TRAINABLE = 1
    LENGTH_NORM = 2
    COLD_TO_WARM = 3
    WARM_TO_COLD = 4
    CONSTANT = 5
    NONE = 6

    @staticmethod
    def from_string(name: str) -> "TemperatureMode":
        return TemperatureMode[name.upper()]


def _default_input_dim():
    from ..data import PROTEIN_ALPHABET

    return len(PROTEIN_ALPHABET) + 1  # the alphabet and the terminal symbol


class ProfileEmissions(nn.Module):
    """Multinomial amino-acid emissions for one or more profile HMMs.

    Args:
        lengths: model length or list of lengths.
        emission_init: initializer (or list, one per model) for the match
            kernels, ``f(generator, (L, s))``; ``None`` gives zeros.
        insertion_init: initializer (or list) for the insertion kernel,
            ``f(generator, (s,))``; ``None`` gives zeros.
        prior: emission prior; defaults to :class:`AminoAcidPrior`.
        frozen_insertions: leave the insertion kernels out of training
            (``requires_grad=False``).
        input_dim: input channels including the terminal one (``s + 1``);
            default the protein encoding's (:func:`hmm_layer_torch.data.
            encode_protein`, 26). :meth:`reset_parameters` may change it.
        generator: ``torch.Generator`` feeding the random initializers.
    """

    def __init__(
        self,
        lengths,
        emission_init=None,
        insertion_init=None,
        prior=None,
        frozen_insertions: bool = True,
        input_dim: int | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.lengths = [int(lengths)] if np.isscalar(lengths) else [int(l) for l in lengths]
        self.num_models = len(self.lengths)
        self.num_states = get_num_states(self.lengths)
        self.max_num_states = max(self.num_states)
        self.emission_init = (
            emission_init if isinstance(emission_init, list) else [emission_init] * self.num_models
        )
        self.insertion_init = (
            insertion_init if isinstance(insertion_init, list) else [insertion_init] * self.num_models
        )
        self.prior = AminoAcidPrior() if prior is None else prior
        self.frozen_insertions = frozen_insertions
        em, ins = self._draw(_default_input_dim() if input_dim is None else input_dim, generator)
        self.emission_kernel = nn.ParameterList(nn.Parameter(v) for v in em)
        self.insertion_kernel = nn.ParameterList(
            nn.Parameter(v, requires_grad=not frozen_insertions) for v in ins
        )

    def _draw(self, input_dim, generator):
        """Fresh kernels, per model the match kernel then the insertion
        kernel; ``input_dim`` includes the terminal channel (s = input_dim - 1)."""
        s = input_dim - 1
        em, ins = [], []
        for length, e_init, i_init in zip(self.lengths, self.emission_init, self.insertion_init):
            em.append(torch.zeros(length, s) if e_init is None else e_init(generator, (length, s)).float())
            ins.append(torch.zeros(s) if i_init is None else i_init(generator, (s,)).float())
        return em, ins

    @property
    def input_dim(self) -> int:
        return self.emission_kernel[0].shape[-1] + 1

    @torch.no_grad()
    def reset_parameters(
        self, input_dim: int | None = None, generator: torch.Generator | None = None
    ) -> None:
        """Fresh kernels from the initializers (the JAX ``init_params``),
        ``input_dim`` channels wide (default: as they are), the random ones
        drawn from ``generator``."""
        device = self.emission_kernel[0].device
        em, ins = self._draw(self.input_dim if input_dim is None else input_dim, generator)
        for i, (e, n) in enumerate(zip(em, ins)):
            self.emission_kernel[i] = nn.Parameter(e.to(device))
            self.insertion_kernel[i] = nn.Parameter(n.to(device), requires_grad=not self.frozen_insertions)

    def trainable_mask(self) -> dict:
        """The JAX trainable-mask tree."""
        return {
            "emission_kernel": [p.requires_grad for p in self.emission_kernel],
            "insertion_kernel": [p.requires_grad for p in self.insertion_kernel],
        }

    def make_emission_matrix_from_kernels(self, em, ins, length):
        """(2L+3, s+1) emission matrix of one model."""
        s = em.shape[-1]
        i1 = ins[None]  # left flank
        i2 = ins[None].expand(length + 1, s)  # inserts + unannotated + right flank
        emissions = torch.softmax(torch.cat([i1, em, i2], dim=0), dim=-1)
        emissions = torch.cat([emissions, torch.zeros_like(emissions[:, :1])], dim=-1)
        terminal = torch.zeros((1, s + 1), dtype=em.dtype, device=em.device)
        terminal[0, s] = 1.0
        return torch.cat([emissions, terminal], dim=0)

    def make_B(self):
        """(num_models, q_max, s+1), padded with zero rows."""
        mats = []
        for em, ins, length in zip(self.emission_kernel, self.insertion_kernel, self.lengths):
            mat = self.make_emission_matrix_from_kernels(em, ins, length)
            pad = self.max_num_states - mat.shape[0]
            if pad:
                mat = torch.cat([mat, mat.new_zeros(pad, mat.shape[-1])], dim=0)
            mats.append(mat)
        return torch.stack(mats, dim=0)

    def emissions(self, inputs, end_hints=None, training: bool = False, block=None):
        """inputs: (m, ..., s_in) distributions over the alphabet; returns
        (m, ..., q_max), or with ``block`` (rows, positions, states ranges)
        only ``E[:, rows, positions, states]``."""
        B = self.make_B()
        s_in = inputs.shape[-1]
        if block is None:
            return apply_end_hints(torch.einsum("mbls,mqs->mblq", inputs, B[..., :s_in]), end_hints)
        rows, positions, states = block_ranges(inputs, B.shape[-2], block)
        x = inputs[:, slice(*rows), slice(*positions)]
        emit = torch.einsum("mbls,mqs->mblq", x, B[:, slice(*states), :s_in])
        return apply_end_hints(emit, end_hints, (rows, positions, states), inputs.shape[2])

    def prior_log_density(self):
        return self.prior(self.make_B(), lengths=self.lengths)

    def aux_loss(self):
        return torch.zeros((), device=self.emission_kernel[0].device)

    @torch.no_grad()
    def resize(self, new_lengths, keep=None, generator: torch.Generator | None = None):
        """Param-preserving re-target to new model lengths, the emitter
        half of learnMSA's iterative length adaptation: match-kernel rows
        of surviving columns carry over, new columns take fresh initializer
        values (drawn from ``generator``), and the insertion kernel, which
        no column owns, is copied.

        Args:
            new_lengths: new match-state count per model.
            keep: per-model maps new column -> old column or -1
                (:meth:`ProfileTransitions._resize_keep`); default
                grows/shrinks at the model end.

        Returns:
            a new :class:`ProfileEmissions` on this module's device.
        """
        if np.isscalar(new_lengths):
            new_lengths = [new_lengths]
        new_lengths = [int(l) for l in new_lengths]
        if len(new_lengths) != self.num_models:
            raise ValueError(f"{len(new_lengths)} new lengths for {self.num_models} models")
        keep = ProfileTransitions._resize_keep(self.lengths, new_lengths, keep)
        device = self.emission_kernel[0].device
        new_model = ProfileEmissions(
            new_lengths,
            emission_init=self.emission_init,
            insertion_init=self.insertion_init,
            prior=self.prior,
            frozen_insertions=self.frozen_insertions,
            input_dim=self.input_dim,
            generator=generator,
        ).to(device)
        for i, k in enumerate(keep):
            new_idx = np.flatnonzero(k >= 0)
            if new_idx.size:
                rows = torch.as_tensor(new_idx, device=device)
                old = self.emission_kernel[i][torch.as_tensor(k[new_idx], device=device)]
                new_model.emission_kernel[i][rows] = old
            new_model.insertion_kernel[i].copy_(self.insertion_kernel[i])
        return new_model

    def duplicate(self, model_indices=None, share_kernels: bool = False):
        """A module holding the models ``model_indices`` (default: all),
        their kernels the same parameters (``share_kernels``) or copies."""
        if model_indices is None:
            model_indices = list(range(self.num_models))
        copy = ProfileEmissions(
            [self.lengths[i] for i in model_indices],
            emission_init=[self.emission_init[i] for i in model_indices],
            insertion_init=[self.insertion_init[i] for i in model_indices],
            prior=self.prior,
            frozen_insertions=self.frozen_insertions,
            input_dim=self.input_dim,
        ).to(self.emission_kernel[0].device)
        for j, i in enumerate(model_indices):
            for name in ("emission_kernel", "insertion_kernel"):
                p = getattr(self, name)[i]
                if not share_kernels:
                    p = nn.Parameter(p.detach().clone(), requires_grad=p.requires_grad)
                getattr(copy, name)[j] = p
        return copy

    def get_config(self):
        """Full JSON-able config, the JAX package's; ``None`` initializers
        (zero kernels) as ``None``."""
        from . import initializers as inits

        return {
            "lengths": self.lengths,
            "frozen_insertions": self.frozen_insertions,
            "emission_init": [None if fn is None else inits.init_to_config(fn) for fn in self.emission_init],
            "insertion_init": [None if fn is None else inits.init_to_config(fn) for fn in self.insertion_init],
            "prior": self.prior.get_config(),
        }

    @classmethod
    def from_config(cls, config):
        from . import initializers as inits

        def restore(specs):
            if specs is None:
                return None
            return [None if spec is None else inits.init_from_config(spec) for spec in specs]

        prior = config.get("prior")
        if prior is not None:
            prior = AminoAcidPrior.from_config(prior)
        return cls(
            config["lengths"],
            emission_init=restore(config.get("emission_init")),
            insertion_init=restore(config.get("insertion_init")),
            prior=prior,
            frozen_insertions=config.get("frozen_insertions", True),
        )
