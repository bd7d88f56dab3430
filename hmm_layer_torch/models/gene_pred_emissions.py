"""Gene-prediction HMM emission models (port of
``hmm_layer_tpu/models/gene_pred_emissions.py``).

* :class:`SimpleGenePredEmissions` — ``1 + 6·num_copies`` states scored from
  class predictions, optional MVN embedding emissions with temperature
  (``emit_embeddings``), optional shared intron parameters, ``end_hints``
  border masking.
* :class:`GenePredEmissions` — ``1 + 14·num_copies`` states: START, STOP,
  donor and acceptor states multiply their class emissions by fixed
  codon-probability tables contracted against 3-mer encodings of the
  nucleotide track (or looked up from a (125, 9) table of base-5 codon
  indices, ``onehot_lookup_kmers``), plus optional trainable exon
  nucleotide distributions and the MVN L2 auxiliary loss.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.kmer import encode_kmer_string, make_k_mers
from ..utils.bijectors import DefaultDiagBijector
from .emission_utils import apply_end_hints, block_ranges
from .mvn import MvnMixture

__all__ = [
    "SimpleGenePredEmissions",
    "GenePredEmissions",
    "make_codon_probs",
    "assert_codons",
]


def assert_codons(codons):
    """Raise ``ValueError`` unless ``codons`` is a distribution over triplets."""
    total = sum(p for _, p in codons)
    if abs(total - 1.0) >= 1e-6:
        raise ValueError(f"codon probabilities must sum to 1: {codons}")
    for triplet, prob in codons:
        if len(triplet) != 3:
            raise ValueError(f"triplets must have length 3: {codons}")
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"probabilities must be in [0, 1]: {codons}")


def make_codon_probs(codons, pivot_left: bool) -> np.ndarray:
    """Weighted sum of encoded 3-mers, flattened to (1, 64)."""
    assert_codons(codons)
    table = sum(
        prob * np.asarray(encode_kmer_string(triplet, pivot_left))
        for triplet, prob in codons
    )
    return table.reshape(1, 64)


class SimpleGenePredEmissions(nn.Module):
    """Emissions for the 7-state (per copy) gene grammar.

    State order: ``Ir, I0*c, I1*c, I2*c, E0*c, E1*c, E2*c``.

    The module owns ``emission_kernel`` (m, num_param_states, input_dim):
    ``init`` as an array gives it (and ``input_dim``) directly; a scalar
    ``init`` fills it, with ``input_dim`` class channels (default: one per
    state). With ``emit_embeddings`` the inputs carry ``embedding_dim``
    trailing embedding channels, scored per state by an MVN
    (:class:`~hmm_layer_torch.models.mvn.MvnMixture`) whose kernel
    ``embedding_emission_kernel`` (1, num_param_states, 1, num_params) is
    drawn as ``0.02 * N(0, 1)`` from ``generator``; it stays trainable
    whatever ``trainable_emissions`` says.
    """

    states_per_copy = 6

    def __init__(
        self,
        num_models: int = 1,
        num_copies: int = 1,
        init: float | np.ndarray = 0.0,
        trainable_emissions: bool = True,
        emit_embeddings: bool = False,
        embedding_dim: int | None = None,
        full_covariance: bool = False,
        initial_variance: float = 1.0,
        temperature: float = 1.0,
        share_intron_parameters: bool = True,
        input_dim: int | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if emit_embeddings:
            if embedding_dim is None:
                raise ValueError("embedding_dim is required when emit_embeddings=True")
            if num_models != 1:
                raise ValueError("embedding emissions support a single model")
            self.mvn = MvnMixture(
                embedding_dim,
                diag_only=not full_covariance,
                diag_bijector=DefaultDiagBijector(initial_variance),
            )
        else:
            if embedding_dim is not None:
                raise ValueError("embedding_dim must be None when emit_embeddings=False")
            self.mvn = None
        self.num_models = num_models
        self.num_copies = num_copies
        self.num_states = 1 + self.states_per_copy * num_copies
        self.init = init
        self.trainable_emissions = trainable_emissions
        self.emit_embeddings = emit_embeddings
        self.embedding_dim = embedding_dim
        self.full_covariance = full_covariance
        self.initial_variance = initial_variance
        self.temperature = temperature
        self.share_intron_parameters = share_intron_parameters
        self.emission_kernel = nn.Parameter(
            self._initial_kernel(input_dim), requires_grad=trainable_emissions
        )
        if emit_embeddings:
            self.embedding_emission_kernel = nn.Parameter(self._initial_embedding_kernel(generator))

    @property
    def num_param_states(self) -> int:
        """States carrying their own emission parameters (introns may share)."""
        shared = 2 * self.num_copies if self.share_intron_parameters else 0
        return self.num_states - shared

    def _initial_kernel(self, input_dim):
        if np.isscalar(self.init):
            dim = self.num_states if input_dim is None else input_dim
            return torch.full(
                (self.num_models, self.num_param_states, dim), float(self.init)
            )
        kernel = torch.as_tensor(np.asarray(self.init, np.float32))
        if self.share_intron_parameters and kernel.shape[-2] == self.num_states:
            # Full-state init with shared introns: keep Ir + the I0 block,
            # drop the I1/I2 rows the expansion re-derives from I0.
            c = self.num_copies
            kernel = torch.cat(
                [kernel[..., : 1 + c, :], kernel[..., 1 + 3 * c :, :]], dim=-2
            )
        return kernel.clone()

    def _initial_embedding_kernel(self, generator):
        shape = (1, self.num_param_states, 1, self.mvn.num_params())
        return 0.02 * torch.randn(shape, generator=generator)

    def make_B(self):
        return torch.softmax(self.emission_kernel, dim=-1)

    def reset_parameters(
        self, input_dim: int | None = None, generator: torch.Generator | None = None
    ) -> None:
        """Fresh kernels: ``emission_kernel`` from ``init`` (``input_dim``
        class channels wide for a scalar ``init``), the embedding kernel
        drawn from ``generator``."""
        device = self.emission_kernel.device
        kernel = self._initial_kernel(input_dim).to(device)
        self.emission_kernel = nn.Parameter(kernel, requires_grad=self.trainable_emissions)
        if self.emit_embeddings:
            self.embedding_emission_kernel = nn.Parameter(
                self._initial_embedding_kernel(generator).to(device)
            )

    def prior_log_density(self) -> torch.Tensor:
        """(num_models,) zeros: the emitters carry no prior."""
        return torch.zeros(self.num_models, device=self.emission_kernel.device)

    def aux_loss(self) -> torch.Tensor:
        """Scalar zero (:class:`GenePredEmissions` adds the MVN L2 loss)."""
        return torch.zeros((), device=self.emission_kernel.device)

    def duplicate(self, share_kernels: bool = False):
        """A copy of this emitter (same config, same device) whose
        parameters are this one's own tensors (``share_kernels``) or
        copies of them."""
        copy = type(self).from_config(self.get_config()).to(self.emission_kernel.device)
        for name, param in self.named_parameters(recurse=False):
            if not share_kernels:
                param = nn.Parameter(param.detach().clone(), requires_grad=param.requires_grad)
            setattr(copy, name, param)
        return copy

    def _state_columns(self, x, states, dim: int = -1):
        """The states ``[start, stop)`` of ``x``, whose ``dim`` holds the
        parameter states: with shared intron parameters the I1 and I2
        blocks read the I0 columns."""
        c, n = self.num_copies, x.shape[dim]
        runs = [(0, 1 + c), (1, 1 + c), (1, 1 + c), (1 + c, n)] if self.share_intron_parameters else [(0, n)]
        return _take_runs(x, runs, states, dim)

    def emissions(self, inputs, end_hints=None, training: bool = False, block=None):
        """Per-state emission probabilities (m, b, L, num_states), linear space.

        Args:
            inputs: (m, b, L, s) class predictions, plus ``embedding_dim``
                trailing channels when ``emit_embeddings``.
            end_hints: optional border-state masks, (m, b, 2, num_states) or
                (m, b, P, 2, num_states) (see
                :func:`~hmm_layer_torch.models.emission_utils.apply_end_hints`).
            block: optional (rows, positions, states) ranges: only
                ``E[:, rows, positions, states]`` is computed and returned
                (the class product over the parameter columns those states
                read). With ``emit_embeddings`` a block of states still
                scores every state's density at its rows and positions, for
                the per-position maximum of the full state row.
        """
        rows, positions, states = block_ranges(inputs, self.num_states, block)
        x = inputs[:, slice(*rows), slice(*positions)]
        B = self._state_columns(self.make_B(), states, dim=1)  # (m, q_block, s)
        if self.emit_embeddings:
            d = self.embedding_dim
            emit = torch.matmul(x[..., :-d], B.transpose(-1, -2)[:, None])
            flat = x[..., -d:].reshape(1, -1, d)
            log_pdf = self.mvn.log_pdf(self.embedding_emission_kernel, flat)
            log_pdf = log_pdf.reshape(*emit.shape[:-1], -1)  # every parameter state
            # Per-position max-shift before the exponent: posterior
            # marginals, Viterbi paths and the posterior-CE objective do not
            # change under a positive per-position rescaling of E, and the
            # raw density overflows float32 once a trained component
            # sharpens (NaN losses after ~20 CE steps). The maximum carries
            # no gradient, as in the JAX package.
            log_pdf = self._state_columns(log_pdf, states) - log_pdf.amax(-1, keepdim=True).detach()
            embedding_emit = torch.exp(log_pdf / self.temperature)
            if training:
                emit = emit + 1e-10
                embedding_emit = embedding_emit + 1e-10
            emit = emit * embedding_emit
        else:
            emit = torch.matmul(x, B.transpose(-1, -2)[:, None])
        if block is None:
            return apply_end_hints(emit, end_hints)
        return apply_end_hints(emit, end_hints, (rows, positions, states), inputs.shape[2])

    def get_config(self) -> dict:
        return {
            "num_models": self.num_models,
            "num_copies": self.num_copies,
            "init": self.init if np.isscalar(self.init) else np.asarray(self.init),
            "trainable_emissions": self.trainable_emissions,
            "emit_embeddings": self.emit_embeddings,
            "embedding_dim": self.embedding_dim,
            "full_covariance": self.full_covariance,
            "initial_variance": self.initial_variance,
            "temperature": self.temperature,
            "share_intron_parameters": self.share_intron_parameters,
        }

    @classmethod
    def from_config(cls, config):
        return cls(**config)


class GenePredEmissions(SimpleGenePredEmissions):
    """15-state (per copy) emissions with codon-pattern constraints.

    State order: ``Ir, I0-2*c, E0-2*c, START*c, EI0-2*c, IE0-2*c, STOP*c``.
    Inputs carry 5 trailing one-hot ACGTN channels.

    With ``compute_kmers_in_bf16`` the (b, L, 64) 3-mer tensors are built
    in bfloat16 (exact for one-hot ACGTN inputs, whose 3-mer entries are
    powers of two) and cast to float32 for the float32 codon contraction,
    as the JAX package promotes them. With ``onehot_lookup_kmers`` the codon
    factor is instead gathered from a (2, 125, 9) table by the base-5 index
    of each position's 3-letter windows (exact for one-hot inputs; the
    nucleotide channels then carry no gradient). With
    ``trainable_nucleotides_at_exons`` the exon states multiply in a
    trainable nucleotide distribution, ``nuc_emission_kernel`` (1, 3c, 4)
    (zeros: uniform), and every other state 1/4.
    """

    states_per_copy = 14

    def __init__(
        self,
        start_codons,
        stop_codons,
        intron_begin_pattern,
        intron_end_pattern,
        l2_lambda: float = 0.01,
        trainable_nucleotides_at_exons: bool = False,
        compute_kmers_in_bf16: bool = True,
        onehot_lookup_kmers: bool = False,
        **kwargs,
    ):
        super().__init__(**kwargs)
        if trainable_nucleotides_at_exons and self.num_models != 1:
            raise ValueError("trainable nucleotide emissions support a single model")
        self.start_codons = start_codons
        self.stop_codons = stop_codons
        self.intron_begin_pattern = intron_begin_pattern
        self.intron_end_pattern = intron_end_pattern
        self.l2_lambda = l2_lambda
        self.trainable_nucleotides_at_exons = trainable_nucleotides_at_exons
        self.compute_kmers_in_bf16 = compute_kmers_in_bf16
        self.onehot_lookup_kmers = onehot_lookup_kmers

        start = make_codon_probs(start_codons, pivot_left=True)
        stop = make_codon_probs(stop_codons, pivot_left=False)
        intron_begin = make_codon_probs(intron_begin_pattern, pivot_left=True)
        intron_end = make_codon_probs(intron_end_pattern, pivot_left=False)
        any_codon = make_codon_probs([("NNN", 1.0)], pivot_left=False)
        not_stop = any_codon * (stop == 0)
        not_stop = not_stop / not_stop.sum()
        # Constrained states (the first 1 + 5c states — Ir, introns, E0, E1 —
        # are unconstrained): E2, START, EI0-2, IE0-2, STOP.
        left = np.concatenate(
            [any_codon, start] + [intron_begin] * 3 + [any_codon] * 4, axis=0
        )
        right = np.concatenate(
            [not_stop, any_codon, any_codon, not_stop, any_codon]
            + [intron_end] * 3
            + [stop],
            axis=0,
        )
        # (2, 9, 64): pivot side x constrained states x 3-mer classes.
        codon_probs = np.stack([left, right], axis=0).astype(np.float32)
        self.register_buffer("codon_probs", torch.from_numpy(codon_probs), persistent=False)
        self.register_buffer(
            "codon_lookup",
            torch.from_numpy(self._build_codon_lookup(codon_probs)) if onehot_lookup_kmers else None,
            persistent=False,
        )
        if trainable_nucleotides_at_exons:
            self.nuc_emission_kernel = nn.Parameter(self._initial_nuc_kernel())

    def _initial_nuc_kernel(self):
        return torch.zeros((self.num_models, 3 * self.num_copies, 4))

    def reset_parameters(
        self, input_dim: int | None = None, generator: torch.Generator | None = None
    ) -> None:
        super().reset_parameters(input_dim, generator)
        if self.trainable_nucleotides_at_exons:
            self.nuc_emission_kernel = nn.Parameter(
                self._initial_nuc_kernel().to(self.emission_kernel.device)
            )

    @staticmethod
    def _build_codon_lookup(codon_probs) -> np.ndarray:
        """(2, 125, 9) float32: per pivot side, the codon-pattern
        probability of every 3-letter ACGTN string (base-5 index, first
        letter most significant), built from ``encode_kmer_string`` so that
        the class layout and the N marginalisation are ``make_k_mers``'s."""
        letters = "ACGTN"
        table = np.zeros((2, 125, 9), np.float32)
        for j in range(125):
            s = letters[j // 25] + letters[(j // 5) % 5] + letters[j % 5]
            for side, pivot_left in ((0, True), (1, False)):
                enc = np.asarray(encode_kmer_string(s, pivot_left=pivot_left)).reshape(64)
                table[side, j] = codon_probs[side] @ enc
        return table

    def _codon_factor_lookup(self, nucleotides):
        """(m, b, L, 9) codon factors by table lookup (one-hot inputs)."""
        n_idx = nucleotides.argmax(-1)  # (m, b, L)
        fill = torch.full(tuple(n_idx.shape[:-1]) + (1,), 4, dtype=n_idx.dtype, device=n_idx.device)
        nxt1 = torch.cat([n_idx[..., 1:], fill], dim=-1)
        nxt2 = torch.cat([n_idx[..., 2:], fill, fill], dim=-1)
        prv1 = torch.cat([fill, n_idx[..., :-1]], dim=-1)
        prv2 = torch.cat([fill, fill, n_idx[..., :-2]], dim=-1)
        idx_left = 25 * n_idx + 5 * nxt1 + nxt2  # window (t, t+1, t+2)
        idx_right = 25 * prv2 + 5 * prv1 + n_idx  # window (t-2, t-1, t)
        return self.codon_lookup[0][idx_left] * self.codon_lookup[1][idx_right]

    def _codon_factor(self, nucleotides, positions):
        """(m, b_l, L_l, 9) codon factors at ``positions`` of the rows'
        (m, b_l, L, 5) one-hot nucleotides. The 3-mers read two positions
        on each side, so they are built on the positions with that halo;
        the ``N`` fill applies at the sequence's own ends only."""
        p0, p1 = positions
        L = nucleotides.shape[2]
        w0, w1 = max(p0 - 2, 0), min(p1 + 2, L)
        window = nucleotides[:, :, w0:w1]
        if self.onehot_lookup_kmers:
            factor = self._codon_factor_lookup(window)
        else:
            m, b, n = window.shape[:3]
            nuc_flat = window.reshape(m * b, n, 5)
            if self.compute_kmers_in_bf16:
                nuc_flat = nuc_flat.to(torch.bfloat16)
            factors = []
            for side, pivot_left in ((0, True), (1, False)):
                k_mers = make_k_mers(nuc_flat, k=3, pivot_left=pivot_left)
                k_mers = k_mers.reshape(m, b, n, 64).to(torch.float32)
                factors.append(torch.matmul(k_mers, self.codon_probs[side].T))
            factor = factors[0] * factors[1]
        return factor[:, :, p0 - w0 : p1 - w0]

    def emissions(self, inputs, end_hints=None, training: bool = False, block=None):
        """Inputs: (m, b, L, s + 5); the trailing 5 channels are one-hot ACGTN.

        ``block`` (rows, positions, states) computes only
        ``E[:, rows, positions, states]``: the class product over the
        block's states, the codon factors on the block's positions (with
        their two-position halo) and the factor columns of its states.
        """
        rows, positions, states = block_ranges(inputs, self.num_states, block)
        nucleotides = inputs[:, slice(*rows), :, -5:]
        blocked = {} if block is None else {"block": block}
        emit = super().emissions(inputs[..., :-5], end_hints=end_hints, training=training, **blocked)

        # Factor columns by state: the first 1 + 5c states (Ir, introns,
        # E0, E1) are unconstrained (1/4096); the constrained ones (E2,
        # START, EI0-2, IE0-2, STOP) take their class's column, one column
        # for each of the c copies.
        c, (s0, s1) = self.num_copies, states
        free = 1 + 5 * c
        t0, t1 = max(s0 - free, 0), max(s1 - free, 0)  # the block's constrained columns
        k0 = t0 // c  # the classes they read start here
        codon_factor = self._codon_factor(nucleotides, positions)[..., k0 : -(-t1 // c)]
        if c > 1:
            codon_factor = codon_factor.repeat_interleave(c, dim=-1)[..., t0 - k0 * c : t1 - k0 * c]
        unconstrained = codon_factor.new_full(
            tuple(codon_factor.shape[:-1]) + (max(min(s1, free) - s0, 0),), 1.0 / 4096.0
        )
        codon_factor = torch.cat([unconstrained, codon_factor], dim=-1)
        if training:
            codon_factor = codon_factor + 1e-7
        emission = emit * codon_factor

        if self.trainable_nucleotides_at_exons:
            nuc = nucleotides[:, :, slice(*positions)]
            nuc_no_n = nuc[..., :4] + nuc[..., 4:] / 4.0
            nuc_probs = torch.softmax(self.nuc_emission_kernel, dim=-1)  # (m, 3c, 4)
            # Exon states (E0-2, states 1 + 3c .. 1 + 6c) take their column,
            # every other state 1/4.
            e0, e1 = min(max(s0, 1 + 3 * c), 1 + 6 * c), max(min(s1, 1 + 6 * c), 1 + 3 * c)
            exon_probs = nuc_probs[:, e0 - 1 - 3 * c : e1 - 1 - 3 * c]
            exon_factor = torch.matmul(nuc_no_n, exon_probs.transpose(-1, -2)[:, None])
            lead = tuple(emission.shape[:-1])
            pre = emission.new_full(lead + (max(min(s1, e0) - s0, 0),), 0.25)
            post = emission.new_full(lead + (max(s1 - max(s0, e1), 0),), 0.25)
            emission = emission * torch.cat([pre, exon_factor, post], dim=-1)
        return emission

    def aux_loss(self) -> torch.Tensor:
        """``l2_lambda`` times the MVN scale kernel's L2 loss with
        ``emit_embeddings``, else a scalar zero."""
        if self.emit_embeddings:
            return self.l2_lambda * self.mvn.regularization_l2_loss(self.embedding_emission_kernel)
        return super().aux_loss()

    def get_config(self) -> dict:
        config = super().get_config()
        config.update(
            {
                "start_codons": self.start_codons,
                "stop_codons": self.stop_codons,
                "intron_begin_pattern": self.intron_begin_pattern,
                "intron_end_pattern": self.intron_end_pattern,
                "l2_lambda": self.l2_lambda,
                "trainable_nucleotides_at_exons": self.trainable_nucleotides_at_exons,
                "compute_kmers_in_bf16": self.compute_kmers_in_bf16,
                "onehot_lookup_kmers": self.onehot_lookup_kmers,
            }
        )
        return config


def _take_runs(x, runs, columns, dim: int = -1):
    """Columns ``[start, stop)`` of the concatenation of ``x``'s column
    runs ``[(start, stop), ...]`` along ``dim``: the runs' overlapping
    slices, concatenated."""
    c0, c1 = columns
    parts, at = [], 0
    for a, b in runs:
        lo, hi = max(c0 - at, 0), min(c1 - at, b - a)
        if lo < hi:
            parts.append(x.narrow(dim, a + lo, hi - lo))
        at += b - a
    if not parts:
        return x.narrow(dim, 0, 0)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)
