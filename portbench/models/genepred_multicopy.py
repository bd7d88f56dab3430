"""The multi-copy gene-structure configurations: weights made from the
seed, the port's k-copy layer built on those weights, and the decode's
shapes and operations. The contigs are the 15-state family's.

A configuration file names this family (``"family":
"genepred_multicopy"``) and gives ``model`` (``copies``, the codon
patterns, ``initial_*_len``, ``parallel_factor``) and ``weights``
(``noise_sd``). The port is imported only inside :func:`build_program`.
"""

from __future__ import annotations

import numpy as np

from portbench import seeds
from portbench.models.genepred import NUM_CLASSES, codons, make_contigs  # noqa: F401
from portbench.reference import genepred_multicopy as ref


def copies(cfg) -> int:
    return cfg["model"]["copies"]


def _lens(cfg):
    return {k: v for k, v in cfg["model"].items() if k.startswith("initial_")}


def parameter_bases(cfg):
    """name -> base value (float64 array) of every parameter, in the order
    the noise is drawn: the k-copy length-geometry transition logits, zero
    starting logits, zero class-emission logits (1 + 12k parameter
    states)."""
    k = copies(cfg)
    return {
        "transitions.transition_kernel": ref.base_transition_logits(k, **_lens(cfg)),
        "transitions.starting_distribution_kernel": np.zeros(ref.num_states(k)),
        "emissions.0.emission_kernel": np.zeros((1, 1 + 12 * k, NUM_CLASSES)),
    }


def make_params(cfg, seed, device):
    """The seeded weights, float32 on ``device``: each base plus
    ``noise_sd`` N(0, 1), drawn in one call."""
    return seeds.noisy_params(parameter_bases(cfg), cfg["weights"]["noise_sd"], seed, device)


def build_program(cfg, params, device):
    """The port's layer: ``GenePredMultiTransitions(k)`` and
    ``GenePredEmissions(num_copies=k, init=make_15_class_emission_kernel(
    num_copies=k), **codons)`` on the default dense route, with the seeded
    weights loaded."""
    from hmm_layer_torch import HMMLayer
    from hmm_layer_torch.models import GenePredEmissions, GenePredMultiTransitions
    from hmm_layer_torch.models.initializers import make_15_class_emission_kernel

    k = copies(cfg)
    layer = HMMLayer(
        GenePredMultiTransitions(k=k, **_lens(cfg)),
        GenePredEmissions(num_copies=k, init=make_15_class_emission_kernel(num_copies=k), **codons(cfg)),
        parallel_factor=cfg["model"]["parallel_factor"],
        device=device,
    )
    seeds.load_params(layer, params)
    return layer


# -- the yardstick's shapes --------------------------------------------------------


def shape_of(cfg, traffic):
    """The shapes a decoded window batch runs at (the decode's own
    parallel factor: 1 at q > 16)."""
    from hmm_layer_torch.ops.recursion import recommended_parallel_factor

    b, L, q = traffic["batch"], traffic["window"], ref.num_states(copies(cfg))
    P = cfg["model"]["parallel_factor"]
    if P == "auto":
        P = recommended_parallel_factor(L, q, 1, True)
    return {"m": 1, "b": b, "L": L, "q": q, "P": P, "s": NUM_CLASSES}


def unit_ops(cfg, traffic):
    """Operations of one window batch: a max-plus pass (2q^2), the
    backtrace and the emissions a position (``counts.decode_batch_ops``)."""
    from portbench import counts

    return counts.decode_batch_ops(shape_of(cfg, traffic))
