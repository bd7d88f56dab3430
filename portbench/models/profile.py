"""The profile-HMM configurations: weights and batches made from the seed,
the port's layer built on those weights, and the MAP objective on both
sides.

A configuration file names this family (``"family": "profile"``) and gives
``model`` (``lengths``, ``num_seqs``, ``use_prior``, ``parallel_factor``,
``input_dim``), ``weights`` (``noise_sd``) and the shapes. The port is
imported only inside :func:`build_program`.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import seeds
from portbench.reference import profile as ref
from portbench.reference.hmm import F64


def parameter_bases(cfg):
    """name -> base value (float64) of every parameter, in the order the
    noise is drawn: per model its transition parts (the defaults' means),
    then the flank-init logits (0), then per model the match and the
    insertion emission logits (0)."""
    lengths, s = cfg["model"]["lengths"], cfg["model"]["input_dim"] - 1
    out = {}
    for i, n in enumerate(lengths):
        for name, value in ref.base_kernels(n).items():
            out[f"transitions.kernels.{i}.{name}"] = value
    for i in range(len(lengths)):
        out[f"transitions.flank_init_kernel.{i}"] = np.zeros(1)
    for i, n in enumerate(lengths):
        out[f"emissions.0.emission_kernel.{i}"] = np.zeros((n, s))
        out[f"emissions.0.insertion_kernel.{i}"] = np.zeros(s)
    return out


def make_params(cfg, seed, device):
    return seeds.noisy_params(parameter_bases(cfg), cfg["weights"]["noise_sd"], seed, device)


def build_program(cfg, params, device):
    """The port's layer: ``ProfileTransitions(lengths)`` and
    ``ProfileEmissions(lengths, input_dim)`` with the priors, the seeded
    weights loaded."""
    from hmm_layer_torch import HMMLayer
    from hmm_layer_torch.models import ProfileEmissions, ProfileTransitions

    m = cfg["model"]
    layer = HMMLayer(
        ProfileTransitions(m["lengths"]),
        ProfileEmissions(m["lengths"], input_dim=m["input_dim"]),
        use_prior=m["use_prior"],
        num_seqs=m["num_seqs"],
        parallel_factor=m["parallel_factor"],
        device=device,
    )
    seeds.load_params(layer, params)
    return layer


def make_train_pool(cfg, traffic, params, seed, device):
    """``traffic["pool"]`` batches (m, b, L, s + 1): uniform random residues
    0..s-1, one-hot, shared by the m models."""
    gen = seeds.generator(seed, "inputs", device)
    m = len(cfg["model"]["lengths"])
    b, L, s1 = cfg["shape"]["batch"], cfg["shape"]["length"], cfg["model"]["input_dim"]
    n = traffic["pool"]
    res = torch.randint(0, s1 - 1, (n, b, L), generator=gen, device=device)
    x = torch.nn.functional.one_hot(res, s1).float()
    return [x[i][None].expand(m, b, L, s1) for i in range(n)]


def program_loss(layer):
    """None: ``Trainer.fit`` drives its default objective, ``layer.loss``."""
    return None


def reference_loss(cfg):
    m = cfg["model"]

    def loss(params, x, prec=F64):
        return ref.map_loss(params, m["lengths"], x[0], m["num_seqs"], prec)

    return loss


__all__ = ["make_params", "build_program", "make_train_pool", "program_loss", "reference_loss"]


def shape_of(cfg, traffic):
    m = cfg["model"]
    return {"m": len(m["lengths"]), "b": cfg["shape"]["batch"], "L": cfg["shape"]["length"],
            "qs": [2 * n + 3 for n in m["lengths"]], "s": m["input_dim"]}


def unit_ops(cfg, traffic):
    """Operations of one MAP training step."""
    from portbench import counts

    return counts.map_step_ops(shape_of(cfg, traffic))
