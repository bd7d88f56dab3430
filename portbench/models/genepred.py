"""The gene-structure configurations: weights, batches and contigs made
from the seed, the port's layer built on those weights, and the objective
on both sides.

A configuration file names this family (``"family": "genepred"``) and
gives ``model`` (the codon patterns, ``initial_*_len``), ``weights``
(``noise_sd``) and the shapes. The port is imported only inside
:func:`build_program`.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import seeds
from portbench.reference import genepred as ref
from portbench.reference.hmm import F64

NUM_CLASSES = 15


def parameter_bases(cfg):
    """name -> base value (float64 array) of every parameter, in the order
    the noise is drawn: the length-geometry transition logits, zero
    starting logits, zero class-emission logits (13 parameter states)."""
    lens = {k: v for k, v in cfg["model"].items() if k.startswith("initial_")}
    return {
        "transitions.transition_kernel": ref.base_transition_logits(**lens),
        "transitions.starting_distribution_kernel": np.zeros(ref.NUM_STATES),
        "emissions.0.emission_kernel": np.zeros((1, 13, NUM_CLASSES)),
    }


def make_params(cfg, seed, device):
    """The seeded weights, float32 on ``device``: each base plus
    ``noise_sd`` N(0, 1), drawn in one call."""
    return seeds.noisy_params(parameter_bases(cfg), cfg["weights"]["noise_sd"], seed, device)


def codons(cfg):
    return {k: [tuple(p) for p in v] for k, v in cfg["model"]["codons"].items()}


def build_program(cfg, params, device):
    """The port's layer: ``GenePredTransitions()`` and
    ``GenePredEmissions(**codons)`` with the seeded weights loaded."""
    from hmm_layer_torch import HMMLayer
    from hmm_layer_torch.models import GenePredEmissions, GenePredTransitions

    lens = {k: v for k, v in cfg["model"].items() if k.startswith("initial_")}
    layer = HMMLayer(
        GenePredTransitions(**lens),
        GenePredEmissions(**codons(cfg)),
        parallel_factor=cfg["model"]["parallel_factor"],
        device=device,
    )
    seeds.load_params(layer, params)
    return layer


def class_inputs(gen, shape, device):
    """Dirichlet(1) class probabilities and one-hot ACGT (shape + (20,)),
    float32, drawn on ``device``."""
    cls = torch.empty(shape + (NUM_CLASSES,), device=device).exponential_(generator=gen)
    cls = cls / cls.sum(-1, keepdim=True)
    nuc = torch.randint(0, 4, shape, generator=gen, device=device)
    return torch.cat([cls, torch.nn.functional.one_hot(nuc, 5).float()], -1)


def sample_labels(init, A, shape, gen):
    """(b, L) state paths of the Markov chain (init, A), drawn on the
    device: the labels of the supervised batches."""
    b, L = shape
    u = torch.rand((L, b), generator=gen, device=A.device, dtype=A.dtype)
    cum_init, cum_A = torch.cumsum(init, -1), torch.cumsum(A, -1)
    state = torch.searchsorted(cum_init.expand(b, -1).contiguous(), u[0, :, None])[:, 0]
    path = [state]
    for t in range(1, L):
        state = torch.searchsorted(cum_A[state], u[t, :, None])[:, 0]
        path.append(state)
    return torch.stack(path, 1).clamp_max(ref.NUM_STATES - 1)


def make_train_pool(cfg, traffic, params, seed, device):
    """``traffic["pool"]`` batches {x (1, b, L, 20), labels (1, b, L),
    mask (1, b, L)}: seeded inputs, labels sampled from the seeded HMM (the
    reference's float64 matrices), mask all ones."""
    gen = seeds.generator(seed, "inputs", device)
    b, L = cfg["shape"]["batch"], cfg["shape"]["length"]
    with torch.no_grad():
        init, A = ref.matrices({k: v.double() for k, v in params.items()}, F64)
        n = traffic["pool"]
        x = class_inputs(gen, (n, b, L), device)
        labels = sample_labels(init, A, (n * b, L), gen).reshape(n, b, L)
        mask = torch.ones((1, b, L), device=device)
    return [{"x": x[i : i + 1], "labels": labels[i : i + 1], "mask": mask} for i in range(n)]


def program_loss(layer):
    """The objective ``Trainer.fit`` drives: the posterior cross-entropy."""

    def loss_fn(batch, indices):
        return layer.posterior_cross_entropy(batch["x"], batch["labels"], batch["mask"])

    return loss_fn


def reference_loss(cfg):
    c = codons(cfg)

    def loss(params, batch, prec=F64):
        return ref.cross_entropy(params, batch, c, prec)

    return loss


# -- the predict traffic's contigs ---------------------------------------------


def contig_lengths(traffic):
    """The fixed ladder: ``contigs`` lengths log-spaced from ``min_bp`` to
    ``max_bp``; the seed changes only their content."""
    n = traffic["contigs"]
    return [int(round(traffic["min_bp"] * (traffic["max_bp"] / traffic["min_bp"]) ** (i / (n - 1))))
            for i in range(n)]


def make_contigs(traffic, seed, device):
    """Per contig (name, one-hot ACGT (n, 5), class probabilities of the
    forward strand (n, 15), of the reverse strand (n, 15)), float32 NumPy
    arrays drawn on ``device`` in one call per quantity."""
    gen = seeds.generator(seed, "contigs", device)
    lengths = contig_lengths(traffic)
    total = sum(lengths)
    with torch.no_grad():
        nuc = torch.nn.functional.one_hot(torch.randint(0, 4, (total,), generator=gen, device=device), 5)
        nuc = nuc.float().cpu().numpy()
        cls = torch.empty((2, total, NUM_CLASSES), device=device).exponential_(generator=gen)
        cls = (cls / cls.sum(-1, keepdim=True)).cpu().numpy()
    out, start = [], 0
    for i, n in enumerate(lengths):
        sl = slice(start, start + n)
        out.append((f"contig{i}", nuc[sl], cls[0, sl], cls[1, sl]))
        start += n
    return out


# -- the yardstick's shapes --------------------------------------------------------


def shape_of(cfg, traffic):
    """The shapes the kernels and the steps run at: a training batch, or a
    decoded window batch (the decode's own parallel factor)."""
    from hmm_layer_torch.ops.recursion import recommended_parallel_factor

    decode = traffic["kind"] == "predict"
    b, L = (traffic["batch"], traffic["window"]) if decode else (cfg["shape"]["batch"], cfg["shape"]["length"])
    P = cfg["model"]["parallel_factor"]
    if P == "auto":
        P = recommended_parallel_factor(L, ref.NUM_STATES, 1, decode)
    return {"m": 1, "b": b, "L": L, "q": ref.NUM_STATES, "P": P, "s": NUM_CLASSES}


def unit_ops(cfg, traffic):
    """Operations of one unit of work: a training step or a window batch."""
    from portbench import counts

    shape = shape_of(cfg, traffic)
    return counts.decode_batch_ops(shape) if traffic["kind"] == "predict" else counts.ce_step_ops(shape)
