"""The port's simulators (``hmm_layer_torch.models.simulate``) against the
JAX package's on the same seeds: the same sampled paths and symbols, the
same synthetic genome (sequence, gene features, noisy class tracks) and
the same embeddings; and a simulated contig decoded by the port's layer
scores as an annotation."""

import numpy as np
import pytest

from hmm_layer_tpu.models import simulate as jsim
from hmm_layer_torch.models import simulate as tsim


def _hmm(seed, q=6, s=4):
    rng = np.random.default_rng(seed)
    init = rng.dirichlet(np.ones(q))
    A = rng.dirichlet(np.ones(q), size=q)
    B = rng.dirichlet(np.ones(s), size=q)
    return init, A, B


@pytest.mark.parametrize("terminal_state", [None, 5])
def test_sample_hmm_sequences_equal_jax(terminal_state):
    init, A, B = _hmm(0)
    ours = tsim.sample_hmm_sequences(init, A, B, np.random.default_rng(1), 7, 40, terminal_state)
    theirs = jsim.sample_hmm_sequences(init, A, B, np.random.default_rng(1), 7, 40, terminal_state)
    assert len(ours) == len(theirs) == 7
    for (p, s), (pj, sj) in zip(ours, theirs):
        np.testing.assert_array_equal(p, pj)
        np.testing.assert_array_equal(s, sj)
        assert p.dtype == pj.dtype and s.dtype == sj.dtype


@pytest.mark.parametrize("kwargs", [{}, dict(num_genes=3, mean_exons=3.0, both_strands=False, noise=0.5)])
def test_simulate_genome_equals_jax(kwargs):
    ours = tsim.simulate_genome(np.random.default_rng(5), **kwargs)
    theirs = jsim.simulate_genome(np.random.default_rng(5), **kwargs)
    assert ours.seq == theirs.seq
    assert ours.length == theirs.length
    assert [vars(g) for g in ours.genes] == [vars(g) for g in theirs.genes]
    np.testing.assert_array_equal(ours.class_probs, theirs.class_probs)
    np.testing.assert_array_equal(ours.class_probs_rc, theirs.class_probs_rc)
    np.testing.assert_array_equal(ours.onehot(), theirs.onehot())


def test_simulate_embeddings_equal_jax():
    track = np.random.default_rng(3).integers(0, 15, size=200)
    emb, means = tsim.simulate_embeddings(np.random.default_rng(4), track, dim=6)
    emb_j, means_j = jsim.simulate_embeddings(np.random.default_rng(4), track, dim=6)
    np.testing.assert_array_equal(emb, emb_j)
    np.testing.assert_array_equal(means, means_j)
    emb2, _ = tsim.simulate_embeddings(np.random.default_rng(6), track, dim=6, means=means)
    emb2_j, _ = jsim.simulate_embeddings(np.random.default_rng(6), track, dim=6, means=means_j)
    np.testing.assert_array_equal(emb2, emb2_j)


def test_exported_from_models():
    from hmm_layer_torch import models

    for name in ("sample_hmm_sequences", "simulate_genome", "simulate_embeddings", "SimulatedGenome"):
        assert getattr(models, name) is getattr(tsim, name)


def test_simulated_contig_decodes_to_its_genes():
    """The port's gene-pred layer decodes a simulated contig's class track
    (forward strand) into genes that ``evaluate_annotation`` scores against
    the planted ones."""
    import torch

    from hmm_layer_torch import HMMLayer
    from hmm_layer_torch.models import (
        GenePredEmissions,
        GenePredTransitions,
        evaluate_annotation,
        make_15_class_emission_kernel,
        paths_to_genes,
    )

    torch.set_num_threads(1)
    sim = tsim.simulate_genome(np.random.default_rng(0), num_genes=2, both_strands=False, noise=0.2)
    x = np.concatenate([sim.class_probs, sim.onehot()], axis=-1)[None, None]
    layer = HMMLayer(
        GenePredTransitions(),
        GenePredEmissions(
            init=make_15_class_emission_kernel(),
            start_codons=[("ATG", 1.0)],
            stop_codons=[("TAG", 0.34), ("TAA", 0.33), ("TGA", 0.33)],
            intron_begin_pattern=[("NGT", 0.99), ("NGC", 0.005), ("NAT", 0.005)],
            intron_end_pattern=[("AGN", 0.99), ("ACN", 0.01)],
        ),
        device="cpu",
    )
    path = layer.viterbi(x)[0, 0].numpy()
    scores = evaluate_annotation({"c": paths_to_genes(path)}, {"c": sim.genes})
    assert scores["nucleotide"]["f1"] >= 0.9, scores
    assert scores["exon"]["f1"] >= 0.5, scores
