"""Model families of the port: the gene-prediction transitions and emissions."""

from .emission_utils import apply_end_hints
from .gene_pred_emissions import (
    GenePredEmissions,
    SimpleGenePredEmissions,
    assert_codons,
    make_codon_probs,
)
from .gene_pred_transitions import GenePredTransitions, SimpleGenePredTransitions
from .transition_utils import (
    dense_from_edge_probs,
    gather_edge_probs,
    masked_row_softmax_from_edges,
    sparse_edge_softmax,
)

__all__ = [
    "GenePredEmissions",
    "GenePredTransitions",
    "SimpleGenePredEmissions",
    "SimpleGenePredTransitions",
    "apply_end_hints",
    "assert_codons",
    "dense_from_edge_probs",
    "gather_edge_probs",
    "make_codon_probs",
    "masked_row_softmax_from_edges",
    "sparse_edge_softmax",
]
