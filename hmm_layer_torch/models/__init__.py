"""Model families of the port: the gene-prediction transitions (one gene
model, or ``k`` copies sharing the intergenic state) and emissions (with
the MVN embedding densities of :mod:`.mvn`), their initial class kernel,
and the annotation (GFF3) of decoded paths."""

from .annotation import (
    GeneFeature,
    classify_states,
    evaluate_annotation,
    flip_genes,
    genes_to_gff3,
    genes_to_states,
    paths_to_genes,
    read_gff3,
    write_gff3,
)
from .emission_utils import apply_end_hints
from .gene_pred_emissions import (
    GenePredEmissions,
    SimpleGenePredEmissions,
    assert_codons,
    make_codon_probs,
)
from .gene_pred_transitions import (
    GenePredMultiTransitions,
    GenePredTransitions,
    SimpleGenePredTransitions,
)
from .initializers import make_15_class_emission_kernel
from .mvn import MvnMixture
from .transition_utils import (
    dense_from_edge_probs,
    gather_edge_probs,
    masked_row_softmax_from_edges,
    sparse_edge_softmax,
)

__all__ = [
    "GeneFeature",
    "GenePredEmissions",
    "GenePredMultiTransitions",
    "GenePredTransitions",
    "MvnMixture",
    "SimpleGenePredEmissions",
    "SimpleGenePredTransitions",
    "apply_end_hints",
    "assert_codons",
    "classify_states",
    "dense_from_edge_probs",
    "evaluate_annotation",
    "flip_genes",
    "gather_edge_probs",
    "genes_to_gff3",
    "genes_to_states",
    "make_15_class_emission_kernel",
    "make_codon_probs",
    "masked_row_softmax_from_edges",
    "paths_to_genes",
    "read_gff3",
    "sparse_edge_softmax",
    "write_gff3",
]
