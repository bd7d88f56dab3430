"""Model families of the port: the gene-prediction transitions (one gene
model, or ``k`` copies sharing the intergenic state) and emissions (with
the MVN embedding densities of :mod:`.mvn`), their initial class kernel,
and the annotation (GFF3) of decoded paths; the profile-HMM family
(Plan7 transitions with silent-state elimination, amino-acid emissions,
their Dirichlet priors, length adaptation) and the MSA of decoded paths;
and the simulators of planted ground truth (:mod:`.simulate`)."""

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
from .dirichlet import DirichletMixture, dirichlet_log_pdf, load_mixture_model
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
from .msa import (
    AMINO_ALPHABET,
    evaluate_msa,
    msa_column_maps,
    paths_to_msa,
    write_msa,
)
from .mvn import MvnMixture
from .priors import AminoAcidPrior, FixedDirichlet, ProfileHMMTransitionPrior
from .profile_adapt import adapt_profile_layer, match_statistics, propose_keep
from .profile_emissions import ProfileEmissions
from .profile_transitions import (
    ProfileTransitions,
    get_num_states,
    get_num_states_implicit,
)
from .simulate import (
    SimulatedGenome,
    sample_hmm_sequences,
    simulate_embeddings,
    simulate_genome,
)
from .transition_utils import (
    dense_from_edge_probs,
    gather_edge_probs,
    masked_row_softmax_from_edges,
    sparse_edge_softmax,
)

__all__ = [
    "AMINO_ALPHABET",
    "AminoAcidPrior",
    "DirichletMixture",
    "FixedDirichlet",
    "GeneFeature",
    "GenePredEmissions",
    "GenePredMultiTransitions",
    "GenePredTransitions",
    "MvnMixture",
    "ProfileEmissions",
    "ProfileHMMTransitionPrior",
    "ProfileTransitions",
    "SimpleGenePredEmissions",
    "SimpleGenePredTransitions",
    "SimulatedGenome",
    "adapt_profile_layer",
    "apply_end_hints",
    "assert_codons",
    "classify_states",
    "dense_from_edge_probs",
    "dirichlet_log_pdf",
    "evaluate_annotation",
    "evaluate_msa",
    "flip_genes",
    "gather_edge_probs",
    "genes_to_gff3",
    "genes_to_states",
    "get_num_states",
    "get_num_states_implicit",
    "load_mixture_model",
    "make_15_class_emission_kernel",
    "make_codon_probs",
    "masked_row_softmax_from_edges",
    "match_statistics",
    "msa_column_maps",
    "paths_to_genes",
    "paths_to_msa",
    "propose_keep",
    "read_gff3",
    "sample_hmm_sequences",
    "simulate_embeddings",
    "simulate_genome",
    "sparse_edge_softmax",
    "write_gff3",
    "write_msa",
]
