"""Multi-device sharding over ``torch.distributed``: data, sequence and
state parallelism on a mesh of ranks (port of ``hmm_layer_tpu/parallel``):
the dense routes (:mod:`.sharding`) and the sparse engine's edge-sharded
state routes (:mod:`.sparse_sharding`). The state, sequence and
edge-sharded functions take ``local=True`` for rank-local blocks in and
out (:func:`local_ranges`)."""

from .collectives import LocalRanges, Mesh, local_ranges
from .sharding import (
    data_parallel_em_step,
    data_parallel_em_step_categorical,
    data_parallel_fn,
    init_distributed,
    make_mesh,
    replicate,
    seq_sharded_log_likelihood,
    seq_sharded_posterior,
    seq_sharded_viterbi,
    shard_batch,
    state_sharded_log_likelihood,
    state_sharded_posterior,
    state_sharded_viterbi,
)
from .sparse_sharding import (
    ShardedEdgePlan,
    edge_sharded_log_likelihood,
    edge_sharded_posterior,
    edge_sharded_viterbi,
)

__all__ = [
    "Mesh",
    "LocalRanges",
    "local_ranges",
    "init_distributed",
    "make_mesh",
    "shard_batch",
    "replicate",
    "data_parallel_fn",
    "data_parallel_em_step",
    "data_parallel_em_step_categorical",
    "state_sharded_log_likelihood",
    "state_sharded_posterior",
    "state_sharded_viterbi",
    "seq_sharded_log_likelihood",
    "seq_sharded_posterior",
    "seq_sharded_viterbi",
    "ShardedEdgePlan",
    "edge_sharded_log_likelihood",
    "edge_sharded_posterior",
    "edge_sharded_viterbi",
]
