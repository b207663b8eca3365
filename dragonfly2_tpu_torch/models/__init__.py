"""Models: the GAT parent-peer ranker over the probe graph."""

from .gnn import (  # noqa: F401
    GATLayer,
    GATRanker,
    GNNConfig,
    NeighborTable,
    NodeEmbedding,
    build_neighbor_table,
    load_flax_params,
    to_flax_params,
)
from .mlp import warm_start_output_bias  # noqa: F401
