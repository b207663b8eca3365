"""Models: the GAT parent-peer ranker over the probe graph and the MLP
bandwidth regressor."""

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
from .mlp import MLPConfig, MLPRegressor, warm_start_output_bias  # noqa: F401
