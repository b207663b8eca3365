"""Models: GraphSAGE, the GAT and hop parent-peer rankers over the probe
graph, and the MLP bandwidth regressor."""

from .gnn import (  # noqa: F401
    GATLayer,
    GATRanker,
    GNNConfig,
    GraphSAGE,
    NeighborTable,
    NodeEmbedding,
    SAGELayer,
    build_neighbor_table,
    load_flax_params,
    to_flax_params,
)
from .hop import HopConfig, HopRanker, precompute_hop_features  # noqa: F401
from .mlp import MLPConfig, MLPRegressor, warm_start_output_bias  # noqa: F401
