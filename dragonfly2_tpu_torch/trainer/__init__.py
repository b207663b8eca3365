"""Trainer: the GAT ranker's training loop and the scorer artifacts."""

from .export import (  # noqa: F401
    GNNScorer,
    MLPScorer,
    export_gnn_scorer,
    export_mlp_scorer,
    gnn_scorer_to_bytes,
    load_scorer,
    scorer_to_bytes,
)
