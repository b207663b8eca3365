"""Trainer: the GAT ranker's training loop, the streaming MLP trainer
(``trainer/streaming.py``) and the scorer artifacts."""

from .export import (  # noqa: F401
    GNNScorer,
    MLPScorer,
    export_from_state,
    export_gnn_scorer,
    export_mlp_scorer,
    feature_snapshot_stats,
    gnn_scorer_to_bytes,
    load_scorer,
    scorer_to_bytes,
)
