"""Trainer: the batch MLP and graph training loops (``train.py``), the
streaming MLP trainer (``streaming.py``), the online graph trainer
(``online_graph.py``), federated FedAvg (``federated.py``), the scorer
artifacts (``export.py``) and the trainer service (``service.py``)."""

from .ingest import EdgeBatches, load_download_dataset, split_columns  # noqa: F401
from .train import (  # noqa: F401
    EvalMetrics,
    TrainConfig,
    train_gat_ranker,
    train_graphsage,
    train_mlp,
)

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
from .federated import ClusterShard, FederatedConfig, FederatedTrainer  # noqa: F401
from .online_graph import (  # noqa: F401
    OnlineGraphConfig,
    OnlineGraphTrainer,
    WireIngestAdapter,
    state_hash,
)
