"""Trainer side of the serving contract: the exported MLP scorer artifact."""

from .export import MLPScorer, export_mlp_scorer, load_scorer, scorer_to_bytes  # noqa: F401
