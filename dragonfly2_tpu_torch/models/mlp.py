"""Model helpers shared with the MLP regressor.

Port of ``dragonfly2_tpu/models/mlp.py``: so far ``warm_start_output_bias``
only, which the graph trainer applies to the GAT ranker's head.
``MLPConfig`` and ``MLPRegressor`` come with the MLP trainer.
"""

from __future__ import annotations

import torch
from torch import nn


def warm_start_output_bias(model: nn.Module, target_mean: float) -> nn.Module:
    """Shift the OUTPUT layer's bias by ``target_mean``, in place.

    Regression warm start: with Huber's linear tail, a zero-init head that
    is many log-units from the targets spends thousands of steps closing a
    constant offset.  The output layer is the highest-numbered top-level
    ``Dense_i`` submodule (flax auto-naming, kept by the port's models).
    """
    last = max(
        (name for name, _ in model.named_children() if name.startswith("Dense_")),
        key=lambda k: int(k.split("_")[1]),
    )
    with torch.no_grad():
        getattr(model, last).bias.add_(float(target_mean))
    return model
