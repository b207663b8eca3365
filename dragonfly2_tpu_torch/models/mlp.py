"""MLP bandwidth regressor (the reference's ``mlp`` model type).

Port of ``dragonfly2_tpu/models/mlp.py``.  Input: DOWNLOAD_FEATURE_DIM
(32) features per parent→child edge; target: log1p(bandwidth bytes/s).

The module mirrors flax's ``MLPRegressor``: parameters are float32 and
the hidden layers compute in ``config.dtype`` (bfloat16) at exactly the
places flax casts (``Dense`` casts its input, kernel and bias; the tanh
gelu runs on the bf16 activations); the scalar head ``Dense(1)`` runs in
float32.  Kernels are ``[in, out]`` and the layers carry flax's
auto-names ``Dense_0 .. Dense_n``, so a flax param tree maps onto
``state_dict`` keys path for path (``load_flax_params``) and back
(``to_flax_params``, the exported layout).  Dropout draws from an
explicit ``torch.Generator`` and runs only with ``train=True``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..records.features import DOWNLOAD_FEATURE_DIM
from .gnn import Dense, dropout, gelu, load_flax_params, to_flax_params  # noqa: F401


@dataclass(frozen=True)
class MLPConfig:
    in_dim: int = DOWNLOAD_FEATURE_DIM
    hidden: Tuple[int, ...] = (256, 256, 128)
    dropout: float = 0.1
    dtype: torch.dtype = torch.bfloat16


class MLPRegressor(nn.Module):
    """feats [B, in_dim] → predicted log-bandwidth [B] (float32)."""

    def __init__(
        self,
        config: Optional[MLPConfig] = None,
        *,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        cfg = config or MLPConfig()
        self.config = cfg
        d = cfg.in_dim
        for i, width in enumerate(cfg.hidden):
            setattr(self, f"Dense_{i}", Dense(d, width, cfg.dtype, generator))
            d = width
        setattr(self, f"Dense_{len(cfg.hidden)}", Dense(d, 1, torch.float32, generator))

    def forward(
        self,
        x: torch.Tensor,
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        cfg = self.config
        n = len(cfg.hidden)
        x = x.to(cfg.dtype)
        for i in range(n):
            x = gelu(getattr(self, f"Dense_{i}")(x))
            if train and cfg.dropout > 0:
                x = dropout(x, cfg.dropout, generator)
        return getattr(self, f"Dense_{n}")(x)[..., 0]


def warm_start_output_bias(model: nn.Module, target_mean: float) -> nn.Module:
    """Shift the OUTPUT layer's bias by ``target_mean``, in place.

    Regression warm start: with Huber's linear tail, a zero-init head that
    is many log-units from the targets spends thousands of steps closing a
    constant offset.  The output layer is the highest-numbered top-level
    ``Dense_i`` submodule (flax auto-naming, kept by the port's models);
    the streaming and graph trainers share this single definition.
    """
    last = max(
        (name for name, _ in model.named_children() if name.startswith("Dense_")),
        key=lambda k: int(k.split("_")[1]),
    )
    with torch.no_grad():
        getattr(model, last).bias.add_(float(target_mean))
    return model
