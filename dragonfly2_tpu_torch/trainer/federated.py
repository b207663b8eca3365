"""Federated multi-cluster training (BASELINE configs[3]).

Port of ``dragonfly2_tpu/trainer/federated.py``.  The reference's
deployment model is many scheduler clusters federated by one manager
(SURVEY §2.6 cluster sharding).  At fleet scale the records stay near
their cluster: each cluster trains on its own shard and only **model
deltas** cross to the manager — cross-silo federated averaging,
coordinated through the same model registry the single-cluster path
uses.

Protocol per round (manager-coordinated):
 1. coordinator broadcasts the current global params (round 0: init);
 2. each cluster runs ``local_epochs`` on its own records starting from
    the global params;
 3. coordinator aggregates: FedAvg — weighted mean of params by local
    sample count (McMahan et al. 2017's weighting);
 4. the aggregated model is evaluated on a held-out global split and
    registered (state inactive → operator/auto activation).

Normalization stats federate the same way: weighted moments merge, so one
global scorer artifact serves every cluster.

What the port changes: the model is the port's ``MLPRegressor`` on
``device``, initialized from a ``torch.Generator`` seeded with
``config.seed`` (other weights than flax's init), and the optimizer the
port's ``AdamW``; the reference's one jitted step for the whole
federation is one step function, built once (``_local_step``).  The
global parameters are a dict of flax paths → float32 device tensors, and
the weighted mean runs on the device.  The numpy logic (the pooled
normalizer, the shuffles, the batch slicing) is the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.mlp import MLPConfig, MLPRegressor, warm_start_output_bias
from ..ops import _build
from ..records.features import mask_post_hoc
from .export import MLPScorer, export_mlp_scorer
from .train import (
    EvalMetrics,
    TrainConfig,
    _huber,
    _make_optimizer,
    _regression_metrics,
)

Params = Dict[str, torch.Tensor]


@dataclass
class FederatedConfig:
    rounds: int = 5
    local_epochs: int = 3
    batch_size: int = 1024
    learning_rate: float = 1e-3
    warmup_steps: int = 10
    seed: int = 0


@dataclass
class ClusterShard:
    """One scheduler cluster's local dataset (rows in DOWNLOAD_COLUMNS)."""

    cluster_id: str
    rows: np.ndarray

    @property
    def n_samples(self) -> int:
        return self.rows.shape[0]


def _tree_weighted_mean(trees: Sequence[Params], weights: Sequence[float]) -> Params:
    """Σ tree_i · (w_i / Σw), leaf by leaf, summed in shard order (the
    reference's float32 arithmetic)."""
    total = float(sum(weights))
    out = {}
    for name in trees[0]:
        acc = trees[0][name] * (weights[0] / total)
        for t, w in zip(trees[1:], weights[1:]):
            acc = acc + t[name] * (w / total)
        out[name] = acc
    return out


class FederatedTrainer:
    """Cross-cluster FedAvg of the MLP bandwidth regressor on ``device``
    (``"cuda"`` unless the caller asks for the CPU; no CUDA device raises).

    ``train_local`` is overridable: the default runs in-process (each
    cluster's shard trained sequentially); a deployment runs it as the
    per-cluster job and ships params back through the manager.
    """

    def __init__(
        self,
        shards: Sequence[ClusterShard],
        *,
        config: Optional[FederatedConfig] = None,
        model_config: Optional[MLPConfig] = None,
        device="cuda",
    ) -> None:
        if not shards:
            raise ValueError("no cluster shards")
        self.shards = list(shards)
        self.config = config or FederatedConfig()
        self.model_config = model_config or MLPConfig()
        self.device = _build.resolve_device(device)
        # Global normalizer from pooled moment merge (post-hoc masked).
        ms, ws = [], []
        for s in self.shards:
            feats = mask_post_hoc(s.rows[:, 2 : 2 + self.model_config.in_dim])
            ms.append((feats.mean(axis=0), feats.var(axis=0)))
            ws.append(s.n_samples)
        total = float(sum(ws))
        mean = sum(m * (w / total) for (m, _), w in zip(ms, ws))
        var = sum(
            (v + (m - mean) ** 2) * (w / total) for (m, v), w in zip(ms, ws)
        )
        std = np.sqrt(var)
        self.feat_mean = mean.astype(np.float32)
        self.feat_std = np.where(std < 1e-3, 1.0, std).astype(np.float32)
        # The one module every local round and evaluation runs in: the
        # parameters it holds are overwritten from a params dict first.
        self.model = MLPRegressor(
            self.model_config,
            generator=torch.Generator().manual_seed(self.config.seed),
        )
        # Output bias starts at the global target mean: with Huber's linear
        # tail, a zero-init regressor ~17 log-units from the targets needs
        # many federated rounds just to close the constant offset.
        target_mean = float(
            sum(float(s.rows[:, -1].sum()) for s in self.shards)
            / max(sum(s.n_samples for s in self.shards), 1)
        )
        warm_start_output_bias(self.model, target_mean)
        self.model.to(self.device)
        self.global_params: Params = self._params()
        self._step_fn = None
        self.history: List[Dict] = []

    # -- parameters ------------------------------------------------------------

    def _params(self) -> Params:
        """A copy of the module's parameters, by flax path."""
        return {
            name.replace(".", "/"): p.detach().clone()
            for name, p in self.model.named_parameters()
        }

    def _load(self, params: Params) -> None:
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(params[name.replace(".", "/")])

    # -- local work ----------------------------------------------------------

    def _local_step(self):
        """One shared step function, built ONCE for the whole federation.
        The optimizer schedule uses the mean shard size — per-shard step
        counts differ only in LR decay pacing.  → (optimizer factory,
        step)."""
        if self._step_fn is not None:
            return self._make_opt, self._step_fn
        cfg = self.config
        mean_rows = int(np.mean([s.n_samples for s in self.shards]))
        tcfg = TrainConfig(
            learning_rate=cfg.learning_rate,
            warmup_steps=cfg.warmup_steps,
            epochs=cfg.local_epochs,
        )
        steps_per_epoch = max(mean_rows // cfg.batch_size, 1)
        model = self.model

        def make_opt():
            return _make_optimizer(list(model.parameters()), tcfg, steps_per_epoch)

        def step(opt, feats, target):
            # The reference applies the model without train=True: no dropout.
            loss = _huber(model(feats), target)
            grads = torch.autograd.grad(loss, opt.params)
            opt.update(list(grads))
            return loss.detach()

        self._make_opt, self._step_fn = make_opt, step
        return make_opt, step

    def train_local(self, shard: ClusterShard, params: Params) -> Tuple[Params, int]:
        """One cluster's round: local_epochs of AdamW from the global params
        (fresh optimizer state).  Returns (new_params, n_samples)."""
        cfg = self.config
        feats_all = mask_post_hoc(
            shard.rows[:, 2 : 2 + self.model_config.in_dim]
        )
        feats_all = (feats_all - self.feat_mean) / self.feat_std
        targets_all = shard.rows[:, -1].astype(np.float32)
        feats_dev = torch.from_numpy(np.ascontiguousarray(feats_all, np.float32)).to(self.device)
        targets_dev = torch.from_numpy(targets_all).to(self.device)

        make_opt, step = self._local_step()
        self._load(params)
        opt = make_opt()
        rng = np.random.default_rng(cfg.seed)
        b = min(cfg.batch_size, len(feats_all))
        for epoch in range(cfg.local_epochs):
            order = rng.permutation(len(feats_all))
            for start in range(0, len(order) - b + 1, b):
                idx = torch.from_numpy(order[start : start + b]).to(self.device)
                step(opt, feats_dev[idx], targets_dev[idx])
        return self._params(), shard.n_samples

    # -- coordination --------------------------------------------------------

    def run_round(self) -> None:
        results = [self.train_local(s, self.global_params) for s in self.shards]
        self.global_params = _tree_weighted_mean(
            [p for p, _ in results], [n for _, n in results]
        )

    def run(self, eval_rows: Optional[np.ndarray] = None) -> EvalMetrics:
        metrics = EvalMetrics()
        for r in range(self.config.rounds):
            self.run_round()
            if eval_rows is not None:
                metrics = self.evaluate(eval_rows)
                self.history.append({"round": r, "mae": metrics.mae})
        return metrics

    @torch.no_grad()
    def predict(self, rows: np.ndarray) -> np.ndarray:
        """The global model's predictions for ``rows`` (DOWNLOAD_COLUMNS)."""
        feats = mask_post_hoc(rows[:, 2 : 2 + self.model_config.in_dim])
        feats = (feats - self.feat_mean) / self.feat_std
        self._load(self.global_params)
        x = torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(self.device)
        return self.model(x).float().cpu().numpy()

    def evaluate(self, rows: np.ndarray) -> EvalMetrics:
        return _regression_metrics(self.predict(rows), rows[:, -1].astype(np.float32))

    def export_scorer(self) -> MLPScorer:
        self._load(self.global_params)
        return export_mlp_scorer(
            self.model,
            feat_mean=self.feat_mean,
            feat_std=self.feat_std,
            post_hoc_masked=True,
        )

    def publish(self, registry, *, scheduler_id: str = "federated") -> "object":
        """Register the aggregated model (manager CreateModel path)."""
        from .export import scorer_to_bytes

        return registry.create_model(
            name="parent-bandwidth-mlp",
            type="mlp",
            scheduler_id=scheduler_id,
            artifact=scorer_to_bytes(self.export_scorer()),
            evaluation=self.history[-1] if self.history else {},
        )
