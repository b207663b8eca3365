"""Train loops on one device: the MLP regressor and the graph rankers.

Port of ``dragonfly2_tpu/trainer/train.py``: ``train_mlp`` /
``evaluate_mlp`` (the batch MLP trainer of the trainer service),
``train_graphsage``, ``train_gat_ranker`` and ``train_hop_ranker`` on
``_train_graph_model``, and the checkpoints.  ``device=`` trains on one
device.  ``mesh=`` (``parallel.mesh.create_mesh``, one process per device,
every rank making the same call) trains data-parallel, as the JAX
trainers do on their mesh:
- the batch is rounded to a multiple of the data axis, and the rank at
  data coordinate ``d`` of ``n`` takes rows ``[d·b/n, (d+1)·b/n)`` of each
  global batch (the JAX package's split and order);
- one all-reduce per step averages the replicated leaves' gradients (and
  the loss) over the world before the optax global-norm clip, so the clip
  sees the global batch's gradient;
- ``train_hop_ranker(node_sharding="model")`` partitions the hop features,
  the learnable embedding and its AdamW moments by node over the model
  axis (``parallel.graph_sharding.NodeShard``): an endpoint lookup is a
  masked local gather and one all-reduce over the model group, the
  embedding's gradient is averaged over the data group, and the clip's
  norm counts each sharded leaf once (its squares summed over the model
  group);
- the GAT and GraphSAGE keep their node table whole on every rank, and
  the backward of their gather (K3) runs on each rank's slice.  The JAX
  dry run shards the GAT's node table by placement only and XLA gathers
  it back: the function is the same;
- dropout draws one mask over what the reference draws it over: the
  GAT's and GraphSAGE's over the node table, the same on every rank; the
  MLP's and the hop encoder's over the global batch, of which each data
  rank keeps its rows (``models.gnn.BatchRowsDraw``), so the mesh run's
  masks are the one-device run's.
Each rank returns the same state and metrics (a node-sharded state holds
the rank's block of its node tables).  The reference's ``batch_sharding``
and ``replicated`` placements have no counterpart: a rank slices its rows
of each batch and holds a whole copy of every replicated tensor.

What is kept exactly:
- the numpy train/validation split and the per-epoch batch order, so both
  packages train on the same batches in the same order;
- the MLP's feature standardization (numpy, from the training rows) and
  its "no full batches" refusal;
- the optimizer's semantics: optax ``clip_by_global_norm(1.0)`` (scale by
  ``max_norm / norm`` only when the norm exceeds it — not torch's
  ``clip_grad_norm_``, which divides by norm + 1e-6), then ``adamw``
  (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay on every
  parameter) over ``warmup_cosine_decay_schedule(init_value=0.0, ...)``,
  whose first step's learning rate is 0;
- the output-bias warm start at the training split's target mean, the
  Huber loss and the evaluation metrics.

Each trainer initializes its model from a ``torch.Generator`` seeded with
``config.seed`` (other weights than flax's init for the same seed), then
hands it to a loop that trains whatever parameters it holds
(``_train_mlp_model``, ``_train_graph_model``), so a parity run can carry
flax's parameters in.  Dropout draws from the state's
``torch.Generator``, so its masks differ from JAX's; parity runs use
dropout 0.  Checkpoints are ``torch.save`` files of the parameters and
the step (the JAX package writes orbax directories).
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.gnn import (
    BatchRowsDraw, Dense, GATRanker, GNNConfig, GraphSAGE, NeighborTable, gelu,
)
from ..models.hop import HopConfig, HopRanker, precompute_hop_features
from ..models.mlp import MLPConfig, MLPRegressor, warm_start_output_bias
from ..ops import _build
from ..parallel import mesh as pm
from ..parallel.graph_sharding import NodeShard, build_halo_plan, precompute_hop_features_sharded
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from .ingest import EdgeBatches


@dataclass
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 1e-4
    epochs: int = 5
    warmup_steps: int = 100
    log_every: int = 50
    seed: int = 0


@dataclass
class EvalMetrics:
    """What gets recorded in the model registry (manager model evaluation)."""

    mse: float = 0.0
    mae: float = 0.0                  # log-space MAE
    bandwidth_mae_mbps: float = 0.0   # unlogged, MB/s — BASELINE's headline metric
    precision: float = 0.0
    recall: float = 0.0
    f1: float = 0.0

    def to_dict(self) -> Dict[str, float]:
        return {
            "mse": self.mse,
            "mae": self.mae,
            "bandwidth_mae_mbps": self.bandwidth_mae_mbps,
            "precision": self.precision,
            "recall": self.recall,
            "f1": self.f1,
        }


class AdamW:
    """optax ``chain(clip_by_global_norm(1.0), adamw(schedule, wd))`` with
    optax's defaults (b1 0.9, b2 0.999, eps 1e-8).

    ``update(grads)`` applies one step to ``params`` in place: clip by
    the global norm, Adam moments and bias correction, decoupled weight
    decay, then ``-lr(count)`` with ``count`` the number of earlier
    updates (0 on the first)."""

    MAX_NORM = 1.0
    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: List[nn.Parameter], schedule, *, weight_decay: float) -> None:
        self.params = list(params)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        # On a mesh: the _MeshSync whose global norm counts sharded leaves once.
        self.sync: Optional["_MeshSync"] = None

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> None:
        if self.sync is None:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        else:
            g_norm = self.sync.global_norm(grads)
        # optax: where(norm < max_norm, g, g / norm * max_norm).
        clipped = [
            torch.where(g_norm < self.MAX_NORM, g, (g / g_norm) * self.MAX_NORM)
            for g in grads
        ]
        b1, b2 = self.B1, self.B2
        count = self.count + 1
        lr = float(self.schedule(self.count))
        c1 = 1.0 - b1 ** count
        c2 = 1.0 - b2 ** count
        for p, g, mu, nu in zip(self.params, clipped, self.mu, self.nu):
            mu.copy_((1.0 - b1) * g + b1 * mu)
            nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.EPS)
            upd = upd + self.weight_decay * p
            p.add_(-lr * upd)
        self.count = count


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
):
    """optax's schedule of the same name: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then cosine decay to
    ``end_value`` over the remaining ``decay_steps - warmup_steps``."""
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")
    alpha = end_value / peak_value if peak_value else 0.0

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        decayed = (1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / cos_steps)) + alpha
        return peak_value * decayed

    return schedule


class _MeshSync:
    """The collectives of one data-parallel step over ``mesh``.
    ``sharded[i]`` marks the parameters held as node blocks over the model
    axis; the rest are replicated on every rank."""

    def __init__(self, mesh: Mesh, sharded: List[bool]) -> None:
        self.mesh = mesh
        self.sharded = list(sharded)

    def reduce_mean(self, flat: torch.Tensor, group, n: int) -> torch.Tensor:
        return pm.all_reduce(flat, group).div_(n)

    def average(self, loss: torch.Tensor, grads: List[torch.Tensor]):
        """(the global batch's loss, every gradient averaged): the
        replicated gradients and the loss in one all-reduce over the world
        (ranks of one model group hold the same slice, so the world mean
        is the mean over the data axis), the sharded blocks' in one over
        the data group."""
        mesh = self.mesh
        out = list(grads)
        for sharded, group, n in ((False, mesh.world, mesh.size),
                                  (True, mesh.group(DATA_AXIS), mesh.shape[DATA_AXIS])):
            idx = [i for i, s in enumerate(self.sharded) if s == sharded]
            if not idx:
                continue
            parts = [grads[i].reshape(-1) for i in idx]
            if not sharded:
                parts.append(loss.reshape(1).to(grads[0].dtype))
            flat = self.reduce_mean(torch.cat(parts), group, n)
            at = 0
            for i in idx:
                k = grads[i].numel()
                out[i] = flat[at:at + k].view_as(grads[i])
                at += k
            if not sharded:
                loss = flat[at]
        return loss, out

    def norm_sq(self, repl_sq: torch.Tensor, shard_sq: torch.Tensor) -> torch.Tensor:
        """The global squared norm: the replicated leaves' once, plus each
        sharded leaf's squares summed over its blocks (the model group)."""
        return repl_sq + pm.all_reduce(shard_sq, self.mesh.group(MODEL_AXIS))

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        if not any(self.sharded):
            return torch.sqrt(sum(torch.sum(g * g) for g in grads))
        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        repl = sum((torch.sum(g * g) for g, s in zip(grads, self.sharded) if not s), zero)
        shard = sum((torch.sum(g * g) for g, s in zip(grads, self.sharded) if s), zero)
        return torch.sqrt(self.norm_sq(repl, shard))


def _make_optimizer(params, cfg: TrainConfig, steps_per_epoch: int) -> AdamW:
    total = max(cfg.epochs * steps_per_epoch, cfg.warmup_steps + 1)
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=cfg.learning_rate,
        warmup_steps=cfg.warmup_steps,
        decay_steps=total,
    )
    return AdamW(params, schedule, weight_decay=cfg.weight_decay)


@dataclass
class TrainState:
    """The model (its parameters), the optimizer, the step count, the
    dropout generator, the feature standardization an MLP was trained
    under (``None`` for graph models) and, after training, the
    validation edges and the model's predictions for them.  On a mesh
    ``opt.sync`` holds the step's collectives."""

    model: nn.Module
    opt: AdamW
    generator: torch.Generator
    step: int = 0
    feat_mean: Optional[np.ndarray] = None
    feat_std: Optional[np.ndarray] = None
    val_idx: Optional[np.ndarray] = None
    val_pred: Optional[np.ndarray] = None


def _huber(pred: torch.Tensor, target: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    err = pred - target
    abs_err = torch.abs(err)
    quad = torch.clamp(abs_err, max=delta)
    return torch.mean(0.5 * quad**2 + delta * (abs_err - quad))


def _regression_metrics(pred: np.ndarray, target: np.ndarray) -> EvalMetrics:
    err = pred - target
    mse = float(np.mean(err**2))
    mae = float(np.mean(np.abs(err)))
    bw_mae = float(np.mean(np.abs(np.expm1(pred) - np.expm1(target)))) / 1e6
    # "Good parent" = top-half bandwidth; measures ranking usefulness the way
    # the registry's gnn evaluation wants precision/recall/f1.
    thresh = np.median(target)
    pos_pred, pos_true = pred >= thresh, target >= thresh
    tp = float(np.sum(pos_pred & pos_true))
    precision = tp / max(float(np.sum(pos_pred)), 1.0)
    recall = tp / max(float(np.sum(pos_true)), 1.0)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return EvalMetrics(
        mse=mse,
        mae=mae,
        bandwidth_mae_mbps=bw_mae,
        precision=precision,
        recall=recall,
        f1=f1,
    )


# ---------------------------------------------------------------------------
# MLP (the trainer service's bandwidth regressor)
# ---------------------------------------------------------------------------


def _mlp_train_step(
    state: TrainState, feats: torch.Tensor, target: torch.Tensor,
    mean: torch.Tensor, std: torch.Tensor,
) -> Tuple[TrainState, torch.Tensor]:
    """One step on raw features: standardize, forward with dropout from
    the state's generator, Huber loss, gradients, the optimizer."""
    feats = (feats - mean) / std
    pred = state.model(feats, train=True, generator=_rows_draw(state, feats.shape[0]))
    loss = _huber(pred, target)
    grads = list(torch.autograd.grad(loss, state.opt.params))
    loss = loss.detach()
    if state.opt.sync is not None:
        loss, grads = state.opt.sync.average(loss, grads)
    state.opt.update(grads)
    state.step += 1
    return state, loss


def train_mlp(
    train_data: EdgeBatches,
    val_data: EdgeBatches,
    *,
    model_config: Optional[MLPConfig] = None,
    config: Optional[TrainConfig] = None,
    device="cuda",
    mesh: Optional[Mesh] = None,
) -> Tuple[TrainState, EvalMetrics, List[Dict[str, float]]]:
    """Train an ``MLPRegressor`` (initialized from ``config.seed``) on
    ``train_data``'s batches; → (state, validation metrics, history).
    With ``mesh`` every rank calls it and trains data-parallel on the
    mesh's device (module docstring)."""
    cfg = config or TrainConfig()
    model = MLPRegressor(
        model_config or MLPConfig(), generator=torch.Generator().manual_seed(cfg.seed)
    )
    return _train_mlp_model(model, train_data, val_data, cfg, device, mesh)


def _rows_draw(state: TrainState, rows: int):
    """Dropout's draw for a step on this rank's ``rows`` rows of each
    global batch: on a data axis of n > 1 the global batch's mask, of
    which the rank keeps its rows (``BatchRowsDraw``), so data ranks do
    not repeat each other's masks; else the state's generator."""
    sync = state.opt.sync
    if sync is None or sync.mesh.shape[DATA_AXIS] == 1:
        return state.generator
    return BatchRowsDraw(state.generator, sync.mesh.shape[DATA_AXIS],
                         sync.mesh.coord(DATA_AXIS), rows)


def _data_slice(mesh: Optional[Mesh], batch: int) -> slice:
    """This rank's rows of a global batch of ``batch`` rows."""
    if mesh is None:
        return slice(0, batch)
    per = batch // mesh.shape[DATA_AXIS]
    lo = mesh.coord(DATA_AXIS) * per
    return slice(lo, lo + per)


def _train_mlp_model(
    model: MLPRegressor,
    train_data: EdgeBatches,
    val_data: EdgeBatches,
    cfg: TrainConfig,
    device,
    mesh: Optional[Mesh] = None,
) -> Tuple[TrainState, EvalMetrics, List[Dict[str, float]]]:
    """Train ``model`` from its current parameters.  History entries add
    ``elapsed_s`` (seconds since the first step began, taken after the
    step's loss reached the host) to the JAX trainer's keys."""
    if mesh is None:
        dev = _build.resolve_device(device)
        axis_note = ""
    else:
        dev = mesh.device
        # The batch dim splits over the data axis — round to a multiple.
        data_n = mesh.shape[DATA_AXIS]
        axis_note = f" (data axis {data_n})"
        if train_data.batch_size % data_n:
            rounded = max((train_data.batch_size // data_n) * data_n, data_n)
            train_data = EdgeBatches(
                train_data.rows,
                batch_size=rounded,
                shuffle=train_data.shuffle,
                seed=train_data.seed,
                drop_remainder=train_data.drop_remainder,
            )
    if len(train_data) == 0:
        # Silently running zero steps would export an untrained (random)
        # model — fail loudly instead.
        raise ValueError(
            f"no full batches: {train_data.rows.shape[0]} rows < batch "
            f"{train_data.batch_size}{axis_note}"
        )
    warm_start_output_bias(model, float(train_data.rows[:, -1].mean()))
    in_dim = model.config.in_dim
    train_feats = train_data.rows[:, 2 : 2 + in_dim]
    feat_mean = np.asarray(train_feats.mean(axis=0), np.float32)
    raw_std = train_feats.std(axis=0)
    # Columns (near-)constant in training carry no signal — scale them by 1,
    # not by a tiny std that would amplify any serve-time deviation into a
    # distribution explosion (e.g. a single-content-length training corpus
    # meeting a different length at scheduling time).
    feat_std = np.asarray(np.where(raw_std < 1e-3, 1.0, raw_std), np.float32)
    model.to(dev)
    state = TrainState(
        model=model,
        opt=_make_optimizer(list(model.parameters()), cfg, max(len(train_data), 1)),
        generator=torch.Generator(device=dev).manual_seed(cfg.seed + 1),
        feat_mean=feat_mean,
        feat_std=feat_std,
    )
    if mesh is not None:
        state.opt.sync = _MeshSync(mesh, [False] * len(state.opt.params))
    mean_t = torch.from_numpy(feat_mean).to(dev)
    std_t = torch.from_numpy(feat_std).to(dev)
    mine = _data_slice(mesh, train_data.batch_size)

    history: List[Dict[str, float]] = []
    model.train()
    t0 = time.perf_counter()
    seen = 0
    for epoch in range(cfg.epochs):
        for feats, target, _, _ in train_data.epoch(epoch):
            state, loss = _mlp_train_step(
                state, torch.from_numpy(feats[mine]).to(dev),
                torch.from_numpy(target[mine]).to(dev), mean_t, std_t,
            )
            seen += feats.shape[0]
            if state.step % cfg.log_every == 0:
                loss_v = float(loss)
                elapsed = time.perf_counter() - t0
                history.append(
                    {
                        "step": state.step,
                        "epoch": epoch,
                        "loss": loss_v,
                        "records_per_sec": seen / elapsed,
                        "elapsed_s": elapsed,
                    }
                )
    metrics = evaluate_mlp(state, val_data)
    return state, metrics, history


@torch.no_grad()
def evaluate_mlp(state: TrainState, val_data: EdgeBatches) -> EvalMetrics:
    """Validation metrics of the state's model (eval mode) under the
    standardization it trained with."""
    model = state.model
    dev = next(model.parameters()).device
    mean_t = torch.from_numpy(state.feat_mean).to(dev)
    std_t = torch.from_numpy(state.feat_std).to(dev)
    was_training = model.training
    model.eval()
    preds, targets = [], []
    for feats, target, _, _ in val_data.epoch(0):
        x = (torch.from_numpy(feats).to(dev) - mean_t) / std_t
        preds.append(model(x).float().cpu().numpy())
        targets.append(target)
    model.train(was_training)
    return _regression_metrics(np.concatenate(preds), np.concatenate(targets))


def _graph_loss_and_grads(
    state: TrainState, node_feats, table, src, dst, target, qef
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Loss of one batch (dropout from the state's generator) and the
    gradient of every parameter."""
    model = state.model
    # The GAT and GraphSAGE drop over the node table, which every rank
    # computes whole: one mask on every rank, as the reference's one draw
    # over the table.  The hop encoder drops per batch row.
    gen = (_rows_draw(state, src.shape[0]) if isinstance(model, HopRanker)
           else state.generator)
    pred = model(node_feats, table, src, dst, qef, train=True, generator=gen)
    loss = _huber(pred, target)
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), list(grads)


def _graph_train_step(
    state: TrainState, node_feats, table, src, dst, target, qef
) -> Tuple[TrainState, torch.Tensor]:
    loss, grads = _graph_loss_and_grads(state, node_feats, table, src, dst, target, qef)
    if state.opt.sync is not None:
        loss, grads = state.opt.sync.average(loss, grads)
    state.opt.update(grads)
    state.step += 1
    return state, loss


def _is_node_table_path(name: str) -> bool:
    """True for leaves that live in per-node tables: the learnable
    embedding (``HopEncoder_0.Embed_0.embedding``, ``/`` or ``.`` joined)
    and, through their parameter's name, its two AdamW moments.  The one
    definition: the online trainer's id-recycling row reset and any
    node-sharded layout must agree on which leaves are node tables."""
    return "embedding" in name.replace("/", ".").split(".")


def split_edges(n_edges: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(val_idx, train_idx): the JAX trainer's 10 % validation split."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n_edges)
    n_val = max(int(n_edges * 0.1), 1)
    return order[:n_val], order[n_val:]


def epoch_batches(train_idx: np.ndarray, batch: int, seed: int, epoch: int):
    """The index arrays of one epoch's full batches, in the JAX trainer's order."""
    ep_order = np.random.default_rng(seed + epoch).permutation(train_idx)
    for start in range(0, len(ep_order) - batch + 1, batch):
        yield ep_order[start : start + batch]


# ---------------------------------------------------------------------------
# GraphSAGE (configs[1]): self-supervised RTT regression over the probe graph
# ---------------------------------------------------------------------------


class _SAGEEdgeModel(nn.Module):
    """The GraphSAGE encoder (``GraphSAGE_0``) and an edge head on
    [s, d, s * d] of the two endpoints' embeddings (``Dense_0``, gelu,
    ``Dense_1``): flax's inline model in the JAX ``train_graphsage``.
    ``qef`` is taken for ``_train_graph_model``'s call and must be None."""

    def __init__(
        self,
        config: GNNConfig,
        *,
        num_nodes: int,
        in_dim: int,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.config = config
        self.GraphSAGE_0 = GraphSAGE(config, num_nodes=num_nodes, in_dim=in_dim,
                                     generator=generator)
        self.Dense_0 = Dense(3 * config.out_dim, config.hidden, config.dtype, generator)
        self.Dense_1 = Dense(config.hidden, 1, torch.float32, generator)

    def forward(
        self,
        node_feats: torch.Tensor,
        table: NeighborTable,
        src: torch.Tensor,
        dst: torch.Tensor,
        qef: Optional[torch.Tensor] = None,
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if qef is not None:
            raise ValueError("the GraphSAGE edge model takes no query edge features")
        emb = self.GraphSAGE_0(node_feats, table, train=train, generator=generator)
        s = emb.index_select(0, src)
        d = emb.index_select(0, dst)
        x = torch.cat([s, d, s * d], dim=-1).to(self.config.dtype)
        x = gelu(self.Dense_0(x))
        return self.Dense_1(x)[..., 0]


def train_graphsage(
    node_feats: np.ndarray,
    table: NeighborTable,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_target: np.ndarray,       # e.g. normalized RTT per probe edge
    *,
    model_config: Optional[GNNConfig] = None,
    config: Optional[TrainConfig] = None,
    device="cuda",
    batch_size: int = 4096,
    mesh: Optional[Mesh] = None,
) -> Tuple[TrainState, EvalMetrics, List[Dict[str, float]]]:
    """Encoder pretraining: predict per-edge RTT from endpoint embeddings
    (a ``_SAGEEdgeModel`` initialized from ``config.seed``); → (state,
    validation metrics, history).  ``mesh``: data-parallel (module
    docstring).

    The probe graph's signal (EMA RTT per edge) supervises the encoder; the
    learned embeddings are the node representation the GAT ranker and the
    evaluator-facing scorer build on.  With ``model_config.gather_fn`` set
    (``ops.segment.make_neighbor_gather`` or
    ``ops.transpose_gather.make_transpose_gather`` over ``table.indices``)
    the SAGE layers gather through it."""
    cfg = config or TrainConfig()
    mcfg = model_config or GNNConfig()
    model = _SAGEEdgeModel(
        mcfg,
        num_nodes=int(node_feats.shape[0]),
        in_dim=int(node_feats.shape[1]),
        generator=torch.Generator().manual_seed(cfg.seed),
    )
    return _train_graph_model(
        model, node_feats, table, edge_src, edge_dst, edge_target, None,
        cfg, device, batch_size, mesh=mesh,
    )


def train_gat_ranker(
    node_feats: np.ndarray,
    table: NeighborTable,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_target: np.ndarray,          # log1p bandwidth per download edge
    query_edge_feats: Optional[np.ndarray] = None,
    *,
    model_config: Optional[GNNConfig] = None,
    config: Optional[TrainConfig] = None,
    device="cuda",
    batch_size: int = 4096,
    mesh: Optional[Mesh] = None,
) -> Tuple[TrainState, EvalMetrics, List[Dict[str, float]]]:
    """Train a ``GATRanker`` (initialized from ``config.seed``) on the
    download edges; → (state, validation metrics, history).  ``mesh``:
    data-parallel, the node table whole on every rank (module
    docstring)."""
    cfg = config or TrainConfig()
    mcfg = model_config or GNNConfig()
    gen = torch.Generator().manual_seed(cfg.seed)
    model = GATRanker(
        mcfg,
        num_nodes=int(node_feats.shape[0]),
        in_dim=int(node_feats.shape[1]),
        query_edge_dim=0 if query_edge_feats is None else int(query_edge_feats.shape[1]),
        generator=gen,
    )
    return _train_graph_model(
        model, node_feats, table, edge_src, edge_dst, edge_target,
        query_edge_feats, cfg, device, batch_size, mesh=mesh,
    )


def train_hop_ranker(
    node_feats: np.ndarray,
    table: NeighborTable,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_target: np.ndarray,          # log1p bandwidth per download edge
    query_edge_feats: Optional[np.ndarray] = None,
    *,
    model_config: Optional[HopConfig] = None,
    config: Optional[TrainConfig] = None,
    device="cuda",
    batch_size: int = 65_536,
    hop_feats=None,
    node_sharding: str = "replicated",
    mesh: Optional[Mesh] = None,
) -> Tuple[TrainState, EvalMetrics, List[Dict[str, float]]]:
    """Train the flagship ``HopRanker`` (models/hop.py; initialized from
    ``config.seed``): aggregation is precomputed once per snapshot, the
    train step is dense matrix work on edge batches.  Pass ``hop_feats``
    (numpy or a tensor) when the caller already precomputed them (the
    scorer export needs the same array — compute once, use twice); else
    they are computed once here, on ``device`` (the mesh's device).

    ``mesh``: data-parallel (module docstring).  ``node_sharding="model"``
    (with a mesh) partitions the hop features, the embedding table and
    its moments by node over the mesh's model axis — the config[4] scale
    mode where node tables exceed one device's memory; the precompute
    itself then runs node-sharded (one halo all-to-all per hop), and a
    ``hop_feats`` handed in is the whole table or the rank's block."""
    if node_sharding not in ("replicated", "model"):
        raise ValueError(f"unknown node_sharding {node_sharding!r}")
    num_nodes = int(table.indices.shape[0])
    if node_sharding == "model":
        if mesh is None:
            raise ValueError('node_sharding="model" needs a mesh')
        if num_nodes % mesh.shape[MODEL_AXIS]:
            raise ValueError(
                f"num_nodes {num_nodes} not divisible by the model axis "
                f"{mesh.shape[MODEL_AXIS]}"
            )
    cfg = config or TrainConfig()
    mcfg = model_config or HopConfig()
    dev = _build.resolve_device(device) if mesh is None else mesh.device
    if hop_feats is None:
        if node_sharding == "model":
            # The [N, F] hop table is the memory wall at config[4] scale,
            # so the precompute itself runs node-sharded and lands as the
            # rank's block.
            plan = build_halo_plan(table, mesh, axis=MODEL_AXIS)
            hop_feats = precompute_hop_features_sharded(
                mesh, node_feats, table, plan, hops=mcfg.hops, axis=MODEL_AXIS,
            )
        else:
            hop_feats = precompute_hop_features(
                torch.as_tensor(np.asarray(node_feats, np.float32)), table.to(dev),
                hops=mcfg.hops,
            )
    model = HopRanker(
        mcfg,
        num_nodes=num_nodes if node_sharding == "model" else int(hop_feats.shape[0]),
        in_dim=int(hop_feats.shape[1]),
        query_edge_dim=0 if query_edge_feats is None else int(query_edge_feats.shape[1]),
        generator=torch.Generator().manual_seed(cfg.seed),
    )
    return _train_graph_model(
        model, hop_feats, table, edge_src, edge_dst, edge_target,
        query_edge_feats, cfg, dev, batch_size, mesh=mesh, node_sharding=node_sharding,
    )


def _train_graph_model(
    model: nn.Module,
    node_feats: np.ndarray,
    table: NeighborTable,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_target: np.ndarray,
    query_edge_feats: Optional[np.ndarray],
    cfg: TrainConfig,
    device,
    batch_size: int,
    *,
    mesh: Optional[Mesh] = None,
    node_sharding: str = "replicated",
) -> Tuple[TrainState, EvalMetrics, List[Dict[str, float]]]:
    """Train ``model`` from its current parameters.  History entries add
    ``elapsed_s`` (seconds since the first step began, taken after the
    step's loss reached the host) to the JAX trainer's keys.  With
    ``node_sharding="model"`` (a ``HopRanker`` and a mesh) the model
    keeps its block of the node tables first, and ``node_feats`` is the
    whole hop table or the rank's block.  A model sharded already (e.g. to
    load flax's parameters into its blocks) keeps its shard."""
    dev = _build.resolve_device(device) if mesh is None else mesh.device
    val_idx, train_idx = split_edges(len(edge_src), cfg.seed)

    b0 = min(batch_size, max(len(train_idx), 2))
    axis_note = ""
    if mesh is not None:
        # The batch dim splits over the data axis — round down to a multiple.
        data_n = mesh.shape[DATA_AXIS]
        b0 = max((b0 // data_n) * data_n, data_n)
        axis_note = f" (data axis {data_n})"
    if len(train_idx) < b0:
        raise ValueError(f"no full batches: {len(train_idx)} train edges < batch {b0}{axis_note}")
    # Output-bias warm start at the training-split target mean (Huber's
    # linear tail otherwise spends the whole run closing the offset).
    warm_start_output_bias(model, float(edge_target[train_idx].mean()))
    nf = torch.as_tensor(node_feats, dtype=torch.float32)
    if node_sharding == "model":
        if model.node_shard is None:
            model.shard_nodes(NodeShard(mesh, MODEL_AXIS, model.num_nodes))
        shard = model.node_shard
        if nf.shape[0] == shard.num_nodes:
            nf = shard.block(nf)
    elif node_sharding != "replicated":
        raise ValueError(f"unknown node_sharding {node_sharding!r}")
    model.to(dev)
    nf = nf.to(dev)
    steps_per_epoch = max(len(train_idx) // b0, 1)
    state = TrainState(
        model=model,
        opt=_make_optimizer(list(model.parameters()), cfg, steps_per_epoch),
        generator=torch.Generator(device=dev).manual_seed(cfg.seed + 1),
    )
    if mesh is not None:
        sharded = [node_sharding == "model" and _is_node_table_path(name)
                   for name, _ in model.named_parameters()]
        state.opt.sync = _MeshSync(mesh, sharded)
    mine = _data_slice(mesh, b0)
    dev_table = table.to(dev)
    has_qef = query_edge_feats is not None

    def batch(idx: np.ndarray):
        args = [
            torch.from_numpy(np.asarray(edge_src[idx], np.int64)).to(dev),
            torch.from_numpy(np.asarray(edge_dst[idx], np.int64)).to(dev),
        ]
        qef = (
            torch.from_numpy(np.asarray(query_edge_feats[idx], np.float32)).to(dev)
            if has_qef else None
        )
        return args, qef

    history: List[Dict[str, float]] = []
    model.train()
    t0 = time.perf_counter()
    seen = 0
    for epoch in range(cfg.epochs):
        for idx in epoch_batches(train_idx, b0, cfg.seed, epoch):
            idx = idx[mine]
            (src, dst), qef = batch(idx)
            target = torch.from_numpy(np.asarray(edge_target[idx], np.float32)).to(dev)
            state, loss = _graph_train_step(state, nf, dev_table, src, dst, target, qef)
            seen += b0
            if state.step % cfg.log_every == 0:
                loss_v = float(loss)
                elapsed = time.perf_counter() - t0
                history.append(
                    {
                        "step": state.step,
                        "epoch": epoch,
                        "loss": loss_v,
                        "records_per_sec": seen / elapsed,
                        "elapsed_s": elapsed,
                    }
                )

    # Validation on the held-out edges.
    model.eval()
    (src, dst), qef = batch(val_idx)
    with torch.no_grad():
        pred = model(nf, dev_table, src, dst, qef).float().cpu().numpy()
    metrics = _regression_metrics(pred, edge_target[val_idx])
    state.val_idx, state.val_pred = val_idx, pred
    return state, metrics, history


# ---------------------------------------------------------------------------
# Checkpoints: ``torch.save`` of the parameters and the step
# ---------------------------------------------------------------------------


def full_params(state: TrainState) -> Dict[str, torch.Tensor]:
    """The state's parameters by flax path (``/``-joined), whole, on the
    CPU.  A node-sharded state's blocks are gathered over the model axis,
    so every rank of its mesh calls this."""
    shard = getattr(state.model, "node_shard", None)
    out = {}
    for name, p in state.model.named_parameters():
        p = p.detach()
        if shard is not None and _is_node_table_path(name):
            p = shard.gather(p)
        out[name.replace(".", "/")] = p.cpu()
    return out


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write the state's parameters (flax paths, ``/``-joined, node tables
    whole) and step to the file ``path``, atomically.  On a mesh every
    rank calls it, rank 0 writes, and no rank returns before the file is
    in place."""
    params = full_params(state)
    sync = state.opt.sync
    if sync is None or sync.mesh.rank == 0:
        tmp = path + ".tmp"
        torch.save({"params": params, "step": int(state.step)}, tmp)
        os.replace(tmp, path)
    if sync is not None:
        # No rank returns (and reads the file) before it is in place.
        pm.barrier(sync.mesh)


def restore_params(path: str) -> Dict:
    """The parameters of a checkpoint as a flax-shaped nested dict of
    numpy arrays (``models/gnn.load_flax_params`` takes it)."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    tree: Dict = {}
    for name, value in data["params"].items():
        *parts, leaf = name.split("/")
        node = tree
        for part in parts:
            node = node.setdefault(part, {})
        node[leaf] = value.numpy()
    return tree
