"""Online streaming trainer: continuous ingest + checkpoint/resume.

Port of ``dragonfly2_tpu/trainer/streaming.py`` (BASELINE configs[4]/[5]):
the trainer keeps consuming scheduler record uploads while training, and
the lifecycle daemon (lifecycle/daemon.py) drives one per arm.

Design (as the reference):
- a bounded host-side queue of row batches (the ingest boundary);
- the train loop pulls fixed-size batches, normalizes with RUNNING
  statistics (Welford update; a stream has no fixed training split to
  standardize against), and takes one optimizer step;
- every ``checkpoint_every`` steps the full state checkpoints; ``resume()``
  restores it and the trainer continues bit-identically.

What the port changes: the model is the port's ``MLPRegressor`` on
``device`` and the optimizer the port's ``AdamW`` (optax's
``clip_by_global_norm(1.0)`` + ``adamw`` over
``warmup_cosine_decay_schedule(0.0, lr, warmup, decay)``); the step is
eager PyTorch (no dropout: the reference step applies the model without
``train=True``) and never reads its loss back (``last_loss`` keeps the
device tensor). A step's inputs go to the card in one copy from a pinned
staging buffer, without a host sync. Checkpoints are ``torch.save``
files (params, optimizer moments and count, step, records seen, the bias
flag, the moments and the drift-snapshot ring); the reference's orbax
checkpoints are not read. The seed initializes a ``torch.Generator``, so
a seed gives other initial weights than flax's.
"""

from __future__ import annotations

import os
import queue
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.mlp import MLPConfig, MLPRegressor, warm_start_output_bias
from ..ops import _build
from ..records.features import DOWNLOAD_FEATURE_DIM, mask_post_hoc
from .train import AdamW, _huber, warmup_cosine_decay_schedule


@dataclass
class StreamingConfig:
    batch_size: int = 4096
    checkpoint_every: int = 200       # steps
    queue_capacity: int = 64          # batches of backpressure
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    warmup_steps: int = 100
    decay_steps: int = 100_000
    seed: int = 0
    # Drift-baseline window: the most recent masked feature rows kept for
    # stamping train_bin_edges/train_bin_fracs into exported scorers
    # (trainer/export.feature_snapshot_stats).  A stream has no fixed
    # training split, so the baseline IS the trailing window the weights
    # were last fitted against.  0 disables stamping.
    snapshot_rows: int = 4096


class RunningMoments:
    """Welford running mean/variance over feature columns (stream-safe)."""

    def __init__(self, dim: int) -> None:
        self.count = 0.0
        self.mean = np.zeros(dim, np.float64)
        self.m2 = np.zeros(dim, np.float64)

    def update(self, batch: np.ndarray) -> None:
        n_b = batch.shape[0]
        if n_b == 0:
            return
        b_mean = batch.mean(axis=0)
        b_var = batch.var(axis=0)
        n_a = self.count
        n = n_a + n_b
        delta = b_mean - self.mean
        self.mean += delta * (n_b / n)
        self.m2 += b_var * n_b + (delta**2) * (n_a * n_b / n)
        self.count = n

    @property
    def std(self) -> np.ndarray:
        if self.count < 2:
            return np.ones_like(self.mean)
        s = np.sqrt(self.m2 / self.count)
        return np.where(s < 1e-3, 1.0, s)

    def to_arrays(self) -> Dict[str, np.ndarray]:
        return {
            "count": np.asarray([self.count]),
            "mean": self.mean.copy(),
            "m2": self.m2.copy(),
        }

    @classmethod
    def from_arrays(cls, data: Dict[str, np.ndarray]) -> "RunningMoments":
        rm = cls(len(data["mean"]))
        rm.count = float(np.asarray(data["count"]).reshape(-1)[0])
        rm.mean = np.asarray(data["mean"], np.float64).copy()
        rm.m2 = np.asarray(data["m2"], np.float64).copy()
        return rm


class StreamingTrainer:
    """MLP streaming trainer on ``device`` (``"cuda"`` unless the caller
    asks for the CPU; no CUDA device raises)."""

    def __init__(
        self,
        config: Optional[StreamingConfig] = None,
        model_config: Optional[MLPConfig] = None,
        *,
        checkpoint_dir: Optional[str] = None,
        device="cuda",
    ) -> None:
        self.config = config or StreamingConfig()
        self.model_config = model_config or MLPConfig()
        self.checkpoint_dir = checkpoint_dir
        self.device = _build.resolve_device(device)
        self._queue: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(
            maxsize=self.config.queue_capacity
        )
        self.moments = RunningMoments(self.model_config.in_dim)
        self.records_seen = 0
        self._leftover: Optional[np.ndarray] = None
        self._bias_initialized = False
        # Trailing-window feature ring for the exported drift baseline.
        self._snapshot: Optional[np.ndarray] = None
        self._snapshot_pos = 0
        self._snapshot_count = 0
        # The last step's loss, left on the device (never synced here).
        self.last_loss: Optional[torch.Tensor] = None
        # Pinned staging buffers and their copy events (the card only).
        self._staging: Optional[list] = None
        self._stage_turn = 0
        self._init_state()

    # -- state ---------------------------------------------------------------

    def _init_state(self) -> None:
        cfg = self.config
        gen = torch.Generator().manual_seed(cfg.seed)
        self.model = MLPRegressor(self.model_config, generator=gen).to(self.device)
        schedule = warmup_cosine_decay_schedule(
            0.0, cfg.learning_rate, cfg.warmup_steps, cfg.decay_steps
        )
        self.opt = AdamW(
            list(self.model.parameters()), schedule, weight_decay=cfg.weight_decay
        )
        self.step = 0

    def _train_step(self, feats, target, mean, std) -> torch.Tensor:
        feats = (feats - mean) / std
        loss = _huber(self.model(feats), target)
        grads = torch.autograd.grad(loss, self.opt.params)
        self.opt.update(list(grads))
        return loss.detach()

    def _stage(self, feats, target, mean, std) -> List[torch.Tensor]:
        """The step's four inputs → float32 tensors on the device, packed
        into one host buffer and moved in one copy.  On the card the
        buffer is pinned and the copy does not wait; two buffers take
        turns, and a buffer is rewritten only once its last copy is done."""
        parts = [np.asarray(a).reshape(-1) for a in (feats, target, mean, std)]
        size = sum(len(a) for a in parts)
        if self.device.type != "cuda":
            host = torch.empty(size, dtype=torch.float32)
        else:
            if self._staging is None or self._staging[0][0].numel() != size:
                self._staging = [
                    (torch.empty(size, dtype=torch.float32, pin_memory=True),
                     torch.cuda.Event())
                    for _ in range(2)
                ]
            host, copied = self._staging[self._stage_turn]
            self._stage_turn ^= 1
            copied.synchronize()
        buf, at = host.numpy(), 0
        for a in parts:
            buf[at:at + len(a)] = a
            at += len(a)
        if self.device.type == "cuda":
            dev = torch.empty(size, dtype=torch.float32, device=self.device)
            dev.copy_(host, non_blocking=True)
            copied.record()
        else:
            dev = host
        views, at = [], 0
        for a, shape in zip(parts, (feats.shape, target.shape, mean.shape, std.shape)):
            views.append(dev[at:at + len(a)].view(shape))
            at += len(a)
        return views

    # -- ingest --------------------------------------------------------------

    def feed(self, rows: np.ndarray, *, block: bool = True) -> bool:
        """Offer a [n, DOWNLOAD_COLUMNS] row batch; False if full (non-block)."""
        try:
            self._queue.put(np.asarray(rows, np.float32), block=block)
            return True
        except queue.Full:
            return False

    def end_of_stream(self) -> None:
        self._queue.put(None)

    # -- train loop ----------------------------------------------------------

    def _next_batch(self, timeout: Optional[float]) -> Optional[np.ndarray]:
        """Accumulate queued rows into one fixed-size batch (static shapes)."""
        bs = self.config.batch_size
        parts: List[np.ndarray] = []
        have = 0
        if self._leftover is not None:
            parts.append(self._leftover)
            have = len(self._leftover)
            self._leftover = None
        while have < bs:
            try:
                rows = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if rows is None:  # end of stream sentinel
                self._queue.put(None)  # re-post for other waiters
                break
            parts.append(rows)
            have += len(rows)
        if not parts:
            return None
        all_rows = np.concatenate(parts, axis=0)
        if len(all_rows) < bs:
            self._leftover = all_rows
            return None
        batch, self._leftover = all_rows[:bs], all_rows[bs:]
        if len(self._leftover) == 0:
            self._leftover = None
        return batch

    def run(self, *, max_steps: Optional[int] = None, idle_timeout: float = 1.0) -> int:
        """Consume the stream until end_of_stream (or idle) — returns steps run."""
        steps_run = 0
        while max_steps is None or steps_run < max_steps:
            batch = self._next_batch(timeout=idle_timeout)
            if batch is None:
                break
            feats = mask_post_hoc(batch[:, 2 : 2 + DOWNLOAD_FEATURE_DIM])
            target = batch[:, -1].astype(np.float32)
            if not self._bias_initialized:
                # First batch's target mean warm-starts the output bias
                # (models.mlp.warm_start_output_bias).
                warm_start_output_bias(self.model, float(target.mean()))
                self._bias_initialized = True
            self.moments.update(feats)
            self._note_features(feats)
            self.records_seen += len(batch)
            self.last_loss = self._train_step(
                *self._stage(feats, target, self.moments.mean, self.moments.std)
            )
            self.step += 1
            steps_run += 1
            if (
                self.checkpoint_dir
                and self.step % self.config.checkpoint_every == 0
            ):
                self.checkpoint()
        return steps_run

    # -- drift-baseline window ------------------------------------------------

    def _note_features(self, feats: np.ndarray) -> None:
        """Ring-append trained (masked) feature rows for the drift
        baseline.  Order inside the ring is irrelevant: the baseline is
        quantile histograms, a pure function of the row multiset."""
        cap = self.config.snapshot_rows
        if cap <= 0 or feats.shape[0] == 0:
            return
        if self._snapshot is None:
            self._snapshot = np.zeros((cap, feats.shape[1]), np.float32)
        n = len(feats)
        if n >= cap:
            self._snapshot[:] = feats[-cap:]
            self._snapshot_pos = 0
            self._snapshot_count = cap
            return
        pos = self._snapshot_pos
        end = pos + n
        if end <= cap:
            self._snapshot[pos:end] = feats
        else:
            k = cap - pos
            self._snapshot[pos:] = feats[:k]
            self._snapshot[: end - cap] = feats[k:]
        self._snapshot_pos = end % cap
        self._snapshot_count = min(cap, self._snapshot_count + n)

    def snapshot_feature_rows(self) -> Optional[np.ndarray]:
        """The trailing feature window (None before any training step)."""
        if self._snapshot is None or self._snapshot_count == 0:
            return None
        return self._snapshot[: self._snapshot_count]

    # -- checkpoint / resume --------------------------------------------------

    def _ckpt_path(self) -> str:
        return os.path.join(os.path.abspath(self.checkpoint_dir), "stream.pt")

    def checkpoint(self) -> None:
        snapshot = (
            self._snapshot
            if self._snapshot is not None
            else np.zeros(
                (max(self.config.snapshot_rows, 1), self.model_config.in_dim),
                np.float32,
            )
        )
        payload = {
            "params": {
                name: p.detach().cpu().clone()
                for name, p in self.model.named_parameters()
            },
            "opt_mu": [m.detach().cpu().clone() for m in self.opt.mu],
            "opt_nu": [v.detach().cpu().clone() for v in self.opt.nu],
            "opt_count": self.opt.count,
            "step": self.step,
            "records_seen": self.records_seen,
            "bias_initialized": self._bias_initialized,
            "moments": {
                k: torch.from_numpy(v) for k, v in self.moments.to_arrays().items()
            },
            # Drift window travels with the weights: a resumed trainer
            # exports the SAME baseline it would have exported pre-crash.
            "snapshot": torch.from_numpy(snapshot.copy()),
            "snapshot_pos": self._snapshot_pos,
            "snapshot_count": self._snapshot_count,
        }
        path = self._ckpt_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)  # a crash mid-save leaves the last checkpoint

    def resume(self) -> bool:
        """Restore the latest checkpoint; False if none exists."""
        path = self._ckpt_path()
        if not os.path.exists(path):
            return False
        restored = torch.load(path, map_location="cpu", weights_only=True)
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(restored["params"][name])
            for dst, src in zip(self.opt.mu, restored["opt_mu"]):
                dst.copy_(src)
            for dst, src in zip(self.opt.nu, restored["opt_nu"]):
                dst.copy_(src)
        self.opt.count = int(restored["opt_count"])
        self.step = int(restored["step"])
        self.records_seen = int(restored["records_seen"])
        self._bias_initialized = bool(restored["bias_initialized"])
        self.moments = RunningMoments.from_arrays(
            {k: v.numpy() for k, v in restored["moments"].items()}
        )
        self._snapshot_count = int(restored["snapshot_count"])
        self._snapshot_pos = int(restored["snapshot_pos"])
        self._snapshot = (
            restored["snapshot"].numpy().astype(np.float32, copy=True)
            if self._snapshot_count
            else None
        )
        return True

    # -- export --------------------------------------------------------------

    def export_scorer(self):
        from .export import export_mlp_scorer, feature_snapshot_stats

        scorer = export_mlp_scorer(
            self.model,
            feat_mean=self.moments.mean.astype(np.float32),
            feat_std=self.moments.std.astype(np.float32),
            post_hoc_masked=True,
        )
        # Stamp the drift baseline exactly like trainer/export's batch
        # path (export_from_state): without it a streaming-trained
        # candidate would sail past the rollout plane's PSI gate blind.
        rows = self.snapshot_feature_rows()
        if rows is not None and len(rows):
            edges, fracs = feature_snapshot_stats(rows)
            scorer.train_bin_edges = edges
            scorer.train_bin_fracs = fracs
        return scorer
