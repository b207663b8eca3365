"""Host-side input pipeline: columnar shards → batches.

Port of ``dragonfly2_tpu/trainer/ingest.py``, numpy logic verbatim, so
both packages cut the same batches in the same order.  The scheduler
already wrote fixed-width float32 rows (records/columnar.py); ingest is:

    np.memmap shards → permuted index stream → [B, W] slices

No parsing and no copies beyond the batch slice; every batch has the
same shape.  The trainer moves each batch to its device.  Multi-process
ingest (``multihost=True``: each process opens only its own shards,
``shard_for_process``) reads the rank and world size of the initialized
process group: a process is one device here, one host in the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..records.columnar import concat_readers
from ..records.features import DOWNLOAD_COLUMNS, DOWNLOAD_FEATURE_DIM


@dataclass
class EdgeBatches:
    """An epoch-iterable over download-record rows.

    Splits each row into (features [B, F], target [B], src [B], dst [B]).
    """

    rows: np.ndarray              # [N, W] in DOWNLOAD_COLUMNS layout
    batch_size: int
    shuffle: bool = True
    seed: int = 0
    drop_remainder: bool = True

    def __post_init__(self) -> None:
        if self.rows.shape[-1] != len(DOWNLOAD_COLUMNS):
            raise ValueError(
                f"row width {self.rows.shape[-1]} != {len(DOWNLOAD_COLUMNS)}"
            )

    def __len__(self) -> int:
        n = self.rows.shape[0] // self.batch_size
        if not self.drop_remainder and self.rows.shape[0] % self.batch_size:
            n += 1
        return n

    def epoch(self, epoch_idx: int = 0) -> Iterator[Tuple[np.ndarray, ...]]:
        n = self.rows.shape[0]
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch_idx)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        for start in range(0, n, self.batch_size):
            idx = order[start : start + self.batch_size]
            if len(idx) < self.batch_size:
                if self.drop_remainder:
                    return
                # Pad the tail batch by wrapping — keeps shapes static.
                idx = np.concatenate([idx, order[: self.batch_size - len(idx)]])
            yield split_columns(self.rows[idx])


def split_columns(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """[B, W] → (features [B, F], target [B], src_bucket [B], dst_bucket [B])."""
    src = rows[:, 0].astype(np.int32)
    dst = rows[:, 1].astype(np.int32)
    feats = rows[:, 2 : 2 + DOWNLOAD_FEATURE_DIM].astype(np.float32)
    target = rows[:, -1].astype(np.float32)
    return feats, target, src, dst


def shard_for_process(
    paths: Sequence[str],
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List[str]:
    """Round-robin shard assignment: each process opens only its files.
    The index and count default to the initialized process group's rank
    and world size (0 and 1 without one)."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if up else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if up else 1) if process_count is None else process_count
    return [p for i, p in enumerate(sorted(paths)) if i % pc == pi]


def load_download_dataset(
    paths: Sequence[str],
    *,
    batch_size: int = 8192,
    val_fraction: float = 0.1,
    seed: int = 0,
    multihost: bool = False,
) -> Tuple[EdgeBatches, EdgeBatches]:
    """Open shards → (train, val) batch streams with a stable split.
    ``multihost=True`` opens only this process's shards."""
    if multihost:
        paths = shard_for_process(paths)
    rows = concat_readers(list(paths))
    rng = np.random.default_rng(seed)
    order = rng.permutation(rows.shape[0])
    n_val = int(rows.shape[0] * val_fraction)
    val_rows = rows[order[:n_val]]
    train_rows = rows[order[n_val:]]
    train = EdgeBatches(train_rows, batch_size=batch_size, seed=seed)
    val = EdgeBatches(
        val_rows,
        batch_size=min(batch_size, max(len(val_rows), 1)),
        shuffle=False,
        drop_remainder=False,
    )
    return train, val
