"""Online graph trainer: continuous two-stream ingest + mid-training
snapshot refresh (BASELINE configs[4] as the north star writes it:
continuous scheduler/storage ingest into the GNN).

Port of ``dragonfly2_tpu/trainer/online_graph.py``.  The reference's
Train stream feeds BOTH record types continuously — download rows and
network-topology rows (trainer/service/service_v1.go:128-143 demuxes
TrainMlpRequest / TrainGnnRequest on one stream).  Here the consumer is
the flagship hop ranker running ONLINE:

- **downloads stream** → fixed-shape edge dispatches ([super_steps,
  batch] src/dst/target), ``super_steps`` optimizer steps per dispatch;
- **topology stream** → a bounded most-recent window of probe edges;
  every ``refresh_every`` dispatches the window becomes a NEW graph
  snapshot: ``build_neighbor_table`` + ``precompute_hop_features`` re-run
  mid-training and the hop tables swap **without touching the
  optimizer** (params, AdamW moments, LR schedule position, dropout
  generator all continue — the learnable node embedding persists across
  snapshots because node identity does).

What the port changes:
- a dispatch is a plain loop of ``super_steps`` calls of
  ``train._graph_train_step`` (the reference scans them in one jitted
  program); its block goes to the device in one copy from a pinned
  staging buffer, and its mean loss stays on the device
  (``last_loss``);
- the embedding's backward adds repeated ids in a fixed order
  (``models/hop._RowGather``), so a resumed run is bit-identical on the
  card, as the reference's is on the TPU;
- the wire adapter runs its Python path only: ``native_ingest=True``
  raises (the C++ engine is ROADMAP item 14);
- on a mesh (``parallel.mesh.create_mesh``; one process per device, every
  rank constructing the trainer and calling ``run``, ``eval_mae``,
  ``refresh_snapshot``, ``apply_pending_recycles``, ``checkpoint``,
  ``resume`` and ``state_hash`` together) rank 0 is the one feeder, as the
  JAX trainer is fed in one process: it owns ingest (the queues, the
  topology window, the wire adapter) and the refresh decision, and before
  each dispatch it broadcasts the ``[super_steps, batch]`` block and the
  recycled ids, and on every snapshot build the window and the node
  features.  Each rank trains on its data coordinate's batch columns.
  With ``node_sharding="model"`` the snapshot precompute runs node-sharded
  (one halo all-to-all per hop) and the hop table, the embedding and its
  moments live as node blocks over the model axis; with ``"replicated"``
  each rank holds them whole (the reference's ``replicated`` and
  ``batch_sharding`` placements have no counterpart: a rank slices its
  columns and holds whole copies).  The checkpoint is the same one file, the
  node tables gathered whole and written by rank 0; ``resume`` has each
  rank read it and keep its block, so a mesh checkpoint resumes on one
  device and the reverse;
- no ``trainer.dispatch`` fault seam and no ``trainer/dispatch`` span
  (item 10);
- the checkpoint is one ``torch.save`` file: params, AdamW moments and
  count, step, the dropout generator's state, the stream position, the
  topology window, the pending probe buffer, the node features and the
  adapter's id mapping.  The graph snapshot is derived state, rebuilt at
  restore (``build_neighbor_table`` seeds its sampler), so a resume lands
  on the identical hop tables even when the kill fell between two
  refreshes.

Threads: the adapter runs on the ingest (wire) thread and touches numpy
only; every device operation — dispatches, snapshot builds, recycled-row
resets — runs on the training thread.
"""

from __future__ import annotations

import hashlib
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.gnn import NeighborTable, build_neighbor_table
from ..models.hop import HopConfig, HopRanker, hop_feature_dim, precompute_hop_features
from ..ops import _build
from ..parallel import mesh as pm
from ..parallel.graph_sharding import NodeShard, build_halo_plan, precompute_hop_features_sharded
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from .train import (
    TrainConfig,
    TrainState,
    _data_slice,
    _graph_train_step,
    _is_node_table_path,
    _make_optimizer,
    _MeshSync,
)

logger = logging.getLogger(__name__)

_NATIVE_REFUSAL = (
    "native_ingest=True needs the port's copy of the native oi_* ingest "
    "engine, which waits for ROADMAP queue 1 item 14; use native_ingest=False"
)


def _leaves(state: TrainState):
    """(flax path, parameter, AdamW first moment, second moment) in flax
    path order (sorted ``/``-joined names, as ``jax.tree_util`` orders a
    param dict)."""
    opt = state.opt
    rows = [
        (name.replace(".", "/"), p, opt.mu[i], opt.nu[i])
        for i, (name, p) in enumerate(state.model.named_parameters())
    ]
    return sorted(rows, key=lambda r: r[0])


def _whole_leaves(state: TrainState):
    """``_leaves`` with every node-sharded table gathered whole over its
    axis (a collective: every rank of the mesh calls it)."""
    shard = state.model.node_shard
    if shard is None:
        return _leaves(state)
    out = []
    for name, p, mu, nu in _leaves(state):
        if _is_node_table_path(name):
            p, mu, nu = (shard.gather(t.detach()) for t in (p, mu, nu))
        out.append((name, p, mu, nu))
    return out


def state_hash(state: TrainState) -> str:
    """sha256 over the parameters, then the AdamW first and second
    moments, then the update count and step — THE byte-identity
    fingerprint the resume checks compare (one definition, so
    'identical' always means the same thing).  Node tables count whole:
    on a node-sharded mesh every rank calls it and gets the one hash."""
    h = hashlib.sha256()
    leaves = _whole_leaves(state)
    for col in (1, 2, 3):
        for row in leaves:
            h.update(row[col].detach().cpu().numpy().tobytes())
    h.update(np.asarray([state.opt.count, state.step], np.int64).tobytes())
    return h.hexdigest()


class WireIngestAdapter:
    """Routes the ``Train`` stream's DECODED rows into an
    ``OnlineGraphTrainer`` — the reference's continuous two-stream feed
    (service_v1.go:128-143) closed end to end over the wire:
    ``TrainerService(online_sink=this)`` + ``StreamingRowDecoder``.

    Row endpoints arrive as HASH BUCKETS (records/features.py); the
    adapter assigns dense node ids on first sight (capped at the
    trainer's ``num_nodes`` — overflow edges are counted and dropped,
    with a WARNING on first overflow, never silently remapped), keeps
    per-node host-feature sums from the download payloads (the
    node-feature stream), and hands the trainer a LAZY feature source —
    the running mean is materialized once per snapshot build, not per
    wire chunk.

    **Node-id lifecycle** (``OnlineGraphConfig.node_ttl > 0``): a host
    unseen on either stream for ``node_ttl`` seconds is evicted when
    capacity is needed (the scheduler's host TTL GC, reference
    scheduler/config/config.go:176-197): its dense id returns to a free
    pool, its feature accumulators reset, and the trainer queues an
    embedding + optimizer-moment row reset (applied on the training
    thread — ``OnlineGraphTrainer.apply_pending_recycles``).  Drops while
    the table is full and nothing has expired are TRANSIENT.  Lifecycle
    mode is wall-clock-driven and trades strict byte-identity replay for
    capacity recycling; ``node_ttl=0`` (the default) keeps the fixed
    first-come mapping exactly.

    The reference's native fast path (its C++ ``oi_*`` engine) is not
    ported: ``use_native=True`` raises (ROADMAP item 14).
    """

    def __init__(
        self, trainer: "OnlineGraphTrainer", *, use_native: Optional[bool] = None
    ) -> None:
        from ..records.features import HOST_FEATURE_DIM, NUM_HASH_BUCKETS

        if use_native is None:
            use_native = trainer.config.native_ingest
        if use_native:
            raise NotImplementedError(_NATIVE_REFUSAL)
        self.trainer = trainer
        n = trainer.config.num_nodes
        # Vectorized bucket → dense-id table (the ingest hot path must
        # sustain wire rate): -2 = unseen, -1 = overflow.
        self._id_table = np.full(NUM_HASH_BUCKETS, -2, np.int32)
        self._next_id = 0
        self._feat_sum = np.zeros((n, HOST_FEATURE_DIM), np.float32)
        self._feat_cnt = np.zeros(n, np.float32)
        self._py_overflow = 0
        self._py_evicted = 0
        self._warned_full = False
        # Lifecycle state: last time each dense id was seen on any
        # stream, its current bucket (for reverse unmapping), and the
        # free pool of recycled ids.
        self._last_seen = np.zeros(n, np.float64)
        self._bucket_of = np.full(n, -1, np.int64)
        self._free: List[int] = []
        self._last_evict_scan = float("-inf")
        # EPOCH time, not monotonic: last-seen stamps live in the
        # checkpoint and must stay comparable across process restarts.
        self.clock = time.time  # injectable for deterministic tests
        self._mu = threading.Lock()
        trainer.node_feature_source = self.node_features
        trainer._adapter = self
        if trainer._adapter_restore is not None:
            self._apply_restore(trainer._adapter_restore)

    @property
    def overflow_edges(self) -> int:
        return self._py_overflow

    @property
    def evicted_nodes(self) -> int:
        return self._py_evicted

    def _apply_restore(self, st: dict) -> None:
        """Re-attach a checkpointed id mapping: the mapping is NOT
        derivable from the stream in ttl mode (eviction is clock-driven),
        so it rides in the trainer checkpoint — host X keeps the dense id
        whose embedding learned X."""
        n = self.trainer.config.num_nodes
        if len(st["adapter_bucket_of"]) != n:
            raise ValueError(
                f"checkpoint adapter state is for num_nodes="
                f"{len(st['adapter_bucket_of'])}, trainer has {n}"
            )
        free = [int(i) for i in st["adapter_free"] if i >= 0]
        with self._mu:
            self._id_table = np.asarray(st["adapter_id_table"], np.int32).copy()
            self._bucket_of = np.asarray(st["adapter_bucket_of"], np.int64).copy()
            self._last_seen = np.asarray(st["adapter_last_seen"], np.float64).copy()
            self._free = free
            self._next_id = int(st["adapter_next_id"])
            self._feat_sum = np.asarray(st["adapter_feat_sum"], np.float32).copy()
            self._feat_cnt = np.asarray(st["adapter_feat_cnt"], np.float32).copy()
            self._py_overflow = int(st["adapter_overflow_edges"])
            self._py_evicted = int(st["adapter_evicted_nodes"])
            self._last_evict_scan = float("-inf")

    def snapshot_for_checkpoint(self) -> dict:
        """A consistent (mapping, applied-row-resets) pair for the
        trainer checkpoint: applies pending recycles, then snapshots the
        mapping, retrying if an eviction raced in between — a saved
        mapping must never outrun its embedding resets."""
        while True:
            self.trainer.apply_pending_recycles()
            with self._mu:
                with self.trainer._recycle_lock:
                    if self.trainer._pending_recycle:
                        continue
                return self._mapping_state()

    def snapshot_with_pending(self):
        """(mapping, the recycled ids queued up to it), taken together:
        the mesh checkpoint resets those rows on every rank before it
        saves, so the saved mapping never outruns its resets."""
        with self._mu:
            return self._mapping_state(), self.trainer._take_pending()

    def _mapping_state(self) -> dict:
        """The id mapping (callers hold ``_mu``)."""
        return {
            "adapter_id_table": self._id_table.copy(),
            "adapter_bucket_of": self._bucket_of.copy(),
            "adapter_last_seen": self._last_seen.copy(),
            "adapter_free": np.concatenate(
                [np.asarray(self._free, np.int64), [-1]]
            ),
            "adapter_next_id": int(self._next_id),
            "adapter_feat_sum": self._feat_sum.copy(),
            "adapter_feat_cnt": self._feat_cnt.copy(),
            "adapter_overflow_edges": int(self._py_overflow),
            "adapter_evicted_nodes": int(self._py_evicted),
        }

    def _evict_expired(self, now: float) -> int:
        """Reclaim dense ids whose hosts fell silent for ``node_ttl``
        (the scheduler's host GC semantics).  Called under ``_mu`` from
        the mapping slow path when the table is full; the O(num_nodes)
        scan is throttled to once per ttl/4."""
        ttl = float(self.trainer.config.node_ttl)
        if ttl <= 0 or now - self._last_evict_scan < ttl * 0.25:
            return 0
        self._last_evict_scan = now
        active = self._bucket_of >= 0
        expired = np.nonzero(active & (now - self._last_seen > ttl))[0]
        if len(expired) == 0:
            return 0
        self._id_table[self._bucket_of[expired]] = -2
        self._bucket_of[expired] = -1
        self._feat_sum[expired] = 0.0
        self._feat_cnt[expired] = 0.0
        self._free.extend(int(i) for i in expired)
        self._py_evicted += len(expired)
        # Un-memoize overflow buckets: freed capacity means previously
        # dropped hosts may claim ids on their next appearance.
        self._id_table[self._id_table == -1] = -2
        self.trainer.request_recycle(expired)
        from .metrics import ONLINE_NODES_EVICTED

        ONLINE_NODES_EVICTED.inc(len(expired))
        logger.info(
            "node lifecycle: evicted %d expired hosts (ttl=%.0fs), "
            "%d ids free", len(expired), ttl, len(self._free),
        )
        return len(expired)

    def _map_ids(self, buckets: np.ndarray, now: float) -> np.ndarray:
        """bucket → dense id; -1 for overflow (node table full).  One
        vectorized gather in steady state; Python only touches buckets
        never seen before (or, in ttl mode, previously dropped)."""
        b = buckets.astype(np.int64)
        out = self._id_table[b]
        ttl_mode = self.trainer.config.node_ttl > 0
        if ttl_mode:
            # Touch BEFORE any eviction: a host present in this very
            # chunk is alive by definition and must not be reclaimed by
            # the scan below, however long it was silent before.
            seen = out[out >= 0]
            if len(seen):
                self._last_seen[seen] = now
        # ttl mode also retries -1 (dropped) buckets: expired capacity
        # may have freed up since — drops must stay transient even when
        # no brand-new bucket arrives to trigger the slow path.
        if (out == -2).any() or (ttl_mode and (out == -1).any()):
            cap = self.trainer.config.num_nodes
            if not self._free and self._next_id >= cap:
                if self._evict_expired(now):
                    # Eviction un-memoized -1 buckets; re-gather so this
                    # chunk's dropped hosts remap right now.
                    out = self._id_table[b]
            for nb in np.unique(b[out == -2]):
                if self._id_table[nb] != -2:
                    continue
                if not self._free and self._next_id >= cap:
                    # The pre-loop attempt only fires when the pool was
                    # ALREADY empty; a small leftover pool can drain
                    # mid-chunk with expired ids still reclaimable (the
                    # scan throttle keeps repeat calls cheap).
                    self._evict_expired(now)
                if self._free:
                    nid = self._free.pop()
                elif self._next_id < cap:
                    nid = self._next_id
                    self._next_id += 1
                else:
                    self._id_table[nb] = -1
                    continue
                self._id_table[nb] = nid
                self._bucket_of[nid] = nb
                self._last_seen[nid] = now
            out = self._id_table[b]
        return out

    def map_known(self, buckets: np.ndarray) -> np.ndarray:
        """bucket → dense id for hosts already mapped (-1 / -2 for the
        rest); assigns nothing and touches no lifecycle stamp (evaluation
        rows)."""
        with self._mu:
            return self._id_table[np.asarray(buckets).astype(np.int64)]

    def _warn_table_full_once(self) -> None:
        """One warning per adapter lifetime (callers hold _mu)."""
        if self._warned_full:
            return
        self._warned_full = True
        logger.warning(
            "node table full (num_nodes=%d): dropping edges touching "
            "unmapped hosts%s", self.trainer.config.num_nodes,
            "" if self.trainer.config.node_ttl > 0
            else " (node_ttl=0: drops are permanent)",
        )

    def _count_overflow(self, n_dropped: int) -> None:
        if n_dropped <= 0:
            return
        self._warn_table_full_once()
        self._py_overflow += n_dropped
        from .metrics import ONLINE_OVERFLOW_EDGES

        ONLINE_OVERFLOW_EDGES.inc(n_dropped)

    def node_features(self) -> np.ndarray:
        """Materialize the running per-node feature means — called by the
        trainer ONCE per snapshot build (lazy; never per chunk)."""
        with self._mu:
            return self._feat_sum / np.maximum(self._feat_cnt[:, None], 1.0)

    # Feature-mean accumulation samples at most this many rows per feed:
    # the means converge long before every row has voted.  Edges (the
    # training signal) are NEVER sampled.
    FEATURE_SAMPLE_ROWS = 262_144

    def feed_download_rows(self, rows: np.ndarray) -> None:
        if rows.size == 0:
            return
        now = self.clock()
        with self._mu:
            # ONE mapping call over both endpoint columns: every host in
            # the chunk is touched before any eviction runs, so a live
            # dst can never be reclaimed by the src column's slow path.
            both = self._map_ids(
                np.concatenate([rows[:, 0], rows[:, 1]]), now
            )
            src, dst = both[: len(rows)], both[len(rows):]
            ok = (src >= 0) & (dst >= 0)
            n_bad = int(len(ok) - np.count_nonzero(ok))
            self._count_overflow(n_bad)
            if n_bad:
                src, dst = src[ok], dst[ok]
                kept = rows[ok]
            else:
                kept = rows  # fast path: no boolean-mask copy
            # Node-feature stream: ONE shared accumulator with the batch
            # trainer (records.features.accumulate_host_feature_sums) so
            # the parent/child attribution cannot drift between paths.
            from ..records.features import accumulate_host_feature_sums

            m = min(len(kept), self.FEATURE_SAMPLE_ROWS)
            accumulate_host_feature_sums(
                kept[:m], src[:m], dst[:m], self._feat_sum, self._feat_cnt
            )
        if len(src):
            self.trainer.feed_downloads(
                src, dst, kept[:, -1].astype(np.float32)
            )

    def feed_topology_rows(self, rows: np.ndarray) -> None:
        if rows.size == 0:
            return
        now = self.clock()
        with self._mu:
            both = self._map_ids(np.concatenate([rows[:, 0], rows[:, 1]]), now)
            src, dst = both[: len(rows)], both[len(rows):]
            ok = (src >= 0) & (dst >= 0)
            self._count_overflow(int((~ok).sum()))
            src, dst = src[ok], dst[ok]
            rtt = rows[ok, 2].astype(np.float32)
        if len(src):
            self.trainer.feed_topology(src, dst, rtt)


@dataclass
class OnlineGraphConfig:
    num_nodes: int
    max_neighbors: int = 16
    batch_size: int = 131_072
    super_steps: int = 64            # train steps per dispatch
    refresh_every: int = 0           # dispatches between snapshot swaps (0 = static)
    topo_window: int = 1_000_000     # most-recent probe edges kept for the next snapshot
    checkpoint_every: int = 0        # dispatches (0 = off)
    # Node-id lifecycle for the wire adapter: hosts unseen for this many
    # seconds are evicted when the table is full and their dense ids
    # recycled (embedding + moment rows reset).  0 = off: the mapping is
    # frozen first-come and overflow drops are permanent (the strictly
    # deterministic mode the resume checks use).
    node_ttl: float = 0.0
    queue_capacity: int = 2          # dispatch blocks of ingest backpressure
    model: HopConfig = field(default_factory=HopConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    total_steps_hint: int = 100_000  # LR schedule horizon
    # The C++ wire-ingest engine is not ported (ROADMAP item 14): True
    # raises instead of falling back.
    native_ingest: bool = False
    # A (data, model) mesh from parallel.mesh.create_mesh (None = one
    # device): batches split over the data axis; node_sharding="model"
    # partitions the hop table, the embedding (+ its moments) and the
    # snapshot precompute by node over the model axis.
    mesh: Optional[Mesh] = None
    node_sharding: str = "replicated"


class OnlineGraphTrainer:
    """The configs[4] online consumer on ``device`` (``"cuda"`` unless the
    caller asks for the CPU; no CUDA device raises): see module
    docstring."""

    def __init__(
        self,
        config: OnlineGraphConfig,
        *,
        node_feats: np.ndarray,
        topo_src: np.ndarray,
        topo_dst: np.ndarray,
        topo_rtt: np.ndarray,
        checkpoint_dir: Optional[str] = None,
        device="cuda",
    ) -> None:
        """``node_feats`` + the initial probe edges bootstrap snapshot 0 —
        an online trainer still needs one graph to start ranking on.  On
        a mesh every rank constructs it (on the mesh's device)."""
        if config.node_sharding not in ("replicated", "model"):
            raise ValueError(f"unknown node_sharding {config.node_sharding!r}")
        mesh = config.mesh
        if config.node_sharding == "model" and mesh is None:
            raise ValueError('node_sharding="model" needs a mesh')
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise ValueError(
                    f"mesh must come from parallel.mesh.create_mesh, not "
                    f"{type(mesh).__name__}"
                )
            if config.node_sharding == "model" and config.num_nodes % mesh.shape[MODEL_AXIS]:
                raise ValueError(
                    f"num_nodes {config.num_nodes} not divisible by the "
                    f"model axis {mesh.shape[MODEL_AXIS]}"
                )
            if config.batch_size % mesh.shape[DATA_AXIS]:
                raise ValueError(
                    f"batch_size {config.batch_size} not divisible by the "
                    f"data axis {mesh.shape[DATA_AXIS]}"
                )
        if config.native_ingest:
            raise NotImplementedError(_NATIVE_REFUSAL)
        self.config = config
        self.checkpoint_dir = checkpoint_dir
        self.mesh = mesh
        self.device = _build.resolve_device(device) if mesh is None else mesh.device
        # Rank 0 feeds a mesh; one device feeds itself.
        self._feeder = mesh is None or mesh.rank == 0

        self._topo_lock = threading.Lock()
        self._topo_parts: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._topo_count = 0
        self._fed_since_swap = 0
        self.node_feats = np.asarray(node_feats, np.float32)
        # Optional lazy provider (the wire adapter sets it): consulted at
        # each snapshot build INSTEAD of the last set_node_features value.
        self.node_feature_source = None
        self.feed_topology(topo_src, topo_dst, topo_rtt)

        self._downloads: "queue.Queue" = queue.Queue(maxsize=config.queue_capacity)
        self._leftover: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None

        self.dispatch = 0
        self.snapshot_idx = 0
        self.records_seen = 0
        # The last dispatch's mean loss, left on the device.
        self.last_loss: Optional[torch.Tensor] = None
        # (table build s, hop precompute s) of the last snapshot build.
        self.snapshot_seconds: Tuple[float, float] = (0.0, 0.0)
        # Recycled ids queued by the (ingest-thread) wire adapter; the
        # row resets run on the TRAINING thread between dispatches.
        self._recycle_lock = threading.Lock()
        self._pending_recycle: List[np.ndarray] = []
        self.nodes_recycled = 0
        # Attached wire adapter (if any) — its id mapping checkpoints
        # with the trainer; resume() stashes the restored copy here for
        # the next make_wire_adapter() to re-attach.
        self._adapter: Optional[WireIngestAdapter] = None
        self._adapter_restore: Optional[dict] = None
        self._window: Tuple[np.ndarray, np.ndarray, np.ndarray] = self._drain_window()
        self._fed_since_swap = 0  # bootstrap topology = snapshot 0's input
        # Snapshot 0 builds LAZILY (_ensure_snapshot) — a resume() right
        # after the constructor replaces the window anyway.
        self.table: Optional[NeighborTable] = None
        self.hop_feats: Optional[torch.Tensor] = None
        # Pinned staging buffers and their copy events (the card only).
        self._staging: Optional[list] = None
        self._stage_turn = 0

        # -- model / optimizer (created ONCE; survive every swap) -----------
        hop_dim = hop_feature_dim(self.node_feats.shape[1], config.model.hops)
        model = HopRanker(
            config.model, num_nodes=config.num_nodes, in_dim=hop_dim,
            generator=torch.Generator().manual_seed(config.train.seed),
        )
        if config.node_sharding == "model":
            model.shard_nodes(NodeShard(mesh, MODEL_AXIS, config.num_nodes))
        model.to(self.device)
        self.state = TrainState(
            model=model,
            opt=_make_optimizer(
                list(model.parameters()), config.train,
                config.total_steps_hint // max(config.train.epochs, 1),
            ),
            generator=torch.Generator(device=self.device).manual_seed(
                config.train.seed + 1
            ),
        )
        if mesh is not None:
            sharded = [config.node_sharding == "model" and _is_node_table_path(name)
                       for name, _ in model.named_parameters()]
            self.state.opt.sync = _MeshSync(mesh, sharded)
        # This rank's columns of a dispatch block.
        self._mine = _data_slice(mesh, config.batch_size)

    # -- ingest: downloads stream -------------------------------------------

    def feed_downloads(
        self, src: np.ndarray, dst: np.ndarray, target: np.ndarray,
        *, block: bool = True,
    ) -> bool:
        """Offer download edges (flat arrays; any length).  Blocks when the
        queue is full — ingest backpressure, like the wire handler."""
        try:
            self._downloads.put(
                (
                    np.asarray(src, np.int32),
                    np.asarray(dst, np.int32),
                    np.asarray(target, np.float32),
                ),
                block=block,
            )
            return True
        except queue.Full:
            return False

    def end_of_stream(self) -> None:
        self._downloads.put(None)

    def _next_dispatch_block(self, timeout: Optional[float]):
        """Accumulate queued edges into one [super_steps, batch] block
        (static shapes)."""
        need = self.config.super_steps * self.config.batch_size
        parts: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        have = 0
        if self._leftover is not None:
            parts.append(self._leftover)
            have = len(self._leftover[0])
            self._leftover = None
        while have < need:
            try:
                item = self._downloads.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:
                self._downloads.put(None)  # re-post for other waiters
                break
            parts.append(item)
            have += len(item[0])
        if not parts:
            return None
        es = np.concatenate([p[0] for p in parts])
        ed = np.concatenate([p[1] for p in parts])
        y = np.concatenate([p[2] for p in parts])
        if len(es) < need:
            self._leftover = (es, ed, y)
            return None
        self._leftover = (
            (es[need:], ed[need:], y[need:]) if len(es) > need else None
        )
        shape = (self.config.super_steps, self.config.batch_size)
        return (
            es[:need].reshape(shape), ed[:need].reshape(shape),
            y[:need].reshape(shape),
        )

    # -- ingest: topology stream --------------------------------------------

    def feed_topology(
        self, src: np.ndarray, dst: np.ndarray, rtt: np.ndarray
    ) -> None:
        """Offer probe edges (prober → probed, rtt in seconds-scale units —
        whatever build_neighbor_table should see as the edge feature).
        Only the most recent ``topo_window`` edges count toward the next
        snapshot."""
        part = (
            np.asarray(src, np.int32),
            np.asarray(dst, np.int32),
            np.asarray(rtt, np.float32),
        )
        with self._topo_lock:
            self._topo_parts.append(part)
            self._topo_count += len(part[0])
            self._fed_since_swap += len(part[0])
            # Trim whole parts from the front while the window still holds.
            while (
                self._topo_count - len(self._topo_parts[0][0])
                >= self.config.topo_window
            ):
                dropped = self._topo_parts.pop(0)
                self._topo_count -= len(dropped[0])

    def set_node_features(self, node_feats: np.ndarray) -> None:
        """Refresh the host feature matrix (host-record stream analog);
        picked up at the next snapshot build."""
        self.node_feats = np.asarray(node_feats, np.float32)

    def _drain_window(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        with self._topo_lock:
            parts = list(self._topo_parts)
        if not parts:
            return (
                np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32),
            )
        src = np.concatenate([p[0] for p in parts])[-self.config.topo_window:]
        dst = np.concatenate([p[1] for p in parts])[-self.config.topo_window:]
        rtt = np.concatenate([p[2] for p in parts])[-self.config.topo_window:]
        return src, dst, rtt

    # -- snapshot refresh ----------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _build_snapshot(self, *, use_source: bool = True) -> None:
        """window + node_feats → neighbor table + hop features (device).
        ``use_source=False`` builds from the CURRENT node_feats — the
        resume path restored them from the checkpoint and a fresh
        adapter's (empty) means must not clobber them."""
        if use_source and self.node_feature_source is not None:
            self.node_feats = np.asarray(
                self.node_feature_source(), np.float32
            )
        if self.mesh is not None:
            # Rank 0's window and node features on every rank.
            nf, *window = pm.broadcast_arrays(
                self.mesh, [self.node_feats, *self._window], 4)
            self.node_feats, self._window = nf.copy(), tuple(a.copy() for a in window)
        src, dst, rtt = self._window
        t0 = time.perf_counter()
        table = build_neighbor_table(
            self.config.num_nodes, src, dst, rtt,
            max_neighbors=self.config.max_neighbors,
        )
        self.table = table.to(self.device)
        self._sync()
        t1 = time.perf_counter()
        if self.config.node_sharding == "model":
            # The precompute itself runs node-sharded (halo exchange per
            # hop): no rank materializes the [N, F] hop table whole.
            plan = build_halo_plan(table, self.mesh, axis=MODEL_AXIS)
            self.hop_feats = precompute_hop_features_sharded(
                self.mesh, self.node_feats, table, plan,
                hops=self.config.model.hops, axis=MODEL_AXIS,
            )
        else:
            self.hop_feats = precompute_hop_features(
                torch.from_numpy(self.node_feats), self.table,
                hops=self.config.model.hops,
            )
        self._sync()
        self.snapshot_seconds = (t1 - t0, time.perf_counter() - t1)

    def refresh_snapshot(self) -> Optional[str]:
        """Swap in a snapshot built from the current topology window.
        Returns the new hop-table digest, or None if no topology arrived
        since the last swap (keep serving the old graph rather than pay
        a rebuild for an identical one).  The optimizer, params, LR
        position and dropout generator are untouched.  On a mesh rank 0
        decides, and the window it drained is the one every rank builds."""
        with self._topo_lock:
            fed = self._fed_since_swap
        window = self._drain_window()
        go = fed > 0 and len(window[0]) > 0
        if self.mesh is not None:
            (flag,) = pm.broadcast_arrays(self.mesh, [np.asarray([go], np.int32)], 1)
            go = bool(flag[0])
        if not go:
            logger.info("snapshot refresh skipped: no new topology")
            return None
        t0 = time.perf_counter()
        self._window = window
        with self._topo_lock:
            self._fed_since_swap = 0
        self._build_snapshot()
        self.snapshot_idx += 1
        digest = self.snapshot_digest()
        logger.info(
            "snapshot %d: %d probe edges, hop digest %s (%.2fs)",
            self.snapshot_idx, len(window[0]), digest[:12],
            time.perf_counter() - t0,
        )
        return digest

    def _ensure_snapshot(self) -> None:
        """Build snapshot 0 on first use (the constructor defers it so a
        resume() doesn't pay for a build it immediately replaces)."""
        if self.hop_feats is None:
            self._build_snapshot()

    def snapshot_digest(self) -> str:
        """sha256 of the whole hop table (gathered on a node-sharded mesh,
        where every rank calls it)."""
        self._ensure_snapshot()
        hop = self.hop_feats
        if self.state.model.node_shard is not None:
            hop = self.state.model.node_shard.gather(hop)
        return hashlib.sha256(hop.cpu().numpy().tobytes()).hexdigest()

    # -- node-id lifecycle ---------------------------------------------------

    def request_recycle(self, node_ids: np.ndarray) -> None:
        """Queue recycled dense ids for an embedding/optimizer row reset.
        Thread-safe; the reset itself runs between dispatches on the
        training thread (``apply_pending_recycles``)."""
        ids = np.asarray(node_ids, np.int32)
        if ids.size:
            with self._recycle_lock:
                self._pending_recycle.append(ids)

    def _take_pending(self) -> np.ndarray:
        """The queued recycled ids (distinct, sorted), the queue emptied."""
        with self._recycle_lock:
            if not self._pending_recycle:
                return np.zeros(0, np.int32)
            ids = np.unique(np.concatenate(self._pending_recycle))
            self._pending_recycle = []
        return ids.astype(np.int32)

    def _share_ids(self, ids: np.ndarray) -> np.ndarray:
        """Rank 0's ids on every rank of a mesh."""
        if self.mesh is None:
            return ids
        return pm.broadcast_arrays(self.mesh, [ids], 1)[0]

    def apply_pending_recycles(self) -> int:
        """Zero the learnable embedding rows AND their AdamW moments for
        every id queued by ``request_recycle`` — a recycled id is a NEW
        host and must not inherit its predecessor's learned state.
        Returns the number of distinct rows reset.  On a mesh, rank 0's
        queue, reset on every rank."""
        return self._reset_rows(self._share_ids(self._take_pending()))

    def _reset_rows(self, ids: np.ndarray) -> int:
        if len(ids) == 0:
            return 0
        mask = np.zeros(self.config.num_nodes, bool)
        mask[ids] = True
        self._recycle_rows(torch.from_numpy(mask).to(self.device))
        self.nodes_recycled += int(len(ids))
        from .metrics import ONLINE_NODES_RECYCLED

        ONLINE_NODES_RECYCLED.inc(len(ids))
        return int(len(ids))

    @torch.no_grad()
    def _recycle_rows(self, mask: torch.Tensor) -> None:
        """[N]-mask row reset of every node-table leaf (parameter and
        moments alike) — the one path predicate
        ``train._is_node_table_path``; a node-sharded leaf takes its
        block of the mask."""
        shard = self.state.model.node_shard
        if shard is not None:
            mask, n = shard.block(mask), shard.rows
        else:
            n = self.config.num_nodes
        for name, p, mu, nu in _leaves(self.state):
            if _is_node_table_path(name) and p.ndim >= 1 and p.shape[0] == n:
                for leaf in (p, mu, nu):
                    leaf[mask] = 0.0

    # -- train loop ----------------------------------------------------------

    def _stage(self, block) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """A dispatch block (es, ed int32; y float32; [super_steps, batch])
        → device tensors."""
        return self._unpack(self._stage_packed(block))

    @staticmethod
    def _unpack(dev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return dev[0].long(), dev[1].long(), dev[2].view(torch.float32)

    def _stage_packed(self, block) -> torch.Tensor:
        """A dispatch block as one [3, super_steps, batch] int32 device
        tensor, packed into one host buffer of 32-bit words and moved in
        one copy.  On the card the buffer is pinned and the copy does not
        wait; two buffers take turns, and a buffer is rewritten only once
        its last copy is done."""
        es, ed, y = block
        size = 3 * es.size
        if self.device.type != "cuda":
            host, copied = torch.empty(size, dtype=torch.int32), None
        else:
            if self._staging is None or self._staging[0][0].numel() != size:
                self._staging = [
                    (torch.empty(size, dtype=torch.int32, pin_memory=True),
                     torch.cuda.Event())
                    for _ in range(2)
                ]
            host, copied = self._staging[self._stage_turn]
            self._stage_turn ^= 1
            copied.synchronize()
        buf = host.numpy().reshape(3, es.size)
        buf[0] = es.reshape(-1)
        buf[1] = ed.reshape(-1)
        buf[2] = np.ascontiguousarray(y, np.float32).reshape(-1).view(np.int32)
        if copied is not None:
            dev = torch.empty(size, dtype=torch.int32, device=self.device)
            dev.copy_(host, non_blocking=True)
            copied.record()
        else:
            dev = host
        return dev.view(3, *es.shape)

    def _share_block(self, block, ids: np.ndarray):
        """Rank 0's next dispatch block (None: the stream ended) and its
        recycled ids on every rank of the mesh: → (this rank's columns of
        the block as (es, ed, y) device tensors, or None; the ids)."""
        shape = (0, 0) if block is None else block[0].shape
        head, ids = pm.broadcast_arrays(
            self.mesh, [np.asarray([block is not None, *shape], np.int32), ids], 2)
        if not head[0]:
            return None, ids
        if self._feeder:
            packed = self._stage_packed(block)
        else:
            packed = torch.empty((3, int(head[1]), int(head[2])), dtype=torch.int32,
                                 device=self.device)
        pm.broadcast(packed, 0, self.mesh.world)
        es, ed, y = self._unpack(packed)
        return (es[:, self._mine], ed[:, self._mine], y[:, self._mine]), ids

    def _train_dispatch(self, es, ed, y) -> torch.Tensor:
        """``super_steps`` optimizer steps, one per row of the block;
        → the dispatch's mean loss, on the device."""
        losses = []
        for i in range(es.shape[0]):
            self.state, loss = _graph_train_step(
                self.state, self.hop_feats, self.table, es[i], ed[i], y[i], None
            )
            losses.append(loss)
        return torch.stack(losses).mean()

    @torch.no_grad()
    def _eval_mae(self, es, ed, y) -> torch.Tensor:
        pred = self.state.model(self.hop_feats, self.table, es, ed, train=False)
        return torch.abs(pred - y).mean()

    def eval_mae(self, es, ed, y) -> float:
        """Val MAE against the CURRENT snapshot's hop features.  On a mesh
        rank 0's edges, scored whole on every rank (the others may pass
        None)."""
        self._ensure_snapshot()
        self.apply_pending_recycles()
        dev = self.device
        if self.mesh is not None:
            es, ed, y = pm.broadcast_arrays(self.mesh, [
                np.asarray(es, np.int32), np.asarray(ed, np.int32), np.asarray(y, np.float32),
            ] if self._feeder else None, 3)
        return float(
            self._eval_mae(
                torch.as_tensor(np.asarray(es, np.int64), device=dev),
                torch.as_tensor(np.asarray(ed, np.int64), device=dev),
                torch.as_tensor(np.asarray(y, np.float32), device=dev),
            )
        )

    def run(
        self, *, max_dispatches: Optional[int] = None, idle_timeout: float = 1.0,
    ) -> int:
        """Consume the downloads stream until end_of_stream/idle; refresh
        the graph snapshot every ``refresh_every`` dispatches from the
        topology stream.  Returns dispatches run."""
        cfg = self.config
        self._ensure_snapshot()
        ran = 0
        while max_dispatches is None or ran < max_dispatches:
            block = self._next_dispatch_block(timeout=idle_timeout) if self._feeder else None
            if self.mesh is None:
                if block is None:
                    break
                self.apply_pending_recycles()
                staged = self._stage(block)
            else:
                staged, ids = self._share_block(block, self._take_pending())
                self._reset_rows(ids)
                if staged is None:
                    break
            self.last_loss = self._train_dispatch(*staged)
            self.dispatch += 1
            ran += 1
            self.records_seen += cfg.super_steps * cfg.batch_size
            if cfg.refresh_every and self.dispatch % cfg.refresh_every == 0:
                self.refresh_snapshot()
            if (
                self.checkpoint_dir
                and cfg.checkpoint_every
                and self.dispatch % cfg.checkpoint_every == 0
            ):
                self.checkpoint()
        # Resets queued after the last dispatch must not linger: an
        # eval/export/checkpoint after run() returns would otherwise
        # score recycled ids with their previous owner's embedding.
        self.apply_pending_recycles()
        return ran

    # -- checkpoint / resume -------------------------------------------------

    def _ckpt_path(self) -> str:
        return os.path.join(os.path.abspath(self.checkpoint_dir), "online_graph.pt")

    def _payload(self, ad_state: Optional[dict] = None) -> dict:
        """The checkpoint's contents; ``ad_state``: the adapter's mapping
        when the caller took it already (the mesh checkpoint).  On a
        node-sharded mesh every rank calls it (the tables are gathered)."""
        # The pending probe buffer feeds the NEXT drain — without it a
        # resumed run would rebuild a different window at the following
        # refresh than the uninterrupted run.
        with self._topo_lock:
            parts = list(self._topo_parts)
            fed_since_swap = self._fed_since_swap
        if parts:
            pend = tuple(
                np.concatenate([p[i] for p in parts]) for i in range(3)
            )
        else:
            pend = (
                np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32),
            )
        # Adapter id-mapping state: clock-driven eviction makes the
        # mapping non-replayable, so it travels with the checkpoint.
        # Live adapter wins; else carry a restored-but-unclaimed stash
        # forward; else none.
        if ad_state is None:
            if self._adapter is not None:
                ad_state = self._adapter.snapshot_for_checkpoint()
            elif self._adapter_restore is not None:
                ad_state = dict(self._adapter_restore)
            else:
                ad_state = {}
        leaves = _whole_leaves(self.state)
        src, dst, rtt = self._window

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a))

        return {
            "params": {name: p.detach().cpu().clone() for name, p, _, _ in leaves},
            "opt_mu": {name: m.detach().cpu().clone() for name, _, m, _ in leaves},
            "opt_nu": {name: v.detach().cpu().clone() for name, _, _, v in leaves},
            "opt_count": int(self.state.opt.count),
            "step": int(self.state.step),
            "generator": self.state.generator.get_state(),
            "dispatch": self.dispatch,
            "snapshot_idx": self.snapshot_idx,
            "records_seen": self.records_seen,
            "fed_since_swap": fed_since_swap,
            "pending": [t(a) for a in pend],
            # Derived-state inputs: the snapshot is rebuilt from these at
            # restore instead of checkpointing the [N, F] hop table.
            "window": [t(src), t(dst), t(rtt)],
            "node_feats": t(self.node_feats),
            "adapter": {
                k: (t(v) if isinstance(v, np.ndarray) else v)
                for k, v in ad_state.items()
            },
        }

    def checkpoint(self) -> None:
        """Write the checkpoint file (atomically: a crash mid-save leaves
        the previous one).  Queued row resets are folded into the state
        first so a restore cannot resurrect a recycled id's previous
        owner.  On a mesh every rank calls it: the resets queued up to
        the adapter's mapping are applied on every rank, the node tables
        are gathered whole, rank 0 writes, and no rank returns before the
        file is in place."""
        if self.mesh is not None:
            self._checkpoint_mesh()
            return
        self.apply_pending_recycles()
        payload = self._payload()
        path = self._ckpt_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def _checkpoint_mesh(self) -> None:
        ad_state = None
        if self._feeder and self._adapter is not None:
            ad_state, ids = self._adapter.snapshot_with_pending()
        else:
            ids = self._take_pending()
        self._reset_rows(self._share_ids(ids))
        payload = self._payload(ad_state if self._feeder else {})
        if self._feeder:
            path = self._ckpt_path()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            torch.save(payload, tmp)
            os.replace(tmp, path)
        pm.barrier(self.mesh)

    def make_wire_adapter(self) -> WireIngestAdapter:
        """An adapter TrainerService(online_sink=...) feeds straight off
        the Train stream — the full wire → online-trainer path.  Rank 0
        of a mesh is the one feeder."""
        if not self._feeder:
            raise ValueError("rank 0 feeds a mesh trainer: make the wire adapter there")
        return WireIngestAdapter(self)

    def close(self) -> None:
        """Release stream-side resources.  The Python adapter holds none
        (the reference's closes its native engine); kept for the
        reference's interface."""

    def resume(self) -> bool:
        """Restore params/moments/step/generator/stream position AND
        rebuild the graph snapshot from the checkpointed topology window;
        False if no checkpoint exists.  A resumed run continues
        byte-identically — including when the checkpoint straddles a
        refresh boundary.  On a mesh every rank reads the one file and
        keeps its block of each node table."""
        if not self.checkpoint_dir or not os.path.exists(self._ckpt_path()):
            return False
        restored = torch.load(self._ckpt_path(), map_location="cpu", weights_only=True)
        shard = self.state.model.node_shard
        with torch.no_grad():
            for name, p, mu, nu in _leaves(self.state):
                for leaf, key in ((p, "params"), (mu, "opt_mu"), (nu, "opt_nu")):
                    value = restored[key][name]
                    if shard is not None and _is_node_table_path(name):
                        value = shard.block(value)
                    leaf.copy_(value)
        self.state.opt.count = int(restored["opt_count"])
        self.state.step = int(restored["step"])
        self.state.generator.set_state(restored["generator"])
        self.dispatch = int(restored["dispatch"])
        self.snapshot_idx = int(restored["snapshot_idx"])
        self.records_seen = int(restored["records_seen"])
        self.node_feats = restored["node_feats"].numpy().astype(np.float32, copy=True)
        self._window = tuple(
            a.numpy().astype(dt, copy=True)
            for a, dt in zip(restored["window"], (np.int32, np.int32, np.float32))
        )
        pend = tuple(
            a.numpy().astype(dt, copy=True)
            for a, dt in zip(restored["pending"], (np.int32, np.int32, np.float32))
        )
        with self._topo_lock:
            self._topo_parts = [pend] if len(pend[0]) else []
            self._topo_count = len(pend[0])
            self._fed_since_swap = int(restored["fed_since_swap"])
        # Stash the adapter id-mapping for the next make_wire_adapter()
        # (or re-attach it to an already-live adapter in place).
        ad = restored["adapter"]
        if ad:
            self._adapter_restore = {
                k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in ad.items()
            }
            if self._adapter is not None:
                self._adapter._apply_restore(self._adapter_restore)
        else:
            self._adapter_restore = None
        self._build_snapshot(use_source=False)
        return True
