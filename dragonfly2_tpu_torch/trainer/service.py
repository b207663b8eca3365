"""Trainer service: dataset ingest boundary + train-on-EOF + model push.

Reference (trainer/service/service_v1.go:59-160): the ``Train`` client
stream keys per-host dataset files by HostIDV2(ip, hostname), demuxes
TrainMlpRequest → download data and TrainGnnRequest → networktopology
data, and on EOF kicks ``training.Train`` in a goroutine, which was a stub
(training/training.go:82-99).  Here training is real:

1. train the MLP bandwidth regressor on the download rows;
2. train the graph ranker (the hop ranker, or the GAT) on the probe
   graph + download edges (when the topology dataset is non-empty);
3. evaluate (MSE/MAE + ranking P/R/F1), export local-scorer artifacts,
   and CreateModel into the manager registry (the reference's
   managerclient.CreateModel → manager_server_v1.go:802).

Ingest accepts shard *paths* (co-located zero-copy) or raw bytes (remote
chunked stream), mirroring trainer/storage's per-host files
(storage.go:143-151).

Port of ``dragonfly2_tpu/trainer/service.py``, numpy logic verbatim
(staging, chunk order, the online feed, the reference-CSV conversion,
the dense renumbering of buckets, the node features, the batch sizes).
Training runs on ``device`` (``"cuda"`` unless the caller asks for the
CPU).  The GAT branch builds its neighbor gather with
``ops.segment.make_neighbor_gather``, so its backward runs the
segment-sum kernel (K3) on the card; the JAX service's GAT branch uses an
index gather.  The hop features are computed once, on the device, for
both training and the export.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..manager.registry import ModelRegistry
from ..ops._build import resolve_device
from ..records.columnar import concat_readers
from ..records.features import HOST_FEATURE_DIM
from ..utils import idgen
from ..utils.types import TrainingModelType
from . import metrics as trainer_metrics
from .export import export_from_state, scorer_to_bytes
from .ingest import EdgeBatches
from .train import EvalMetrics, TrainConfig, train_mlp

logger = logging.getLogger(__name__)

MLP_MODEL_NAME = "parent-bandwidth-mlp"
GNN_MODEL_NAME = "parent-ranker-gnn"


@dataclass
class TrainRun:
    key: str
    scheduler_id: str
    download_rows: int = 0
    topology_rows: int = 0
    models: List[str] = field(default_factory=list)  # registry model ids
    metrics: Dict[str, EvalMetrics] = field(default_factory=dict)
    error: Optional[str] = None
    done: threading.Event = field(default_factory=threading.Event)


class TrainSession:
    """One open Train stream (per announcing scheduler)."""

    def __init__(self, service: "TrainerService", host_key: str, scheduler_id: str):
        self._service = service
        self.host_key = host_key
        self.scheduler_id = scheduler_id
        self.download_shards: List[str] = []
        self.topology_shards: List[str] = []
        self.chunk_seq: Dict = {}  # (kind, name) -> last applied chunk seq
        self.decoders: Dict = {}   # (kind, name) -> StreamingRowDecoder (online mode)

    def send_download_shard(self, path: str) -> None:
        self.download_shards.append(
            self._service._stage_shard(self.host_key, "download", path)
        )

    def send_network_topology_shard(self, path: str) -> None:
        self.topology_shards.append(
            self._service._stage_shard(self.host_key, "networktopology", path)
        )

    def close_and_train(self, *, synchronous: bool = True) -> str:
        """EOF: kick training (service_v1.go:153-158 runs it in a goroutine;
        ``synchronous=False`` matches that)."""
        return self._service._train(
            self, synchronous=synchronous
        )


class TrainerService:
    def __init__(
        self,
        registry: Optional[ModelRegistry] = None,
        *,
        data_dir: Optional[str] = None,
        train_config: Optional[TrainConfig] = None,
        mlp_epochs: int = 30,
        gnn_model: str = "hop",
        online_sink=None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.registry = registry or ModelRegistry()
        self.data_dir = data_dir
        self.train_config = train_config or TrainConfig(
            epochs=mlp_epochs, learning_rate=3e-3, warmup_steps=20
        )
        # GNN family for the ingest-triggered training: "hop" (flagship —
        # precomputed aggregation, scatter-free step, models/hop.py) or
        # "gat" (models/gnn.py).  Both export the same GNNScorer artifact.
        if gnn_model not in ("hop", "gat"):
            raise ValueError(f"gnn_model {gnn_model!r} not in ('hop', 'gat')")
        self.gnn_model = gnn_model
        # ONLINE mode (service_v1.go:128-143 continuous feed): with a
        # sink attached (lifecycle.LifecycleDaemon), every
        # chunk landing on the wire ALSO decodes incrementally
        # (records.columnar.StreamingRowDecoder) and streams into the
        # online trainer — rows reach the train loop while the stream is
        # still open, not at EOF.  Staging continues regardless (the
        # durable record of the stream; batch retraining still works).
        self.online_sink = online_sink
        # Rows already fed to the sink per (host_key, kind, name) — the
        # cross-SESSION dedup: a client that reconnects and resends a
        # shard (fresh TrainSession, empty chunk_seq) re-decodes the
        # same prefix, and only rows BEYOND this high-water mark feed.
        self._online_fed: Dict = {}
        self.runs: Dict[str, TrainRun] = {}
        self._mu = threading.Lock()
        self._counter = 0

    # -- ingest --------------------------------------------------------------

    def open_train_stream(
        self, *, ip: str, hostname: str, scheduler_id: str
    ) -> TrainSession:
        host_key = idgen.host_id_v2(ip, hostname)[:24]
        return TrainSession(self, host_key, scheduler_id)

    def _stage_shard(self, host_key: str, kind: str, path: str) -> str:
        """Co-located: reference the shard in place. With a data_dir:
        copy into per-host staging (the remote-upload landing zone)."""
        if self.data_dir is None:
            return path
        staged_dir = os.path.join(self.data_dir, host_key)
        os.makedirs(staged_dir, exist_ok=True)
        staged = os.path.join(staged_dir, f"{kind}_{os.path.basename(path)}")
        shutil.copyfile(path, staged)
        return staged

    def receive_shard_bytes(
        self, session: TrainSession, kind: str, name: str, data: bytes, *, seq: int = 0
    ) -> None:
        """Remote path: raw columnar bytes land in the staging dir.

        Chunks append in ``seq`` order; a RETRIED chunk (same or lower seq
        than already applied) is a no-op — wire clients retry on lost
        responses and a blind append would duplicate 128 MiB blocks into
        the dataset.
        """
        if self.data_dir is None:
            raise RuntimeError("byte ingest requires a data_dir")
        staged_dir = os.path.join(self.data_dir, session.host_key)
        os.makedirs(staged_dir, exist_ok=True)
        staged = os.path.join(staged_dir, f"{kind}_{name}")
        applied = session.chunk_seq.get((kind, name), -1)
        if seq <= applied:
            return  # duplicate delivery
        if seq != applied + 1:
            raise ValueError(f"chunk gap for {kind}/{name}: got {seq}, want {applied + 1}")
        with open(staged, "wb" if seq == 0 else "ab") as f:
            f.write(data)
        session.chunk_seq[(kind, name)] = seq
        if seq == 0:
            if kind == "download":
                session.download_shards.append(staged)
            else:
                session.topology_shards.append(staged)
        if self.online_sink is not None:
            self._feed_online(session, kind, name, data, seq)

    def _feed_online(
        self, session: TrainSession, kind: str, name: str, data: bytes, seq: int
    ) -> None:
        """Online mode: decode the chunk incrementally and stream NEW rows
        to the sink.  Runs after the in-session seq dedup; cross-session
        resends dedupe on the per-dataset row high-water mark."""
        from ..records.columnar import MAGIC, StreamingRowDecoder

        key = (kind, name)
        if key not in session.decoders:
            # Sniff the format once per dataset: reference-CSV shards
            # (the compat path _normalize_shard converts at train time)
            # skip online decode — a ValueError here would kill the
            # legacy client's stream.
            session.decoders[key] = (
                StreamingRowDecoder()
                if seq == 0 and data[: len(MAGIC)] == MAGIC
                else None
            )
        dec = session.decoders[key]
        if dec is None:
            return
        rows = dec.feed(data)
        if not rows.size:
            return
        fed_key = (session.host_key, kind, name)
        with self._mu:
            fed = self._online_fed.get(fed_key, 0)
            start = dec.rows_decoded - len(rows)
            skip = max(fed - start, 0)
            self._online_fed[fed_key] = max(fed, dec.rows_decoded)
        if skip >= len(rows):
            return
        rows = rows[skip:]
        if kind == "download":
            self.online_sink.feed_download_rows(rows)
        else:
            self.online_sink.feed_topology_rows(rows)

    # -- training ------------------------------------------------------------

    @staticmethod
    def _normalize_shard(path: str, kind: str) -> str:
        """Accept the REFERENCE's wire format too: a staged shard that is
        not DFC1 columnar is parsed as the reference's headerless CSV
        (scheduler/storage CSV via announcer.go upload) and converted —
        a reference scheduler can stream its datasets here unmodified."""
        from ..records.columnar import MAGIC

        try:
            with open(path, "rb") as f:
                head = f.read(len(MAGIC))
        except OSError:
            return path
        if head == MAGIC or not head:
            return path
        from ..records import csv_compat

        converted = path + ".dfc"
        # Cached: a retrained session must not re-parse a multi-GB CSV.
        if (
            os.path.exists(converted)
            and os.path.getmtime(converted) >= os.path.getmtime(path)
        ):
            return converted
        import tempfile

        # Per-attempt tmp name: two concurrent retrains over the same
        # staged shard must never interleave writes into one file.
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(path), suffix=".dfc.tmp"
        )
        os.close(fd)
        os.unlink(tmp)  # ColumnarWriter must create the file itself
        try:
            if kind == "download":
                csv_compat.convert_download_csv_to_columnar(path, tmp)
            else:
                csv_compat.convert_topology_csv_to_columnar(path, tmp)
            os.replace(tmp, converted)  # atomic: readers see whole files
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return converted

    def _normalize_session(self, session: TrainSession) -> None:
        session.download_shards = [
            self._normalize_shard(p, "download") for p in session.download_shards
        ]
        session.topology_shards = [
            self._normalize_shard(p, "networktopology")
            for p in session.topology_shards
        ]

    def _train(self, session: TrainSession, *, synchronous: bool) -> str:
        with self._mu:
            self._counter += 1
            key = f"train-{session.host_key}-{self._counter}"
        run = TrainRun(key=key, scheduler_id=session.scheduler_id)
        self.runs[key] = run
        if synchronous:
            self._run_training(run, session)
        else:
            threading.Thread(
                target=self._run_training, args=(run, session), daemon=True
            ).start()
        return key

    def _run_training(self, run: TrainRun, session: TrainSession) -> None:
        t0 = time.perf_counter()
        try:
            # Inside the (possibly async) worker: a multi-GB reference-CSV
            # conversion must not hold the ingest RPC handler thread.
            self._normalize_session(session)
            self._train_mlp(run, session)
            self._train_gnn(run, session)
        except Exception as exc:  # noqa: BLE001 — surfaced on the run record
            logger.exception("training run %s failed", run.key)
            run.error = str(exc)
            trainer_metrics.TRAINING_TOTAL.inc(model="all", result="failure")
        else:
            trainer_metrics.TRAINING_TOTAL.inc(model="all", result="success")
            logger.info(
                "training run %s done in %.1fs: %d download rows, "
                "%d topology rows, models=%s",
                run.key, time.perf_counter() - t0, run.download_rows,
                run.topology_rows, run.models,
            )
        finally:
            trainer_metrics.TRAINING_DURATION.observe(time.perf_counter() - t0)
            run.done.set()

    def _train_mlp(self, run: TrainRun, session: TrainSession) -> None:
        shards = [p for p in session.download_shards if os.path.getsize(p) > 0]
        if not shards:
            return
        rows = concat_readers(shards)
        run.download_rows = rows.shape[0]
        if rows.shape[0] < 64:
            logger.info("run %s: too few download rows (%d)", run.key, rows.shape[0])
            return
        # The deployed scorer ranks parents BEFORE any piece moves: train on
        # serve-time-available features only (features.mask_post_hoc).
        from ..records.features import DOWNLOAD_FEATURE_DIM, mask_post_hoc

        rows = np.array(rows, copy=True)
        rows[:, 2 : 2 + DOWNLOAD_FEATURE_DIM] = mask_post_hoc(
            rows[:, 2 : 2 + DOWNLOAD_FEATURE_DIM]
        )
        rng = np.random.default_rng(0)
        order = rng.permutation(rows.shape[0])
        n_val = max(int(rows.shape[0] * 0.1), 1)
        batch = int(min(4096, max(64, 2 ** int(np.log2(max(rows.shape[0] // 8, 64))))))
        train_rows, val_rows = rows[order[n_val:]], rows[order[:n_val]]
        train = EdgeBatches(train_rows, batch_size=min(batch, len(train_rows)), seed=0)
        val = EdgeBatches(
            val_rows,
            batch_size=min(batch, len(val_rows)),
            shuffle=False,
            drop_remainder=False,
        )
        try:
            state, metrics, _ = train_mlp(
                train, val, config=self.train_config, device=self.device
            )
        except ValueError as exc:
            # Corpus too small (no full batches) — skip this model
            # rather than registering untrained weights.
            logger.warning("run %s: MLP skipped: %s", run.key, exc)
            return
        # Stamp the drift baseline (rollout PSI gate) over the SAME
        # prepared rows the model trained on.
        scorer = export_from_state(
            state,
            train_feature_rows=train_rows[:, 2 : 2 + DOWNLOAD_FEATURE_DIM],
        )
        model = self.registry.create_model(
            name=MLP_MODEL_NAME,
            type=TrainingModelType.MLP.value,
            scheduler_id=run.scheduler_id,
            artifact=scorer_to_bytes(scorer),
            evaluation=metrics.to_dict(),
        )
        run.models.append(model.id)
        run.metrics[MLP_MODEL_NAME] = metrics
        trainer_metrics.TRAINING_RECORDS.inc(run.download_rows, model="mlp")
        trainer_metrics.MODELS_PUBLISHED.inc(model="mlp")

    def _train_gnn(self, run: TrainRun, session: TrainSession) -> None:
        """GNN over the probe graph; needs both topology and download rows."""
        topo_shards = [p for p in session.topology_shards if os.path.getsize(p) > 0]
        dl_shards = [p for p in session.download_shards if os.path.getsize(p) > 0]
        if not topo_shards or not dl_shards:
            return
        topo = concat_readers(topo_shards)
        run.topology_rows = topo.shape[0]
        dl = concat_readers(dl_shards)
        if topo.shape[0] < 8 or dl.shape[0] < 256:
            return

        from ..models.gnn import GNNConfig, build_neighbor_table
        from .train import train_gat_ranker

        # Node index = dense renumbering of the hash buckets seen anywhere.
        buckets = np.unique(
            np.concatenate(
                [topo[:, 0], topo[:, 1], dl[:, 0], dl[:, 1]]
            ).astype(np.int64)
        )
        n_nodes = len(buckets)

        def reindex(col: np.ndarray) -> np.ndarray:
            # buckets is sorted-unique (np.unique) — searchsorted is the
            # vectorized bucket→dense-index map (the Python-dict version is
            # interpreter-bound and would dominate north-star-scale ingest).
            return np.searchsorted(buckets, col.astype(np.int64)).astype(np.int32)

        # Probe graph: src → dst with normalized RTT as the edge feature.
        p_src, p_dst = reindex(topo[:, 0]), reindex(topo[:, 1])
        rtt = topo[:, 2].astype(np.float32)
        table = build_neighbor_table(n_nodes, p_src, p_dst, rtt, max_neighbors=8)

        # Node features averaged from download rows (parent-side features
        # appear under the src bucket, child-side under dst) — the SAME
        # accumulator the online wire adapter uses.
        from ..records.features import accumulate_host_feature_sums

        node_feats = np.zeros((n_nodes, HOST_FEATURE_DIM), dtype=np.float32)
        counts = np.zeros(n_nodes, dtype=np.float32)
        d_src, d_dst = reindex(dl[:, 0]), reindex(dl[:, 1])
        accumulate_host_feature_sums(dl, d_src, d_dst, node_feats, counts)
        node_feats /= np.maximum(counts[:, None], 1.0)

        target = dl[:, -1].astype(np.float32)
        batch = min(2048, max(len(d_src) // 4, 64))
        dev = self.device
        try:
            if self.gnn_model == "hop":
                from ..models.hop import HopConfig, precompute_hop_features
                from .train import train_hop_ranker

                cfg = HopConfig(hidden=64, out_dim=32, dropout=0.0)
                # Compute the hop features ONCE: training and the scorer
                # export must see the same array.
                export_feats = precompute_hop_features(
                    torch.from_numpy(node_feats), table.to(dev), hops=cfg.hops
                )
                state, metrics, _ = train_hop_ranker(
                    node_feats, table, d_src, d_dst, target,
                    model_config=cfg, config=self.train_config, device=dev,
                    batch_size=batch, hop_feats=export_feats,
                )
            else:
                from ..ops.segment import make_neighbor_gather

                cfg = GNNConfig(
                    hidden=64, out_dim=32, num_layers=1, num_heads=2, dropout=0.0,
                    gather_fn=make_neighbor_gather(table.indices, n_nodes, device=dev),
                )
                state, metrics, _ = train_gat_ranker(
                    node_feats, table, d_src, d_dst, target,
                    model_config=cfg, config=self.train_config, device=dev,
                    batch_size=batch,
                )
                export_feats = node_feats
        except ValueError as exc:
            logger.warning("run %s: GNN skipped: %s", run.key, exc)
            return
        from .export import export_gnn_scorer, gnn_scorer_to_bytes

        scorer = export_gnn_scorer(state.model, export_feats, table, buckets)
        model = self.registry.create_model(
            name=GNN_MODEL_NAME,
            type=TrainingModelType.GNN.value,
            scheduler_id=run.scheduler_id,
            artifact=gnn_scorer_to_bytes(scorer),
            evaluation=metrics.to_dict(),
        )
        run.models.append(model.id)
        run.metrics[GNN_MODEL_NAME] = metrics
        trainer_metrics.TRAINING_RECORDS.inc(len(d_src), model="gnn")
        trainer_metrics.MODELS_PUBLISHED.inc(model="gnn")
