"""Announcer: registers with the manager and ships datasets to the trainer.

Reference (scheduler/announcer/announcer.go): register + keepalive with the
manager (:84-127) and, on ``Trainer.Interval``, stream both record CSVs to
the trainer in 128 MiB chunks over one ``Train`` stream (:144-237).

Here the dataset is already columnar; upload hands the trainer shard
*paths* when co-located (zero-copy — the trainer mmaps the same files) or
chunked bytes when remote, preserving the reference's chunked-stream shape
for the cross-node case.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Optional

from ..records.storage import Storage

if TYPE_CHECKING:
    from ..manager.cluster import ClusterManager, SchedulerInstance
    from ..trainer.service import TrainerService

UPLOAD_CHUNK_BYTES = 128 << 20  # announcer.go:39-41


class Announcer:
    def __init__(
        self,
        scheduler_id: str,
        storage: Storage,
        trainer: "TrainerService",
        *,
        cluster_manager: Optional["ClusterManager"] = None,
        cluster_id: str = "default",
        ip: str = "",
        port: int = 8002,
        hostname: str = "",
        train_interval: float = 7 * 24 * 3600.0,  # constants.go:198 default 7d
    ) -> None:
        self.scheduler_id = scheduler_id
        self.storage = storage
        self.trainer = trainer
        # Any ClusterManager-shaped object: the in-process manager OR the
        # REST wire (rpc/cluster_client.RemoteClusterClient) — one
        # register+keepalive loop implementation either way.
        self.cluster_manager = cluster_manager
        self.cluster_id = cluster_id
        self.ip = ip
        self.port = port
        self.hostname = hostname
        self.train_interval = train_interval
        self.keepalive_interval = 20.0  # < ClusterManager TTL (60 s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._keepalive_thread: Optional[threading.Thread] = None

    def announce_to_manager(self) -> None:
        """Register + keepalive (announcer.go:84-127)."""
        if self.cluster_manager is None:
            return
        from ..manager.cluster import SchedulerInstance

        self.cluster_manager.register_scheduler(
            SchedulerInstance(
                id=self.scheduler_id,
                cluster_id=self.cluster_id,
                hostname=self.hostname,
                ip=self.ip,
                port=self.port,
            )
        )

    def keepalive(self) -> None:
        if self.cluster_manager is not None:
            self.cluster_manager.keepalive(self.scheduler_id)

    def announce_to_trainer(self) -> str:
        """One Train round (announcer.go:144-171): flush buffers, hand both
        datasets to the trainer keyed by this scheduler's host identity, and
        kick training.  Returns the trainer's train-run key."""
        self.storage.flush()
        session = self.trainer.open_train_stream(
            ip=self.ip, hostname=self.hostname, scheduler_id=self.scheduler_id
        )
        for path in self.storage.download_columnar_paths():
            session.send_download_shard(path)
        for path in self.storage.network_topology_columnar_paths():
            session.send_network_topology_shard(path)
        return session.close_and_train()

    def serve(self) -> None:
        if self._thread is not None:
            return
        self.announce_to_manager()

        def train_loop() -> None:
            while not self._stop.wait(self.train_interval):
                try:
                    self.announce_to_trainer()
                except Exception:  # noqa: BLE001 — announce must not kill the scheduler
                    import logging

                    logging.getLogger(__name__).exception("announce_to_trainer failed")

        def keepalive_loop() -> None:
            # The manager marks schedulers inactive past its keepalive TTL
            # (manager/cluster.py); tick well inside it (announcer.go:119-127).
            while not self._stop.wait(self.keepalive_interval):
                self.keepalive()

        self._thread = threading.Thread(target=train_loop, name="announcer", daemon=True)
        self._thread.start()
        if self.cluster_manager is not None:
            self._keepalive_thread = threading.Thread(
                target=keepalive_loop, name="announcer-keepalive", daemon=True
            )
            self._keepalive_thread.start()

    def stop(self) -> None:
        self._stop.set()
