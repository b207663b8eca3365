"""sync_peers: manager pulls each scheduler's live host inventory.

Reference: manager/job/sync_peers.go — on an interval, the manager sends
a sync_peers job to every active scheduler; the scheduler's job worker
answers with every host in its host manager (scheduler/job/job.go:285-297)
and the manager merges the results into its peer table (upsert live
hosts, mark vanished ones inactive).

Port of ``dragonfly2_tpu/jobs/sync_peers.py``, verbatim but for the imports.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .queue import JobQueue, JobState

SYNC_PEERS = "sync_peers"


def make_sync_peers_handler(resource):
    """Scheduler-side handler: dump the host manager (job.go:285-297)."""

    def handler(args: Dict) -> List[Dict]:
        return [
            {
                "id": h.id,
                "hostname": h.hostname,
                "ip": h.ip,
                "port": h.port,
                "download_port": h.download_port,
                "type": int(h.type),
                "peer_count": h.peer_count(),
            }
            for h in resource.host_manager.items()
        ]

    return handler


@dataclass
class PeerRecord:
    """One known daemon host as the manager sees it (models.Peer)."""

    id: str
    scheduler_id: str
    hostname: str = ""
    ip: str = ""
    port: int = 0
    download_port: int = 0
    type: int = 0
    active: bool = True
    peer_count: int = 0
    updated_at: float = field(default_factory=time.time)


class SyncPeers:
    """Manager-side runner: fan sync_peers jobs to schedulers, merge."""

    def __init__(
        self,
        broker: JobQueue,
        clusters,
        *,
        interval_s: float = 60.0,
        job_timeout_s: float = 30.0,
        prune_age_s: Optional[float] = None,
    ) -> None:
        self.broker = broker
        self.clusters = clusters
        self.interval_s = interval_s
        self.job_timeout_s = job_timeout_s
        # Terminal job records older than ~10 rounds are history.
        self.prune_age_s = (
            prune_age_s if prune_age_s is not None else max(interval_s * 10, 60.0)
        )
        self._mu = threading.Lock()
        # (scheduler_id, host_id) → PeerRecord
        self.peers: Dict[tuple, PeerRecord] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one round (sync_peers.go Run) --------------------------------------

    def run_once(self) -> int:
        """→ number of schedulers that answered.

        All jobs are fanned out FIRST and collected under one shared
        deadline — N dead schedulers cost one timeout, not N.  Peers of
        schedulers that fell OUT of the active set (keepalive expiry)
        flip inactive too: a crashed scheduler must not leave its
        inventory reported live forever."""
        deadline = time.time() + self.job_timeout_s
        active = self.clusters.active_schedulers()
        pending = [
            (sched.id, self.broker.enqueue(
                SYNC_PEERS, {}, queue_name=f"scheduler:{sched.id}",
                expires_at=deadline,
            ))
            for sched in active
        ]
        answered = 0
        while pending and time.time() < deadline:
            still = []
            for sched_id, job in pending:
                if job.state in (JobState.PENDING, JobState.STARTED):
                    still.append((sched_id, job))
                elif job.state is JobState.SUCCESS:
                    answered += 1
                    self._merge(sched_id, job.result or [])
            pending = still
            if pending:
                time.sleep(0.01)
        active_ids = {s.id for s in active}
        now = time.time()
        with self._mu:
            for (sched_id, _), rec in self.peers.items():
                if sched_id not in active_ids and rec.active:
                    rec.active = False
                    rec.updated_at = now
        self.broker.prune(max_age_s=self.prune_age_s)
        from ..rpc.metrics import SYNC_PEERS_ACTIVE, SYNC_PEERS_ROUNDS_TOTAL

        SYNC_PEERS_ROUNDS_TOTAL.inc()
        SYNC_PEERS_ACTIVE.set(len(self.list_peers(active_only=True)))
        return answered

    def _merge(self, scheduler_id: str, hosts: List[Dict]) -> None:
        """Upsert live hosts; hosts previously known under this scheduler
        but absent from the answer flip inactive (mergePeers)."""
        seen = set()
        now = time.time()
        with self._mu:
            for h in hosts:
                key = (scheduler_id, h["id"])
                seen.add(key)
                self.peers[key] = PeerRecord(
                    id=h["id"], scheduler_id=scheduler_id,
                    hostname=h.get("hostname", ""), ip=h.get("ip", ""),
                    port=h.get("port", 0),
                    download_port=h.get("download_port", 0),
                    type=h.get("type", 0), active=True,
                    peer_count=h.get("peer_count", 0), updated_at=now,
                )
            for key, rec in self.peers.items():
                if key[0] == scheduler_id and key not in seen:
                    rec.active = False
                    rec.updated_at = now

    def list_peers(
        self, scheduler_id: Optional[str] = None, *, active_only: bool = False
    ) -> List[PeerRecord]:
        with self._mu:
            records = list(self.peers.values())
        if scheduler_id is not None:
            records = [r for r in records if r.scheduler_id == scheduler_id]
        if active_only:
            records = [r for r in records if r.active]
        return sorted(records, key=lambda r: (r.scheduler_id, r.id))

    # -- ticker (sync_peers.go Serve) ---------------------------------------

    def serve(self) -> None:
        if self._thread is not None:
            return

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                self.run_once()

        self._thread = threading.Thread(
            target=loop, name="sync-peers", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
