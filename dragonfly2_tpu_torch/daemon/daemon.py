"""Daemon composition root (reference: client/daemon/daemon.go:118-417).

Wires storage, upload, conductor, pex, and the probe agent around one
Host identity.  ``InProcessFetcher`` is the piece transport seam: it
resolves a parent host id to that daemon's UploadManager — the in-process
stand-in for the HTTP piece data plane, with identical semantics
(concurrency caps, crc-verified reads).

Port of ``dragonfly2_tpu/daemon/daemon.py``, verbatim but for the imports.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from ..scheduler.networktopology import ProbeAgent
from ..scheduler.resource import Host
from ..scheduler.service import SchedulerService
from .conductor import Conductor, DownloadResult
from .pex import GossipBus, MemberMeta, PeerExchange
from .storage import DaemonStorage
from .traffic_shaper import TrafficShaper
from .upload import UploadManager


class InProcessFetcher:
    """Piece transport: parent host id → its daemon's upload manager."""

    def __init__(self, registry: Dict[str, "Daemon"]):
        self._registry = registry

    def fetch(self, parent_host_id: str, task_id: str, number: int) -> bytes:
        daemon = self._registry.get(parent_host_id)
        if daemon is None:
            raise KeyError(f"no daemon for host {parent_host_id}")
        return daemon.upload.serve_piece(task_id, number)

    def piece_bitmap(self, parent_host_id: str, task_id: str):
        """Piece-metadata sync for the in-process transport (same contract
        as HTTPPieceFetcher.piece_bitmap)."""
        daemon = self._registry.get(parent_host_id)
        if daemon is None:
            return None
        n = daemon.storage.n_pieces(task_id)
        if n <= 0:
            return None
        return bytes(daemon.storage.piece_bitmap(task_id, n))

    def wait_piece_bitmap(
        self, parent_host_id: str, task_id: str, have: int, wait_s: float
    ):
        """Piece-metadata SUBSCRIPTION (piecetask_synchronizer analog):
        block until the parent holds more than ``have`` pieces (a
        mid-download parent commits a new one) or ``wait_s`` elapses,
        then return the current bitmap."""
        daemon = self._registry.get(parent_host_id)
        if daemon is None:
            return None
        deadline = time.monotonic() + wait_s
        while True:
            n = daemon.storage.n_pieces(task_id)
            grew = n > 0 and daemon.storage.held_pieces(task_id) > have
            if grew or time.monotonic() >= deadline:
                return (
                    bytes(daemon.storage.piece_bitmap(task_id, n))
                    if n > 0 else None
                )
            time.sleep(0.01)


class Daemon:
    def __init__(
        self,
        host: Host,
        scheduler: SchedulerService,
        *,
        storage_root: str,
        daemon_registry: Optional[Dict[str, "Daemon"]] = None,
        gossip_bus: Optional[GossipBus] = None,
        source_fetcher=None,
        quota_bytes: int = 10 << 30,
        total_rate: float = 1e9,
        prefer_native: bool = True,
        concurrent_source_groups: int = 1,
        tenant: str = "",
    ) -> None:
        self.host = host
        self.scheduler = scheduler
        # Declared tenant (DESIGN.md §26): stamped on registers and
        # announces; tasks this daemon downloads are owned by it, so
        # serves of their pieces account (and throttle) against it.
        self.tenant = tenant
        self.storage = DaemonStorage(
            storage_root, quota_bytes=quota_bytes, prefer_native=prefer_native
        )
        self.upload = UploadManager(
            self.storage, concurrent_limit=host.concurrent_upload_limit
        )
        self.traffic_shaper = TrafficShaper(total_rate)
        self._registry = daemon_registry if daemon_registry is not None else {}
        self._registry[host.id] = self
        self.conductor = Conductor(
            host,
            self.storage,
            scheduler,
            piece_fetcher=InProcessFetcher(self._registry),
            source_fetcher=source_fetcher,
            traffic_shaper=self.traffic_shaper,
            concurrent_source_groups=concurrent_source_groups,
            tenant=tenant,
        )
        self.pex: Optional[PeerExchange] = None
        if gossip_bus is not None:
            self.pex = PeerExchange(
                MemberMeta(host_id=host.id, ip=host.ip, port=host.download_port),
                gossip_bus,
            )
            self.pex.serve()
            # The conductor needs the pex handle for its scheduler-down
            # fallback (gossip-discovered holders) — without this wiring
            # the fallback silently never engages (the CLI composition
            # attaches it the same way).
            self.conductor.pex = self.pex
        self.probe_agent: Optional[ProbeAgent] = None

    def enable_probes(self, ping) -> None:
        """Attach the probe agent (client/daemon/networktopology)."""
        if self.scheduler.networktopology is not None:
            self.probe_agent = ProbeAgent(
                self.host, self.scheduler.networktopology, ping
            )

    def probe_round(self) -> int:
        return self.probe_agent.sync_probes() if self.probe_agent else 0

    def set_qos_policy(self, policy) -> None:
        """Adopt a tenant QoS policy (manager-published, re-published on
        announce answers): upload-path bandwidth caps + the shaper's
        tenant weight split (DESIGN.md §26)."""
        self.upload.set_qos_policy(policy)
        self.traffic_shaper.set_policy(policy)

    def download(self, url: str, **kwargs) -> DownloadResult:
        from ..utils import idgen

        # Stamp task ownership BEFORE any bytes move: serves of this
        # task's pieces (to other peers, mid-download included) account
        # against this daemon's tenant.
        self.upload.register_task_tenant(
            kwargs.get("task_id") or idgen.task_id(url), self.tenant
        )
        result = self.conductor.download(url, **kwargs)
        # The conductor advertises every download it EXECUTED (all three
        # planes + tiny); only reuse results — served straight from disk,
        # e.g. after a restart reload raced ahead of reload()'s
        # re-advertisement — need one here.  Advertising twice would
        # double gossip traffic per download on the UDP bus.
        if result.ok and result.reused and self.pex is not None:
            self.pex.advertise(result.task_id, set(range(result.pieces)))
        return result

    def open_stream(self, url: str, **kwargs):
        """Stream-task entry (StartStreamTask analog): bytes flow as
        pieces commit — reuse, attach-to-running, or background download."""
        from ..utils import idgen

        self.upload.register_task_tenant(
            kwargs.get("task_id") or idgen.task_id(url), self.tenant
        )
        return self.conductor.open_stream(url, **kwargs)

    def read_task_bytes(self, task_id: str) -> bytes:
        """Reassemble a completed task's content (storage-level impl, shared
        by dfget output, the object gateway, the proxy, and dfdaemon)."""
        return self.storage.read_task_bytes(task_id)

    def delete_task(self, task_id: str) -> None:
        """Evict local data and withdraw the pex advertisement."""
        self.storage.delete_task(task_id)
        if self.pex is not None:
            self.pex.retract(task_id)

    def reclaim(self) -> list:
        """Quota GC with advertisement retraction (use instead of calling
        storage.reclaim directly when pex is enabled)."""
        reclaimed = self.storage.reclaim()
        if self.pex is not None:
            for task_id in reclaimed:
                self.pex.retract(task_id)
        return reclaimed

    def reload(self) -> int:
        """Crash-restart recovery: reopen on-disk tasks and re-advertise."""
        loaded = self.storage.reload_persistent_tasks(self.storage.scan_disk_tasks())
        if self.pex is not None:
            for task_id in loaded:
                # True piece-count bound from the task header, not a guess —
                # a daemon holding only the tail pieces must still advertise.
                n_pieces = self.storage.n_pieces(task_id)
                if n_pieces <= 0:
                    continue
                bm = self.storage.piece_bitmap(task_id, n_pieces)
                self.pex.advertise(task_id, {int(i) for i in bm.nonzero()[0]})
        return len(loaded)

    def stop(self) -> None:
        if self.pex is not None:
            self.pex.stop()
        self._registry.pop(self.host.id, None)
        self.storage.close()
