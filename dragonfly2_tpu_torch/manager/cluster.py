"""Cluster membership + keepalive (reference: manager CRUD + KeepAlive).

Tracks scheduler and seed-peer instances per cluster with last-keepalive
timestamps; instances past the TTL are reported inactive, mirroring the
manager's keepalive stream liveness (manager_server_v2.go:749) and the
active-scheduler filtering the searcher depends on (searcher.go:146-152).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

DEFAULT_KEEPALIVE_TTL = 60.0


@dataclass
class SchedulerInstance:
    id: str
    cluster_id: str
    hostname: str = ""
    ip: str = ""
    port: int = 8002
    state: str = "active"
    last_keepalive: float = field(default_factory=time.time)


@dataclass
class SeedPeerInstance:
    id: str
    cluster_id: str
    hostname: str = ""
    ip: str = ""
    port: int = 8001
    type: str = "super"
    state: str = "active"
    last_keepalive: float = field(default_factory=time.time)


class ClusterManager:
    def __init__(self, keepalive_ttl: float = DEFAULT_KEEPALIVE_TTL) -> None:
        self._mu = threading.RLock()
        self.ttl = keepalive_ttl
        self._schedulers: Dict[str, SchedulerInstance] = {}
        self._seed_peers: Dict[str, SeedPeerInstance] = {}

    def register_scheduler(self, inst: SchedulerInstance) -> SchedulerInstance:
        with self._mu:
            existing = self._schedulers.get(inst.id)
            if existing is not None:
                existing.last_keepalive = time.time()
                existing.state = "active"
                return existing
            self._schedulers[inst.id] = inst
            return inst

    def register_seed_peer(self, inst: SeedPeerInstance) -> SeedPeerInstance:
        with self._mu:
            existing = self._seed_peers.get(inst.id)
            if existing is not None:
                existing.last_keepalive = time.time()
                existing.state = "active"
                return existing
            self._seed_peers[inst.id] = inst
            return inst

    def keepalive(self, instance_id: str) -> bool:
        with self._mu:
            inst = self._schedulers.get(instance_id) or self._seed_peers.get(instance_id)
            if inst is None:
                return False
            inst.last_keepalive = time.time()
            inst.state = "active"
            return True

    def _expire_locked(self) -> None:
        now = time.time()
        for inst in list(self._schedulers.values()) + list(self._seed_peers.values()):
            if now - inst.last_keepalive > self.ttl:
                inst.state = "inactive"

    def active_schedulers(self, cluster_id: Optional[str] = None) -> List[SchedulerInstance]:
        with self._mu:
            self._expire_locked()
            return [
                s
                for s in self._schedulers.values()
                if s.state == "active"
                and (cluster_id is None or s.cluster_id == cluster_id)
            ]

    def active_seed_peers(self, cluster_id: Optional[str] = None) -> List[SeedPeerInstance]:
        with self._mu:
            self._expire_locked()
            return [
                s
                for s in self._seed_peers.values()
                if s.state == "active"
                and (cluster_id is None or s.cluster_id == cluster_id)
            ]
