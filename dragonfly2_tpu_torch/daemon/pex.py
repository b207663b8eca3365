"""Peer exchange: gossip membership + piece advertisement.

Reference: client/daemon/pex/ — hashicorp/memberlist gossip broadcasts
member metadata and per-peer piece advertisements; peers reclaim entries
on member leave (peer_exchange.go:34-50, member_manager.go, peer_pool.go).

In-process equivalent: a shared gossip bus (the transport seam) over which
each daemon's PeerExchange broadcasts joins/leaves and piece holdings.
The pool answers "who has pieces of task T" without a scheduler
round-trip — the daemon's subtask-reuse and seed-peer discovery path.

Port of ``dragonfly2_tpu/daemon/pex.py``, verbatim (the in-process
bus; the networked one is ``pex_net``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Set


@dataclass
class MemberMeta:
    host_id: str
    ip: str = ""
    port: int = 0


class GossipBus:
    """The in-process 'network': fan-out of membership + advertisements."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._members: Dict[str, "PeerExchange"] = {}

    def join(self, pex: "PeerExchange") -> None:
        with self._mu:
            others = list(self._members.values())
            self._members[pex.meta.host_id] = pex
        for other in others:
            other._on_join(pex.meta)
            pex._on_join(other.meta)
            # New member learns existing holdings.
            for task_id, pieces in other.local_holdings():
                pex._on_advertise(other.meta.host_id, task_id, pieces)

    def leave(self, host_id: str) -> None:
        with self._mu:
            self._members.pop(host_id, None)
            others = list(self._members.values())
        for other in others:
            other._on_leave(host_id)

    def broadcast_advertise(self, src_host_id: str, task_id: str, pieces: Set[int]) -> None:
        with self._mu:
            others = [p for h, p in self._members.items() if h != src_host_id]
        for other in others:
            other._on_advertise(src_host_id, task_id, pieces)

    def broadcast_retract(self, src_host_id: str, task_id: str) -> None:
        with self._mu:
            others = [p for h, p in self._members.items() if h != src_host_id]
        for other in others:
            other._on_retract(src_host_id, task_id)


class PeerExchange:
    def __init__(self, meta: MemberMeta, bus: GossipBus) -> None:
        self.meta = meta
        self.bus = bus
        self._mu = threading.Lock()
        self._members: Dict[str, MemberMeta] = {}
        # task_id → host_id → piece set (peer_pool.go)
        self._pool: Dict[str, Dict[str, Set[int]]] = {}
        self._local: Dict[str, Set[int]] = {}

    # -- lifecycle -----------------------------------------------------------

    def serve(self) -> None:
        self.bus.join(self)

    def stop(self) -> None:
        self.bus.leave(self.meta.host_id)

    # -- local advertisement -------------------------------------------------

    def advertise(self, task_id: str, pieces: Set[int]) -> None:
        with self._mu:
            self._local.setdefault(task_id, set()).update(pieces)
            snapshot = set(self._local[task_id])
        self.bus.broadcast_advertise(self.meta.host_id, task_id, snapshot)

    def retract(self, task_id: str) -> None:
        """Local data evicted (quota reclaim / delete): withdraw the
        advertisement so peers stop routing piece fetches here."""
        with self._mu:
            self._local.pop(task_id, None)
        self.bus.broadcast_retract(self.meta.host_id, task_id)

    def local_holdings(self) -> List[tuple]:
        with self._mu:
            return [(t, set(p)) for t, p in self._local.items()]

    # -- queries -------------------------------------------------------------

    def members(self) -> List[MemberMeta]:
        with self._mu:
            return list(self._members.values())

    def member(self, host_id: str) -> "MemberMeta | None":
        with self._mu:
            return self._members.get(host_id)

    def pool_snapshot(self) -> List[tuple]:
        """[(host_id, task_id, pieces)] — the full advertisement pool (the
        anti-entropy sync payload)."""
        with self._mu:
            return [
                (h, t, set(p))
                for t, by_host in self._pool.items()
                for h, p in by_host.items()
            ]

    def find_peers_with_task(self, task_id: str) -> List[str]:
        with self._mu:
            return list(self._pool.get(task_id, {}))

    def find_peers_with_piece(self, task_id: str, number: int) -> List[str]:
        with self._mu:
            return [
                h for h, pieces in self._pool.get(task_id, {}).items() if number in pieces
            ]

    # -- bus callbacks -------------------------------------------------------

    def _on_join(self, meta: MemberMeta) -> None:
        with self._mu:
            self._members[meta.host_id] = meta

    def _on_leave(self, host_id: str) -> None:
        """Member left: drop it and reclaim its advertisements
        (peer_exchange reclaim-on-leave)."""
        with self._mu:
            self._members.pop(host_id, None)
            for task_pool in self._pool.values():
                task_pool.pop(host_id, None)

    def _on_advertise(self, host_id: str, task_id: str, pieces: Set[int]) -> None:
        with self._mu:
            self._pool.setdefault(task_id, {}).setdefault(host_id, set()).update(pieces)

    def _on_retract(self, host_id: str, task_id: str) -> None:
        with self._mu:
            pool = self._pool.get(task_id)
            if pool is not None:
                pool.pop(host_id, None)
