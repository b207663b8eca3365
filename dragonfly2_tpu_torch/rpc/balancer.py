"""Consistent-hash ring (reference: pkg/balancer/consistent_hashing.go).

The reference's gRPC balancer picks the scheduler/seed-peer for a request
by hashing the task id onto a ring of backends, so one task's swarm state
lives on one scheduler.  Same ring here, used by daemons to pick their
scheduler from dynconfig's list.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Optional, Sequence

DEFAULT_REPLICAS = 100  # virtual nodes per backend


def _hash(key: str) -> int:
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


class HashRing:
    def __init__(self, backends: Sequence[str] = (), replicas: int = DEFAULT_REPLICAS):
        self.replicas = replicas
        self._ring: List[int] = []
        self._owners: Dict[int, str] = {}
        self._backends: set = set()
        for b in backends:
            self.add(b)

    def add(self, backend: str) -> None:
        if backend in self._backends:
            return
        self._backends.add(backend)
        for i in range(self.replicas):
            h = _hash(f"{backend}#{i}")
            bisect.insort(self._ring, h)
            self._owners[h] = backend

    def remove(self, backend: str) -> None:
        if backend not in self._backends:
            return
        self._backends.remove(backend)
        for i in range(self.replicas):
            h = _hash(f"{backend}#{i}")
            idx = bisect.bisect_left(self._ring, h)
            if idx < len(self._ring) and self._ring[idx] == h:
                self._ring.pop(idx)
            self._owners.pop(h, None)

    def pick(self, key: str) -> Optional[str]:
        """Backend owning the key; None when the ring is empty."""
        if not self._ring:
            return None
        h = _hash(key)
        idx = bisect.bisect_right(self._ring, h)
        if idx == len(self._ring):
            idx = 0
        return self._owners[self._ring[idx]]

    def backends(self) -> List[str]:
        return sorted(self._backends)


class StickyFailover:
    """Ordered backend list with a sticky cursor: ``current()`` keeps
    answering the last backend that worked; ``advance()`` rotates to the
    next after a failure.  The manager-HA client policy (pkg/balancer's
    pick-first semantics): every client in a process converges on the
    live leader and stays there — no per-call round-robin that would
    split one client's traffic across a leader and a 503ing standby."""

    def __init__(self, backends: Sequence[str]) -> None:
        self._backends: List[str] = [b for b in backends if b]
        if not self._backends:
            raise ValueError("StickyFailover needs at least one backend")
        import threading

        self._mu = threading.Lock()
        self._idx = 0

    def current(self) -> str:
        with self._mu:
            return self._backends[self._idx]

    def advance(self, seen: Optional[str] = None) -> str:
        """Rotate to the next backend.  With ``seen``, only rotate if
        the cursor still points at it — concurrent failures over one
        shared list advance once, not once per caller."""
        with self._mu:
            if seen is None or self._backends[self._idx] == seen:
                self._idx = (self._idx + 1) % len(self._backends)
            return self._backends[self._idx]

    def all(self) -> List[str]:
        """Every backend, current first (the failover try order)."""
        with self._mu:
            return (
                self._backends[self._idx:] + self._backends[:self._idx]
            )

    def __len__(self) -> int:
        return len(self._backends)
