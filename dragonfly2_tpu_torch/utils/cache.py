"""TTL in-memory cache with janitor and regex scan (reference: pkg/cache/cache.go).

Backs the read-through layer in front of the network-topology store (the
reference fronts Redis with this; we front the embedded KV store) and the
certificate cache.

Port of ``dragonfly2_tpu/utils/cache.py``, verbatim.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

NO_EXPIRATION = -1.0


class TTLCache:
    def __init__(
        self,
        default_ttl: float = NO_EXPIRATION,
        janitor_interval: float = 0.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._mu = threading.RLock()
        self._items: Dict[str, Tuple[Any, float]] = {}  # key -> (value, deadline)
        self._default_ttl = default_ttl
        self._clock = clock
        self._janitor: Optional[threading.Timer] = None
        self._janitor_interval = janitor_interval
        if janitor_interval > 0:
            self._schedule_janitor()

    def _deadline(self, ttl: Optional[float]) -> float:
        if ttl is None:
            ttl = self._default_ttl
        if ttl == NO_EXPIRATION or ttl < 0:
            return float("inf")
        return self._clock() + ttl

    def set(self, key: str, value: Any, ttl: Optional[float] = None) -> None:
        with self._mu:
            self._items[key] = (value, self._deadline(ttl))

    def add(self, key: str, value: Any, ttl: Optional[float] = None) -> bool:
        """Set only if absent (and not expired). Returns True if stored."""
        with self._mu:
            if self._get_locked(key) is not None:
                return False
            self._items[key] = (value, self._deadline(ttl))
            return True

    def _get_locked(self, key: str) -> Optional[Tuple[Any, float]]:
        item = self._items.get(key)
        if item is None:
            return None
        value, deadline = item
        if deadline < self._clock():
            del self._items[key]
            return None
        return item

    def get(self, key: str, default: Any = None) -> Any:
        with self._mu:
            item = self._get_locked(key)
            return default if item is None else item[0]

    def contains(self, key: str) -> bool:
        with self._mu:
            return self._get_locked(key) is not None

    def delete(self, key: str) -> None:
        with self._mu:
            self._items.pop(key, None)

    def keys(self) -> list[str]:
        with self._mu:
            now = self._clock()
            return [k for k, (_, d) in self._items.items() if d >= now]

    def scan(self, pattern: str) -> Iterator[Tuple[str, Any]]:
        """Yield (key, value) for keys matching the regex (reference: cache.Scan)."""
        rx = re.compile(pattern)
        with self._mu:
            now = self._clock()
            snapshot = [
                (k, v) for k, (v, d) in self._items.items() if d >= now and rx.search(k)
            ]
        yield from snapshot

    def purge_expired(self) -> int:
        with self._mu:
            now = self._clock()
            dead = [k for k, (_, d) in self._items.items() if d < now]
            for k in dead:
                del self._items[k]
            return len(dead)

    def clear(self) -> None:
        with self._mu:
            self._items.clear()

    def __len__(self) -> int:
        with self._mu:
            now = self._clock()
            return sum(1 for _, d in self._items.values() if d >= now)

    def _schedule_janitor(self) -> None:
        def run() -> None:
            self.purge_expired()
            with self._mu:
                if self._janitor_interval > 0:
                    self._schedule_janitor()

        self._janitor = threading.Timer(self._janitor_interval, run)
        self._janitor.daemon = True
        self._janitor.start()

    def close(self) -> None:
        with self._mu:
            self._janitor_interval = 0.0
            if self._janitor is not None:
                self._janitor.cancel()
                self._janitor = None
