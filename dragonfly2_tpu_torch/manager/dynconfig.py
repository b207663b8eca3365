"""Dynamic configuration: manager-sourced, observer-notified, disk-cached.

Reference semantics (internal/dynconfig/dynconfig.go:45-136,
scheduler/config/dynconfig.go:58-137, client/config/dynconfig_manager.go):
- clients poll the manager every ``refresh_interval`` for cluster-scoped
  config (scheduler lists, cluster overrides like candidate/filter parent
  limits, active model versions);
- observers register and are notified on change;
- every successful fetch is cached to disk; when the manager is
  unreachable the cached copy keeps the service running.

Port of ``dragonfly2_tpu/manager/dynconfig.py``, verbatim but for the imports.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class DynconfigServer:
    """Manager-side: per-scope config versions (the source of truth)."""

    def __init__(self) -> None:
        self._mu = threading.RLock()
        self._data: Dict[str, Dict[str, Any]] = {}
        self._version: Dict[str, int] = {}

    def set(self, scope: str, config: Dict[str, Any]) -> int:
        with self._mu:
            self._data[scope] = dict(config)
            self._version[scope] = self._version.get(scope, 0) + 1
            return self._version[scope]

    def update(self, scope: str, **fields: Any) -> int:
        with self._mu:
            merged = dict(self._data.get(scope, {}))
            merged.update(fields)
            return self.set(scope, merged)

    def get(self, scope: str) -> tuple:
        """Returns (config, version); raises KeyError for unknown scope."""
        with self._mu:
            return dict(self._data[scope]), self._version[scope]


class Dynconfig:
    """Client-side cached fetcher with observers and disk fallback."""

    def __init__(
        self,
        fetch: Callable[[], Dict[str, Any]],
        *,
        refresh_interval: float = 300.0,
        cache_path: Optional[str] = None,
        backoff_rng=None,
    ) -> None:
        from ..rpc.retry import DecorrelatedJitterBackoff

        self._fetch = fetch
        self._interval = refresh_interval
        self._cache_path = cache_path
        self._mu = threading.RLock()
        self._data: Optional[Dict[str, Any]] = None
        self._fetched_at = 0.0
        self._notified = False  # observers have seen SOME config
        self._observers: List[Callable[[Dict[str, Any]], None]] = []
        # Refresh FAILURES back off with capped decorrelated jitter so a
        # restarting manager is not met by the whole fleet's polls in one
        # synchronized wave; a success resets to the normal cadence.
        # Seeded rng => reproducible per-instance schedule.
        self._backoff = DecorrelatedJitterBackoff(
            base=min(2.0, refresh_interval),
            cap=max(refresh_interval, 2.0),
            rng=backoff_rng,
        )
        self.last_refresh_ok = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- observers (dynconfig.go:361-412 observer pattern) -------------------

    def register(self, observer: Callable[[Dict[str, Any]], None]) -> None:
        with self._mu:
            self._observers.append(observer)
            data = self._data
        if data is not None:
            observer(dict(data))

    def deregister(self, observer: Callable[[Dict[str, Any]], None]) -> None:
        with self._mu:
            if observer in self._observers:
                self._observers.remove(observer)

    # -- fetch / cache -------------------------------------------------------

    def _load_disk_cache(self) -> Optional[Dict[str, Any]]:
        if not self._cache_path or not os.path.exists(self._cache_path):
            return None
        try:
            with open(self._cache_path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def _store_disk_cache(self, data: Dict[str, Any]) -> None:
        if not self._cache_path:
            return
        tmp = self._cache_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(data, f)
            os.replace(tmp, self._cache_path)
        except OSError:
            pass

    def refresh(self) -> bool:
        """One fetch; on failure fall back to memory then disk cache.
        Returns True if new data was obtained and observers notified.

        Observers are guaranteed to see config at least once even when the
        first data comes from the disk cache during a manager outage, and
        even when post-recovery data equals the cached copy.
        """
        try:
            data = self._fetch()
        except Exception:  # noqa: BLE001 — manager outage must not kill clients
            self.last_refresh_ok = False
            observers: List[Callable[[Dict[str, Any]], None]] = []
            with self._mu:
                if self._data is None:
                    disk = self._load_disk_cache()
                    if disk is not None:
                        self._data = disk
                        if not self._notified:
                            observers = list(self._observers)
                            self._notified = bool(observers)
                fallback = self._data
            for obs in observers:
                obs(dict(fallback))
            return False
        self.last_refresh_ok = True
        self._backoff.reset()
        with self._mu:
            changed = data != self._data or not self._notified
            self._data = data
            self._fetched_at = time.time()
            observers = list(self._observers) if changed else []
            if observers:
                self._notified = True
        self._store_disk_cache(data)
        for obs in observers:
            try:
                obs(dict(data))
            except Exception:  # noqa: BLE001 — one bad observer must not
                # starve the others or kill the refresh thread.
                import logging

                logging.getLogger(__name__).exception("dynconfig observer failed")
        return changed

    def get(self) -> Dict[str, Any]:
        with self._mu:
            if self._data is not None and (
                time.time() - self._fetched_at < self._interval
            ):
                return dict(self._data)
        self.refresh()
        with self._mu:
            if self._data is None:
                raise RuntimeError("dynconfig: no data and manager unreachable")
            return dict(self._data)

    # -- background serve ----------------------------------------------------

    def serve(self) -> None:
        if self._thread is not None:
            return
        self.refresh()

        def loop() -> None:
            wait = self._interval if self.last_refresh_ok else self._backoff.next()
            while not self._stop.wait(wait):
                try:
                    self.refresh()
                except Exception:  # noqa: BLE001 — the refresh thread is forever
                    import logging

                    logging.getLogger(__name__).exception("dynconfig refresh failed")
                # Failure cadence: decorrelated-jitter backoff until the
                # manager answers again (anti-thundering-herd).
                wait = (
                    self._interval if self.last_refresh_ok
                    else self._backoff.next()
                )

        self._thread = threading.Thread(target=loop, name="dynconfig", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
