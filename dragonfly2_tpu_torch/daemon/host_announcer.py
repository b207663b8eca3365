"""Periodic host announcer: daemon → scheduler stats refresh.

Reference: client/daemon/announcer (announcer.go:103-158) announces live
host stats (CPU/mem/disk/net via gopsutil) to the scheduler on an
interval so the evaluator's host features stay current; plus manager
keepalive (:304+).

Works against both the embedded SchedulerService (announce = store_host
refresh) and the RemoteScheduler wire client (announce_host RPC).

Port of ``dragonfly2_tpu/daemon/host_announcer.py``, verbatim.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..scheduler.resource import Host
from ..utils import hostinfo

DEFAULT_INTERVAL = 30.0


class HostAnnouncer:
    def __init__(
        self,
        host: Host,
        scheduler,
        *,
        interval: float = DEFAULT_INTERVAL,
        collect_stats: bool = True,
        tenant: str = "",
    ) -> None:
        self.host = host
        self.scheduler = scheduler
        self.interval = interval
        self.collect_stats = collect_stats
        # Tenant identity stamped on announces (DESIGN.md §26): wire
        # clients carry it as client state (.tenant), the embedded
        # service takes it as a kwarg.
        self.tenant = tenant
        if tenant and hasattr(scheduler, "tenant"):
            scheduler.tenant = tenant
        # Optional post-announce hook (no args): the daemon CLI adopts
        # announce-answer payloads (tenant_qos, §26) through it.
        self.on_announced = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def announce_once(self) -> None:
        if self.collect_stats:
            info = hostinfo.collect()
            self.host.stats.cpu = info.cpu
            self.host.stats.memory = info.memory
            self.host.stats.disk = info.disk
        self.host.touch()
        from ..scheduler.service import SchedulerService

        if isinstance(self.scheduler, SchedulerService):
            # Embedded service: announce_host refreshes stats and writes
            # the columnar host state on arrival (DESIGN.md §18); the
            # tenant rides as a kwarg into admission accounting (§26).
            self.scheduler.announce_host(self.host, tenant=self.tenant)
        elif hasattr(self.scheduler, "announce_host"):
            # Wire client: the tenant was stamped onto the client above.
            self.scheduler.announce_host(self.host)
        else:
            self.scheduler.resource.store_host(self.host)  # bare Resource shims
        hook = self.on_announced
        if hook is not None:
            hook()

    def serve(self) -> None:
        if self._thread is not None:
            return
        try:
            self.announce_once()
        except Exception:  # noqa: BLE001 — scheduler may still be booting
            import logging

            logging.getLogger(__name__).exception("initial host announce failed")

        def loop() -> None:
            while not self._stop.wait(self.interval):
                try:
                    self.announce_once()
                except Exception:  # noqa: BLE001 — announces must not kill the daemon
                    import logging

                    logging.getLogger(__name__).exception("host announce failed")

        self._thread = threading.Thread(target=loop, name="host-announcer", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
