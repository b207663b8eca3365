"""RemoteClusterClient: scheduler → manager registration + keepalive, REST.

Reference: the scheduler registers itself with the manager and ticks a
keepalive stream (scheduler/announcer/announcer.go:84-127,
manager_server_v2.go:749 KeepAlive).  This is the cross-process wire for
that loop: without registration the manager's sync_peers fan-out
(jobs/sync_peers.py enqueues to ``scheduler:{sched.id}`` for *registered*
schedulers only) can never reach the instance's job queue.

Duck-type: implements the ``cluster_manager`` seam the Announcer already
drives in-process (``register_scheduler(SchedulerInstance)`` +
``keepalive(id)``, scheduler/announcer.py) so there is ONE liveness loop
implementation — the Announcer's when a trainer link is configured, this
client's own ``serve()`` otherwise.  ``keepalive`` self-heals: a manager
that answers ``known=False`` (restart lost its in-memory cluster table)
gets an immediate re-registration, whichever loop is ticking.

Port of ``dragonfly2_tpu/rpc/cluster_client.py``, verbatim.
"""

from __future__ import annotations

import logging
import random
import threading
import urllib.error
from typing import Optional

from ..jobs.remote import RemoteJobClient
from .retry import DecorrelatedJitterBackoff

logger = logging.getLogger(__name__)


class RemoteClusterClient:
    def __init__(
        self,
        manager_url,
        *,
        token: Optional[str] = None,
        timeout: float = 10.0,
        keepalive_interval_s: float = 20.0,  # < manager TTL (60 s)
        backoff_rng: Optional[random.Random] = None,
    ) -> None:
        # One shared bearer-authed JSON wrapper with the job wire —
        # manager_url may be a replica list / shared ManagerEndpoints
        # (rpc/resolver), so keepalives fail over with everything else.
        self._http = RemoteJobClient(manager_url, token=token, timeout=timeout)
        self.keepalive_interval_s = keepalive_interval_s
        # Failed keepalives back off with capped decorrelated jitter: a
        # manager bounce must not get the whole fleet's keepalives back
        # in one synchronized wave (thundering herd).  The RNG is
        # injectable for reproducible schedules in tests.
        self._backoff = DecorrelatedJitterBackoff(
            base=min(2.0, keepalive_interval_s),
            cap=max(keepalive_interval_s * 3.0, 2.0),
            rng=backoff_rng,
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._registration: Optional[dict] = None

    def _post(self, path: str, body: dict) -> dict:
        return self._http.call("POST", path, body)

    def register_scheduler(self, inst=None, **kw) -> bool:
        """Accepts a ``SchedulerInstance`` (the ClusterManager duck-type
        the Announcer calls) or the same fields as kwargs.  True on
        success.  Auth failures log at WARNING — a misconfigured token
        otherwise leaves fan-out jobs PENDING with no visible cause."""
        if inst is not None:
            kw = {
                "id": inst.id, "cluster_id": inst.cluster_id,
                "hostname": inst.hostname, "ip": inst.ip, "port": inst.port,
            }
        kw.setdefault("cluster_id", "default")
        self._registration = kw
        return self._try_register()

    def _try_register(self) -> bool:
        if self._registration is None:
            return False
        try:
            self._post("/api/v1/schedulers", self._registration)
            return True
        except urllib.error.HTTPError as exc:
            if exc.code in (401, 403):
                logger.warning(
                    "scheduler registration unauthorized (HTTP %d): check "
                    "manager_token role — sync_peers/preheat jobs will not "
                    "reach this scheduler until registration succeeds",
                    exc.code,
                )
            else:
                logger.warning("scheduler registration failed: %s", exc)
            return False
        except (urllib.error.URLError, OSError) as exc:
            logger.warning("manager unreachable for registration: %s", exc)
            return False

    def keepalive(self, instance_id: str) -> bool:
        """One liveness tick; self-heals an unknown instance (manager
        restart) by re-registering.  False only when the manager stays
        unreachable/unaware after the heal attempt."""
        try:
            reply = self._post(
                f"/api/v1/schedulers/{instance_id}:keepalive", {}
            )
            if bool(reply.get("known")):
                return True
        except urllib.error.HTTPError as exc:
            if exc.code in (401, 403):
                logger.warning(
                    "scheduler keepalive unauthorized (HTTP %d): check "
                    "manager_token role", exc.code,
                )
            return False
        except (urllib.error.URLError, OSError):
            return False
        # Heal only OUR instance — an unknown foreign id is just unknown.
        reg = self._registration
        if reg is not None and reg.get("id") == instance_id:
            return self._try_register()
        return False

    def serve(self) -> None:
        """Standalone keepalive loop — for compositions with no Announcer
        (the Announcer runs the identical tick itself when present).
        Failed ticks wait a decorrelated-jitter backoff instead of the
        fixed interval; a success resets to the normal cadence."""
        if self._thread is not None:
            return

        def loop() -> None:
            wait = self.keepalive_interval_s
            while not self._stop.wait(wait):
                reg = self._registration
                if reg is None:
                    wait = self.keepalive_interval_s
                elif self.keepalive(reg["id"]):
                    self._backoff.reset()
                    wait = self.keepalive_interval_s
                else:
                    wait = self._backoff.next()

        self._thread = threading.Thread(
            target=loop, name="cluster-keepalive", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
