"""Server-push channel registry for the bidi scheduling stream.

Reference: the v2 ``AnnouncePeer`` wire is a long-lived bidirectional
stream per peer — the scheduler does not only answer requests, it PUSHES
responses mid-download (new parent lists after a reschedule, typed
errors) via ``stream.Send`` from any handler
(scheduler/service/service_v2.go:89-207,
scheduler/rpcserver/scheduler_server_v2.go:56).

``PeerStreamHub`` is the transport-neutral seam: stream bindings register
a send callback per connected peer; the service layer calls ``push``
when scheduling decisions happen OUTSIDE the peer's own request cycle
(bad-parent ejection, parent death, stall detection).  Payloads are
``ScheduleResult``s; the transport converts to its wire form.

Port of ``dragonfly2_tpu/scheduler/push.py``, verbatim: plain Python with
no transport import, so the hub and the stall sweep run wherever the
scheduler does (the gRPC binding, ``rpc/grpc_transport``, is one
subscriber).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional

from .scheduling import ScheduleResult

logger = logging.getLogger(__name__)


class PeerStreamHub:
    """peer_id → push-callback registry (thread-safe).

    Callbacks must be non-blocking (enqueue-and-return): pushes happen on
    scheduler handler threads and on the stall-monitor thread.
    """

    def __init__(self, *, push_cooldown_s: float = 1.0) -> None:
        self._mu = threading.Lock()
        self._channels: Dict[str, Callable[[ScheduleResult], None]] = {}
        # Per-peer cooldown: a bad parent stays 3σ-bad across many piece
        # reports; without damping every report would re-push a reschedule
        # (and churn the DAG edges each time).
        self.push_cooldown_s = push_cooldown_s
        self._last_push: Dict[str, float] = {}

    def register(
        self, peer_id: str, send: Callable[[ScheduleResult], None]
    ) -> None:
        with self._mu:
            self._channels[peer_id] = send

    def unregister(
        self,
        peer_id: str,
        send: Optional[Callable[[ScheduleResult], None]] = None,
    ) -> None:
        """With ``send``, only unregister if that exact callback still owns
        the slot — a dying stream's late teardown must not evict the
        channel a reconnected stream's `resume` just re-registered (the
        old reader can linger in its request iterator for tens of seconds
        after the client reconnects)."""
        with self._mu:
            if send is not None and self._channels.get(peer_id) is not send:
                return
            self._channels.pop(peer_id, None)
            self._last_push.pop(peer_id, None)

    def subscribed(self, peer_id: str) -> bool:
        with self._mu:
            return peer_id in self._channels

    def claim(self, peer_id: str) -> bool:
        """Reserve a push slot BEFORE doing any scheduling work: True iff
        the peer is connected and outside its cooldown window (the slot is
        stamped).  Callers must claim first, then mutate the DAG, then
        ``push`` — checking the cooldown only at push time would move the
        server-side edges and then drop the notification, leaving the
        child downloading from parents the DAG no longer records.
        """
        now = time.monotonic()
        with self._mu:
            if peer_id not in self._channels:
                return False
            last = self._last_push.get(peer_id, 0.0)
            if now - last < self.push_cooldown_s:
                return False
            self._last_push[peer_id] = now
            return True

    def push(self, peer_id: str, result: ScheduleResult) -> bool:
        """Deliver a schedule to a claimed peer; False if the channel died."""
        with self._mu:
            send = self._channels.get(peer_id)
        if send is None:
            return False
        try:
            send(result)
            return True
        except Exception:  # noqa: BLE001 — a dead stream must not kill handlers
            self.unregister(peer_id, send)
            return False


class StallMonitor:
    """Periodic server-side stall sweep (the piece the unary wire cannot
    express: reschedules *initiated by the scheduler*).

    A running peer that has parents but has not finished a piece within
    ``max_idle_s`` gets fresh candidates (current parents blocklisted)
    pushed down its stream — the child never has to fail first.
    """

    def __init__(
        self, service, *, max_idle_s: float = 10.0, interval_s: float = 2.0
    ) -> None:
        self.service = service
        self.max_idle_s = max_idle_s
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="stall-monitor", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.service.reschedule_stalled(self.max_idle_s)
            except Exception as exc:  # noqa: BLE001 — sweep must survive races
                logger.warning("stall sweep failed: %s", exc)
