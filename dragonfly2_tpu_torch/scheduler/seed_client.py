"""Scheduler→seed-peer trigger client (TriggerDownloadTask analog).

Reference: on a cold task the scheduler asks a seed peer to download it
with a priority, over the seed daemon's ``ObtainSeeds`` stream, and can
attach children as soon as the seed holds pieces
(scheduler/resource/seed_peer.go:93-229,
client/daemon/rpcserver/seeder.go:41-151).

``RemoteSeedPeerClient`` plugs into ``SchedulerService.seed_peer_trigger``:
it picks the best announced seed host (SUPER > STRONG > WEAK, then most
free upload slots), opens the daemon's chunked /obtain_seeds stream, and
returns as soon as the seed REGISTERED AND HOLDS ≥1 PIECE — the moment
children become schedulable against it — while the seed keeps
downloading in the background.  Works across processes: the only
coupling is the host announce (which already carries the daemon's
control port) and HTTP.

Port of ``dragonfly2_tpu/scheduler/seed_client.py``, verbatim but for the imports.
"""

from __future__ import annotations

import json
import logging
import urllib.request
from typing import Iterable, Optional

from ..utils.types import HostType, Priority
from .resource import Host, Resource

logger = logging.getLogger(__name__)

_SEED_RANK = {
    HostType.SUPER_SEED: 0,
    HostType.STRONG_SEED: 1,
    HostType.WEAK_SEED: 2,
}


def pick_seed_host(hosts: Iterable[Host]) -> Optional[Host]:
    candidates = [
        h for h in hosts if h.type.is_seed and h.port > 0 and h.ip
    ]
    if not candidates:
        return None
    return min(
        candidates,
        key=lambda h: (_SEED_RANK.get(h.type, 9), -h.free_upload_count()),
    )


class RemoteSeedPeerClient:
    """callable(url, task_id) -> bool, for SchedulerService.seed_peer_trigger."""

    def __init__(
        self,
        resource: Resource,
        *,
        priority: Priority = Priority.LEVEL0,
        # Must stay BELOW the daemons' register-RPC client timeout (10 s
        # default): the trigger runs inline in register_peer, and a wait
        # longer than the caller's deadline fails the child's registration
        # even while the seed warm-up succeeds.
        first_piece_timeout_s: float = 8.0,
    ) -> None:
        self.resource = resource
        self.priority = priority
        self.first_piece_timeout_s = first_piece_timeout_s

    def __call__(self, url: str, task_id: str) -> bool:
        seed = pick_seed_host(self.resource.host_manager.items())
        if seed is None:
            return False
        endpoint = f"http://{seed.ip}:{seed.port}/obtain_seeds"
        body = json.dumps(
            {"url": url, "task_id": task_id, "priority": int(self.priority)}
        ).encode()
        req = urllib.request.Request(
            endpoint, data=body,
            headers={"Content-Type": "application/json"}, method="POST",
        )
        from ..utils import faultinject

        try:
            faultinject.fire("seed.trigger")
            resp = urllib.request.urlopen(req, timeout=self.first_piece_timeout_s)
        except Exception as exc:  # noqa: BLE001 — trigger failure → back-to-source
            logger.warning("seed trigger %s failed: %s", endpoint, exc)
            return False
        drained = False
        try:
            # Consume events until the seed holds a piece (schedulable) or
            # the stream ends.  urllib decodes the chunked framing; each
            # line is one JSON event.
            for raw in resp:
                try:
                    event = json.loads(raw)
                except ValueError:
                    continue
                kind = event.get("event")
                if kind == "piece" and event.get("count", 0) > 0:
                    # Keep draining in the background so the daemon's
                    # writes never block on a dead pipe; the drain thread
                    # owns closing the response.
                    import threading

                    drained = True
                    threading.Thread(
                        target=self._drain, args=(resp,), daemon=True
                    ).start()
                    return True
                if kind == "done":
                    return bool(event.get("ok")) and event.get("pieces", 0) > 0
        except Exception as exc:  # noqa: BLE001 — stream died mid-way
            logger.warning("seed stream %s died: %s", endpoint, exc)
        finally:
            if not drained:
                try:
                    resp.close()
                except Exception as exc:  # noqa: BLE001
                    logger.debug("seed stream close: %s", exc)
        return False

    @staticmethod
    def _drain(resp) -> None:
        try:
            for _ in resp:
                pass
        except Exception as exc:  # noqa: BLE001
            logger.debug("seed stream drain died: %s", exc)
        finally:
            try:
                resp.close()
            except Exception as exc:  # noqa: BLE001
                logger.debug("seed stream close: %s", exc)
