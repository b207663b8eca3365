"""Seed-peer seeder: the ObtainSeeds stream, TPU-build shape.

Reference: the seed daemon serves an ``ObtainSeeds`` stream — the
scheduler triggers a typed, PRIORITIZED download and receives piece
events as the seed fetches from the origin, so children can be attached
to the seed while it is still downloading
(client/daemon/rpcserver/seeder.go:41-151,
scheduler/resource/seed_peer.go:93-229 TriggerDownloadTask).

Here the stream is a chunked HTTP response of JSON-line events
(daemon_control.py POST /obtain_seeds):

    {"event": "accepted", "priority": p}
    {"event": "started",  "task_id": t}
    {"event": "piece",    "count": n}        # monotone piece progress
    {"event": "done",     "ok": true, "pieces": n, "back_to_source": b}

and the prioritized execution lives in ``SeedQueue``: seed jobs beyond
``max_concurrent`` wait in a priority order (LEVEL0 = most urgent
first, FIFO within a level), so a registry-preheat burst cannot starve
an interactive cold-task trigger.

Port of ``dragonfly2_tpu/daemon/seeder.py``, verbatim but for the imports.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..utils.types import Priority

logger = logging.getLogger(__name__)


@dataclass(order=True)
class _Job:
    priority: int
    seq: int
    run: Callable[[], None] = field(compare=False)


class SeedQueue:
    """Priority-ordered executor for seed downloads.

    ``submit`` returns immediately; the job runs on one of
    ``max_concurrent`` workers, most-urgent (lowest Priority value)
    first, FIFO within a priority level.
    """

    def __init__(self, max_concurrent: int = 2) -> None:
        self.max_concurrent = max(1, max_concurrent)
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._heap: list = []
        self._seq = itertools.count()
        self._active = 0
        self._stopped = False
        self._workers = [
            threading.Thread(target=self._loop, name=f"seed-{i}", daemon=True)
            for i in range(self.max_concurrent)
        ]
        for w in self._workers:
            w.start()

    def submit(
        self, run: Callable[[], None], priority: Priority = Priority.LEVEL0
    ) -> None:
        with self._cv:
            if self._stopped:
                raise RuntimeError("SeedQueue stopped")
            heapq.heappush(self._heap, _Job(int(priority), next(self._seq), run))
            self._cv.notify()

    def pending(self) -> int:
        with self._mu:
            return len(self._heap)

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._heap and not self._stopped:
                    # Bounded wait + loop (DF008 timeout sweep): notify
                    # still wakes immediately; the timeout keeps an idle
                    # worker visible to watchdog stack dumps.
                    self._cv.wait(30.0)
                if self._stopped and not self._heap:
                    return
                job = heapq.heappop(self._heap)
                self._active += 1
            try:
                job.run()
            except Exception as exc:  # noqa: BLE001 — job errors surface via its own stream
                logger.warning("seed job failed: %s", exc)
            finally:
                with self._mu:
                    self._active -= 1


class Seeder:
    """Runs prioritized seed downloads and reports piece-level progress.

    ``obtain(...)`` submits the download to the SeedQueue and calls
    ``emit(event_dict)`` as progress happens; it returns when the
    download finishes (the control server streams each emitted event to
    the scheduler as a chunked JSON line).
    """

    def __init__(self, conductor, storage, queue: Optional[SeedQueue] = None):
        self.conductor = conductor
        self.storage = storage
        self.queue = queue or SeedQueue()

    def obtain(
        self,
        url: str,
        *,
        piece_size: int,
        priority: Priority = Priority.LEVEL0,
        content_length: Optional[int] = None,
        task_id: Optional[str] = None,
        emit: Callable[[dict], None] = lambda e: None,
        poll_interval_s: float = 0.05,
    ) -> dict:
        emit({"event": "accepted", "priority": int(priority)})
        done = threading.Event()
        result: dict = {}
        from ..utils import idgen

        # Honor the scheduler's task id: seeding under a different id
        # would warm a task nobody asks for (register_peer accepts
        # explicit ids, so the url-derived default is not authoritative).
        task_id = task_id or idgen.task_id(url)

        def run() -> None:
            try:
                cl = content_length
                if cl is None:
                    cl = self.conductor.probe_content_length(url)
                r = self.conductor.download(
                    url, piece_size=piece_size, content_length=cl,
                    priority=priority, task_id=task_id,
                )
                result.update(
                    ok=r.ok, task_id=r.task_id, pieces=r.pieces,
                    back_to_source=r.back_to_source, bytes=r.bytes,
                )
            except Exception as exc:  # noqa: BLE001 — reported on the stream
                result.update(ok=False, error=str(exc))
            finally:
                done.set()

        self.queue.submit(run, priority)

        # Piece progress: poll pieces HELD ON DISK while the download runs
        # — events fire as soon as the seed can actually serve data, which
        # is when the scheduler may attach children (seeder.go streams
        # pieces for the same reason).  The header total would lie here:
        # registration writes it before any byte arrives.
        started = False
        last = 0
        while not done.wait(poll_interval_s):
            if not started and self.storage.n_pieces(task_id) >= 0:
                # Header exists → the task is registered locally.
                emit({"event": "started", "task_id": task_id})
                started = True
            n = self.storage.held_pieces(task_id)
            if n > last:
                last = n
                emit({"event": "piece", "count": n})
        out = {"event": "done"}
        out.update(result)
        emit(out)
        return result
