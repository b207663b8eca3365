"""Download conductor: the per-task engine turning a schedule into bytes.

Reference: client/daemon/peer/peertask_conductor.go — register with the
scheduler (:255-368), consume parent lists, run CONCURRENT piece workers
pulling a shared piece queue (:1009-1077 initDownloadPieceWorkers /
downloadPieceWorker), report per-piece results, fall back to source when
P2P fails (:493-531); peertask_manager.go:328-423 StartFileTask /
StartStreamTask (reuse-first, stream bytes while downloading);
peertask_reuse.go:49-61 (completed-task reuse skips the scheduler
entirely); peertask_piecetask_synchronizer.go (children learn a
mid-download parent's new pieces as they land — here via bitmap
subscription polls against the parent's piece plane).

Transport-neutral: a ``PieceFetcher`` abstracts "read piece N of task T
from parent P" (in-process: the parent daemon's UploadManager; over the
wire: HTTP range GET to the parent's upload port).  The conductor drives
the REAL scheduler service — the same filter/rank/DAG path production
uses — so daemon-level tests exercise the whole control loop.

Concurrency model (downloadPieceWorker semantics, threads not
goroutines): each active task owns up to ``piece_parallelism`` workers
draining one shared queue of missing piece numbers.  A worker picks a
parent that HOLDS its piece (piece-metadata bitmaps, refreshed while the
swarm is mid-download); a piece nobody holds yet is "no valid piece
temporarily" — the worker polls holder bitmaps instead of burning fetch
failures.  Any worker can adopt server-pushed reschedules for the whole
pool; back-to-source verdicts abort the pool and fall through to the
origin path.

Port of ``dragonfly2_tpu/daemon/conductor.py``, verbatim but for the
``native_pieces`` count: a piece window drains through the port's native
fetch loop (``_native_fetch_window``, ``native.pf_*``) when every gate of
the reference's routing matrix passes, and through the Python arm
otherwise; ``native_pieces`` counts the pieces the engine landed.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import (
    TYPE_CHECKING, Dict, Iterator, List, Optional, Protocol, Sequence, Set,
    Union,
)

from ..scheduler.resource import Host, Peer
from ..scheduler.service import SchedulerService
from ..scheduler.scheduling import ScheduleResultKind
from ..utils.types import TINY_FILE_SIZE, Priority
from .piece_pipeline import (
    CommitPipeline,
    CommitTee,
    PieceLatencyTracker,
    PieceReportBatcher,
    TeeConsumer,
    hedged_fetch,
)
from .storage import DaemonStorage
from .traffic_shaper import TrafficShaper

if TYPE_CHECKING:  # the wiring-time scheduler arms (no runtime import cycle)
    from ..rpc.scheduler_client import RemoteScheduler
    from ..rpc.steering import SteeringSchedulerClient


class PieceFetcher(Protocol):
    def fetch(self, parent_host_id: str, task_id: str, number: int) -> bytes:
        """Fetch one piece from a parent; raises on failure."""
        ...

    def piece_bitmap(self, parent_host_id: str, task_id: str):
        """Optional piece-metadata sync: bytes (1 per held piece) or None."""
        ...


class SourceFetcher(Protocol):
    def fetch(self, url: str, number: int, piece_size: int) -> bytes:
        """Back-to-source: fetch piece N of the origin content."""
        ...


class _SourceFetchError(Exception):
    """Internal: a back-to-source piece fetch failed (task-fatal)."""


def _expected_piece_len(content_length: int, piece_size: int, number: int) -> int:
    """Exact byte length piece `number` must have, or -1 when the task's
    sizing is unknown.  Every fetch path checks its body against this —
    a truncated piece (torn connection, misbehaving parent, injected
    truncate fault) must surface as a FETCH FAILURE to retry/reschedule,
    never be committed as silent corruption."""
    if content_length < 0 or piece_size <= 0:
        return -1
    return max(0, min(piece_size, content_length - number * piece_size))


@dataclass
class DownloadResult:
    ok: bool
    task_id: str
    peer_id: str
    pieces: int = 0
    bytes: int = 0
    back_to_source: bool = False
    failed_pieces: int = 0
    cost_s: float = 0.0
    # True when the bytes came from local storage or a concurrent run of
    # the same task — no new swarm traffic (peertask_reuse.go:49,
    # PeerTaskCacheHitCount).
    reused: bool = False


class TaskRun:
    """Live download state for one task: the subscriber seam streams and
    duplicate downloads attach to (peertask_manager's conductor map +
    SubscribeResponse piece channel, peertask_manager.go:428-437).

    Piece commits and completion signal one shared condition; readers
    wait for "piece N ready" or "run finished".
    """

    def __init__(self, task_id: str) -> None:
        self.task_id = task_id
        self.cond = threading.Condition()
        self.ready: Set[int] = set()
        self.n_pieces = -1
        self.piece_size = 0
        self.content_length = -1
        self.done = False
        self.result: Optional[DownloadResult] = None
        # Pass-through read plane (DESIGN.md §25): every commit path
        # publishes the verified body here; stream consumers (proxy,
        # gateway) register before the download starts and serve bytes
        # with zero disk reads on the fast path.
        self.tee = CommitTee()
        # Byte-range hints from ranged open_stream callers: the piece
        # pull orders the overlapping piece window FIRST so a Range
        # client's bytes arrive before the rest of the task.
        self._range_hints: List[Tuple[int, Optional[int]]] = []
        # The download span's context, recorded when the owned download
        # starts — pass-through serves (the `daemon/stream` span) ride
        # it so they land on the download's trace.
        self.traceparent: Optional[str] = None

    def publish(self, number: int, data: bytes) -> None:
        """Offer a verified piece body to the stream consumers (commit
        paths call this alongside the disk write)."""
        self.tee.publish(number, data)

    def add_range_hint(self, start: int, length: Optional[int]) -> None:
        with self.cond:
            self._range_hints.append((start, length))

    def range_hints(self) -> List[Tuple[int, Optional[int]]]:
        with self.cond:
            return list(self._range_hints)

    def priority_pieces(self, piece_size: int, n_pieces: int) -> Set[int]:
        """Piece numbers covered by any registered byte-range hint."""
        window: Set[int] = set()
        if piece_size <= 0 or n_pieces <= 0:
            return window
        for start, length in self.range_hints():
            first = max(start, 0) // piece_size
            if length is None:
                last = n_pieces - 1
            elif length <= 0:
                continue
            else:
                last = (start + length - 1) // piece_size
            window.update(range(min(first, n_pieces), min(last + 1, n_pieces)))
        return window

    def mark_sized(self, n_pieces: int, piece_size: int, content_length: int) -> None:
        with self.cond:
            self.n_pieces = n_pieces
            self.piece_size = piece_size
            self.content_length = content_length
            self.cond.notify_all()

    def mark_piece(self, number: int) -> None:
        with self.cond:
            self.ready.add(number)
            self.cond.notify_all()

    def finish(self, result: DownloadResult) -> None:
        with self.cond:
            self.done = True
            self.result = result
            self.cond.notify_all()

    def wait_sized(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self.cond:
            while self.n_pieces < 0 and not self.done:
                left = deadline - time.monotonic()
                if left <= 0 or not self.cond.wait(min(left, 1.0)):
                    if time.monotonic() >= deadline:
                        return False
            return self.n_pieces >= 0

    def wait_piece(self, number: int, timeout: float) -> str:
        """→ 'ready' | 'eof' (complete, piece out of range) | 'failed' |
        'timeout'."""
        deadline = time.monotonic() + timeout
        with self.cond:
            while True:
                if number in self.ready:
                    return "ready"
                if self.done:
                    r = self.result
                    if r is not None and r.ok and 0 <= self.n_pieces <= number:
                        return "eof"
                    # A finished-ok run has every in-range piece in
                    # `ready`; done without this one means failure.
                    return "failed"
                left = deadline - time.monotonic()
                if left <= 0:
                    return "timeout"
                self.cond.wait(min(left, 1.0))

    def wait_done(self, timeout: Optional[float] = None) -> Optional[DownloadResult]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self.cond:
            while not self.done:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return None
                self.cond.wait(1.0 if left is None else min(left, 1.0))
            return self.result


@dataclass
class _SwarmState:
    """Worker-pool shared state for one task's P2P phase (the piece
    dispatcher + peer packet state of peertask_conductor.go, folded into
    one lock-guarded record)."""

    parents: List[Peer]
    bitmaps: Dict[str, bytes] = field(default_factory=dict)
    failed: int = 0
    nbytes: int = 0
    hedges: int = 0
    last_refresh: float = 0.0
    lock: threading.Lock = field(default_factory=threading.Lock)
    abort: threading.Event = field(default_factory=threading.Event)
    latency: PieceLatencyTracker = field(default_factory=PieceLatencyTracker)


class Conductor:
    def __init__(
        self,
        host: Host,
        storage: DaemonStorage,
        scheduler: "Union[SchedulerService, RemoteScheduler, SteeringSchedulerClient]",
        piece_fetcher: PieceFetcher,
        source_fetcher: Optional[SourceFetcher] = None,
        *,
        traffic_shaper: Optional[TrafficShaper] = None,
        max_piece_retries: int = 2,
        piece_parallelism: int = 4,
        piece_poll_interval_s: float = 0.05,
        piece_wait_timeout_s: float = 60.0,
        concurrent_source_groups: int = 1,
        concurrent_source_threshold: int = 2,
        pipeline_depth: int = 4,
        batch_reports: bool = True,
        report_linger_s: float = 0.02,
        hedge_enabled: bool = True,
        hedge_min_samples: int = 16,
        hedge_floor_s: float = 0.05,
        hedge_multiplier: float = 1.5,
        stream_tee_depth: int = 8,
        tenant: str = "",
        native_fetch: bool = True,
        pex=None,
    ) -> None:
        self.host = host
        self.storage = storage
        self.scheduler = scheduler
        # Tenant identity (DESIGN.md §26): stamped on every register
        # this conductor makes; "" rides as the default tenant.
        self.tenant = tenant
        self.piece_fetcher = piece_fetcher
        self.source_fetcher = source_fetcher
        # Optional PeerExchange (daemon/pex.py): piece-holder discovery
        # that survives scheduler outages — registration failures fall
        # back to gossip-discovered parents (pex peer_pool semantics).
        self.pex = pex
        self.traffic_shaper = traffic_shaper
        self.max_piece_retries = max_piece_retries
        # Piece workers per task (peertask_conductor.go:1010 count=4).
        self.piece_parallelism = max(1, piece_parallelism)
        # "No valid piece temporarily": how often to re-poll holder
        # bitmaps, and how long a wanted piece may stay unclaimed before
        # the P2P phase gives up (→ back-to-source).
        self.piece_poll_interval_s = piece_poll_interval_s
        self.piece_wait_timeout_s = piece_wait_timeout_s
        # Subscription window when a worker is STARVED (no holder for its
        # piece): the long-poll parks on the parent's piece plane for up
        # to this long instead of hammering it every poll interval — over
        # HTTP that's the difference between 1 request/s and 20/s per
        # parent while waiting on a mid-download swarm.
        self.piece_subscribe_window_s = max(piece_poll_interval_s, 1.0)
        # Concurrent back-to-source (piece_manager.go:793-873 semantics):
        # split the remaining pieces into `groups` contiguous range groups,
        # one worker per group, any worker failure cancels the task.  Only
        # engages when at least `threshold` pieces remain — tiny remainders
        # aren't worth the fan-out.
        self.concurrent_source_groups = max(1, concurrent_source_groups)
        self.concurrent_source_threshold = max(1, concurrent_source_threshold)
        # Data-plane pipeline (DESIGN.md §22): commit piece N (digest +
        # storage + report enqueue) on a committer thread while the
        # worker fetches N+1; 0 = the pre-pipeline inline path (the
        # benchmark's reference arm).  batch_reports coalesces per-piece
        # finished reports into bounded-linger report_pieces_finished
        # RPCs; hedging races a second parent for p99 stragglers once
        # `hedge_min_samples` fetches have established a baseline.
        self.pipeline_depth = max(0, pipeline_depth)
        self.batch_reports = batch_reports
        self.report_linger_s = report_linger_s
        self.hedge_enabled = hedge_enabled
        self.hedge_min_samples = hedge_min_samples
        self.hedge_floor_s = hedge_floor_s
        self.hedge_multiplier = hedge_multiplier
        # Pass-through read plane (DESIGN.md §25): per-consumer tee
        # buffer depth in pieces; 0 disables the tee (stream consumers
        # read every piece back off disk — the bench's reference arm).
        self.stream_tee_depth = max(0, stream_tee_depth)
        # Native data plane, client half (DESIGN.md §28): when every gate
        # passes (native store engine, plain-HTTP parents, no tee
        # consumers, no piece-plane chaos scenario), a piece window
        # drains through the in-engine fetch loop; any piece it cannot
        # land falls back into the Python path below, byte-identically.
        self.native_fetch = native_fetch
        # Pieces the in-engine fetch loop landed (the rest of a P2P
        # download took the Python arm).
        self.native_pieces = 0
        # Storage writes + piece-run bookkeeping from concurrent source
        # workers are serialized; the origin fetch AND the scheduler
        # report overlap (the report is an RPC on remote wirings — it
        # must never run under this lock; dflint DF008 enforces that).
        self._report_lock = threading.Lock()
        # task_id → active TaskRun (findPeerTaskConductor semantics: one
        # conductor per task; later requests attach, never double-fetch).
        self._runs: Dict[str, TaskRun] = {}
        self._runs_mu = threading.Lock()

    def probe_content_length(self, url: str) -> Optional[int]:
        """Origin size via the source fetcher, when it can tell (shared by
        the control API, the seeder, and the CLI --download path)."""
        source = self.source_fetcher
        if source is not None and hasattr(source, "content_length"):
            return source.content_length(url)
        return None

    # -- task id / reuse -----------------------------------------------------

    def _task_id(self, url: str, task_id: Optional[str]) -> str:
        if task_id:
            return task_id
        from ..utils import idgen

        return idgen.task_id(url)

    def _complete_locally(self, task_id: str) -> bool:
        """True when every piece of the task is committed on disk."""
        n = self.storage.n_pieces(task_id)
        return n >= 0 and self.storage.held_pieces(task_id) >= n

    def _reuse_result(self, task_id: str, t0: float) -> DownloadResult:
        n = max(self.storage.n_pieces(task_id), 0)
        return DownloadResult(
            ok=True, task_id=task_id, peer_id="", pieces=n,
            bytes=self.storage.task_bytes(task_id), reused=True,
            cost_s=time.monotonic() - t0,
        )

    def _claim(self, task_id: str):
        """→ (run, owner): attach to an active run, or own a fresh one."""
        with self._runs_mu:
            run = self._runs.get(task_id)
            if run is not None and not run.done:
                return run, False
            run = TaskRun(task_id)
            self._runs[task_id] = run
            return run, True

    def active_run(self, task_id: str) -> Optional[TaskRun]:
        with self._runs_mu:
            run = self._runs.get(task_id)
            return run if run is not None and not run.done else None

    def _run_piece_pool(
        self,
        pending: "deque",
        fetch_one,
        *,
        abort: threading.Event,
        name: str,
        traceparent: Optional[str] = None,
    ) -> None:
        """ONE worker-pool harness for both piece planes (scheduled
        parents and the pex fallback): min(piece_parallelism, |pending|)
        workers drain the queue; ``fetch_one(number) -> bool`` returning
        False — or raising — aborts the POOL (a silently-dead worker
        would let siblings drain `pending` and report a "successful"
        download with its popped piece missing).  Joins before returning;
        `abort or pending` afterwards means failure."""
        if not pending:
            return
        lock = threading.Lock()

        def drain() -> None:
            while not abort.is_set():
                with lock:
                    if not pending:
                        return
                    number = pending.popleft()
                if not fetch_one(number):
                    abort.set()
                    return

        def worker() -> None:
            try:
                if traceparent is not None:
                    # One span per worker, linked into the caller's
                    # download trace so the worker thread's own RPCs and
                    # its per-piece ``daemon/piece`` spans propagate the
                    # same trace id (the durable log head-samples by
                    # trace id, so a 10k-piece task only lands in full
                    # on sampled traces).
                    from ..utils.tracing import default_tracer

                    with default_tracer.remote_span(
                        f"daemon/{name}", traceparent
                    ):
                        drain()
                else:
                    drain()
            except Exception:  # noqa: BLE001 — abort, don't die silently
                import logging

                abort.set()
                logging.getLogger(__name__).warning(
                    "piece worker aborted (%s)", name, exc_info=True
                )

        threads = [
            threading.Thread(target=worker, name=f"{name}-{i}", daemon=True)
            for i in range(min(self.piece_parallelism, len(pending)))
        ]
        for t in threads:
            t.start()
        for t in threads:
            # Bounded join loop (DF008 timeout sweep): a wedged worker
            # surfaces in the faulthandler watchdog dump instead of
            # parking this thread invisibly forever.
            while t.is_alive():
                t.join(5.0)

    @staticmethod
    def _order_pending(
        numbers, run: Optional[TaskRun], piece_size: int, n_pieces: int
    ) -> "deque":
        """Range-priority piece ordering (DESIGN.md §25): pieces inside
        any ranged stream's window come FIRST (ascending — the reader is
        in-order), then the rest ascending.  No hints → natural order."""
        nums = list(numbers)
        if run is None:
            return deque(nums)
        window = run.priority_pieces(piece_size, n_pieces)
        if not window or len(window) >= len(nums):
            return deque(nums)
        nums.sort(key=lambda n: (n not in window, n))
        return deque(nums)

    # -- the main flow (peertask_conductor.go:370 start → pullPieces) --------

    def download(
        self,
        url: str,
        *,
        piece_size: int = 4 << 20,
        content_length: Optional[int] = None,
        expected_pieces: Optional[int] = None,
        source_headers: Optional[dict] = None,
        priority: Priority = Priority.LEVEL0,
        task_id: Optional[str] = None,
    ) -> DownloadResult:
        """``source_headers`` ride along to the origin fetcher (preheat of
        authenticated registry blobs carries the pull token this way);
        they travel per-call — the Conductor is shared across concurrent
        downloads and must not bleed one download's credentials into
        another's origin requests."""
        t0 = time.monotonic()
        tid = self._task_id(url, task_id)
        # Reuse-first (peertask_reuse.go:49): a completed local task
        # serves from disk with no scheduler contact at all.
        if self._complete_locally(tid):
            return self._reuse_result(tid, t0)
        run, owner = self._claim(tid)
        if not owner:
            # Another thread is already downloading this task — attach
            # instead of double-fetching (findPeerTaskConductor).
            result = run.wait_done()
            if result is not None and result.ok:
                r = self._reuse_result(tid, t0)
                r.back_to_source = result.back_to_source
                return r
            return DownloadResult(
                ok=False, task_id=tid, peer_id="",
                cost_s=time.monotonic() - t0,
            )
        return self._download_owned(
            run, url, piece_size=piece_size, content_length=content_length,
            expected_pieces=expected_pieces, source_headers=source_headers,
            priority=priority, t0=t0,
        )

    # -- streaming (StartStreamTask, peertask_manager.go:357-423) ------------

    def open_stream(
        self,
        url: str,
        *,
        piece_size: int = 4 << 20,
        content_length: Optional[int] = None,
        source_headers: Optional[dict] = None,
        priority: Priority = Priority.LEVEL0,
        task_id: Optional[str] = None,
        sizing_timeout_s: float = 30.0,
        start: int = 0,
        length: Optional[int] = None,
        tee: bool = True,
    ) -> "StreamHandle":
        """Serve the task's bytes AS PIECES COMMIT: reuse a completed
        task, attach to a running one, or start the download in the
        background — the proxy and the object gateway consume this so a
        response starts before the task finishes.

        ``start``/``length`` open a RANGED stream: only the byte window
        is served, and the overlapping piece window is scheduled FIRST
        (range-priority ordering in the piece pull) so an HTTP Range
        client's bytes arrive ahead of the rest of the task.  With
        ``tee`` (default), the handle registers a commit-tee consumer
        and serves published pieces with zero disk reads; ``tee=False``
        (or ``stream_tee_depth=0``) keeps the disk round-trip path.
        """
        tid = self._task_id(url, task_id)
        if self._complete_locally(tid):
            return StreamHandle(self, tid, None, start=start, length=length)
        run, owner = self._claim(tid)
        # Register the consumer and the range hint BEFORE the download
        # thread starts: the piece pull then sees the hint when it
        # orders its queue, and the tee never publishes past us (pieces
        # committed before registration sit on disk — the spill path).
        if start > 0 or length is not None:
            run.add_range_hint(start, length)
        consumer = (
            run.tee.register(depth=self.stream_tee_depth)
            if tee and self.stream_tee_depth > 0
            else None
        )
        if owner:
            t = threading.Thread(
                target=self._download_quiet,
                args=(run, url),
                kwargs=dict(
                    piece_size=piece_size, content_length=content_length,
                    expected_pieces=None, source_headers=source_headers,
                    priority=priority, t0=time.monotonic(),
                ),
                name=f"stream-dl-{tid[:8]}",
                daemon=True,
            )
            t.start()
        if not run.wait_sized(sizing_timeout_s):
            if consumer is not None:
                consumer.close()
            raise IOError(f"stream {tid}: sizing timed out")
        return StreamHandle(
            self, tid, run, consumer=consumer, start=start, length=length
        )

    def _download_quiet(self, run: TaskRun, url: str, **kw) -> None:
        """Background-thread face of _download_owned: failures land on the
        run (subscribers see 'failed'), not on an orphan thread traceback."""
        import logging

        try:
            self._download_owned(run, url, **kw)
        except Exception:  # noqa: BLE001 — recorded on the run
            logging.getLogger(__name__).warning(
                "stream download of %s failed", run.task_id, exc_info=True
            )

    def _download_owned(
        self,
        run: TaskRun,
        url: str,
        *,
        piece_size: int,
        content_length: Optional[int],
        expected_pieces: Optional[int],
        source_headers: Optional[dict],
        priority: Priority,
        t0: float,
    ) -> DownloadResult:
        try:
            result = self._download_inner(
                run, url, piece_size=piece_size,
                content_length=content_length,
                expected_pieces=expected_pieces,
                source_headers=source_headers, priority=priority, t0=t0,
            )
        except BaseException:
            result = DownloadResult(
                ok=False, task_id=run.task_id, peer_id="",
                cost_s=time.monotonic() - t0,
            )
            raise
        finally:
            run.finish(result)
            with self._runs_mu:
                if self._runs.get(run.task_id) is run:
                    self._runs.pop(run.task_id)
        return result

    def _download_inner(
        self,
        run: TaskRun,
        url: str,
        *,
        piece_size: int,
        content_length: Optional[int],
        expected_pieces: Optional[int],
        source_headers: Optional[dict],
        priority: Priority,
        t0: float,
    ) -> DownloadResult:
        # Download-scope span: every scheduler RPC made on this thread
        # injects this context, so the server's handler spans link into
        # ONE trace per download (otel task-span analog).
        from ..utils.tracing import default_tracer

        with default_tracer.span(
            "daemon/download", task_id=run.task_id, url=url
        ) as span:
            # Pass-through serves link here: the `daemon/stream` span
            # carries this context so a proxy/gateway serve lands on the
            # download's trace, not as an orphan root.
            run.traceparent = span.traceparent
            result = self._download_registered(
                run, url, piece_size=piece_size,
                content_length=content_length,
                expected_pieces=expected_pieces,
                source_headers=source_headers, priority=priority, t0=t0,
            )
            span.set(
                ok=result.ok, pieces=result.pieces,
                back_to_source=result.back_to_source,
            )
            return result

    def _download_registered(
        self,
        run: TaskRun,
        url: str,
        *,
        piece_size: int,
        content_length: Optional[int],
        expected_pieces: Optional[int],
        source_headers: Optional[dict],
        priority: Priority,
        t0: float,
    ) -> DownloadResult:
        try:
            reg = self.scheduler.register_peer(
                host=self.host, url=url, priority=priority,
                task_id=run.task_id, tenant=self.tenant,
            )
        except Exception:
            # Scheduler unreachable: gossip keeps the swarm serving
            # (pex reclaim/pool semantics — peers found WITHOUT the
            # control plane).  No pex or no sizing → the failure is real.
            if self.pex is None or not content_length or content_length < 0:
                raise
            return self._pull_via_pex(run, url, piece_size, content_length, t0)
        peer = reg.peer
        task = peer.task

        if reg.direct_piece:
            # TINY shortcut: the content arrived inline with registration —
            # no piece transfer at all (service_v1 tiny response).
            self.storage.register_task(
                task.id, piece_size=piece_size, content_length=len(reg.direct_piece)
            )
            run.publish(0, reg.direct_piece)
            self.storage.write_piece(task.id, 0, reg.direct_piece)
            run.mark_sized(1, piece_size, len(reg.direct_piece))
            run.mark_piece(0)
            self.scheduler.report_piece_finished(
                peer, 0, parent_id="", length=len(reg.direct_piece), cost_ns=1
            )
            self.scheduler.report_peer_finished(peer)
            if self.pex is not None:
                self.pex.advertise(task.id, {0})
            return DownloadResult(
                ok=True, task_id=task.id, peer_id=peer.id, pieces=1,
                bytes=len(reg.direct_piece), cost_s=time.monotonic() - t0,
            )

        # First peer in the swarm learns content length from the origin and
        # reports it through the scheduler API (so remote schedulers learn).
        if task.content_length < 0:
            if content_length is None or content_length < 0:
                # -1 is the source clients' "origin won't say" sentinel:
                # proceeding would register a 0-piece task and report a
                # hollow success.
                return self._fail(peer, t0, "unknown content length")
            n_pieces = (
                expected_pieces
                if expected_pieces is not None
                else (content_length + piece_size - 1) // piece_size
            )
            self.scheduler.set_task_info(peer, content_length, n_pieces, piece_size)
        piece_size = task.piece_size or piece_size
        n_pieces = task.total_piece_count

        self.storage.register_task(
            task.id, piece_size=piece_size, content_length=task.content_length
        )
        run.mark_sized(n_pieces, piece_size, task.content_length)
        # Partial reuse: pieces already on disk (crashed/abandoned earlier
        # run) are ready for subscribers and skipped by the workers
        # (local_storage_subtask / FindPartialCompletedTask semantics).
        if n_pieces > 0:
            for n in self.storage.piece_bitmap(task.id, n_pieces).nonzero()[0]:
                run.mark_piece(int(n))
        if self.traffic_shaper is not None:
            self.traffic_shaper.add_task(task.id)
        try:
            if reg.schedule is not None and reg.schedule.kind is ScheduleResultKind.PARENTS:
                result = self._pull_from_parents(
                    peer, reg.schedule.parents, n_pieces, t0, run
                )
                if result is not None:
                    return result
                # P2P path exhausted → back-to-source (dfget.go:141 fallback).
            return self._pull_from_source(
                peer, n_pieces, piece_size, t0, source_headers, run
            )
        finally:
            if self.traffic_shaper is not None:
                self.traffic_shaper.remove_task(task.id)

    def _pull_via_pex(
        self, run: TaskRun, url: str, piece_size: int, content_length: int,
        t0: float,
    ) -> DownloadResult:
        """Scheduler-less download: gossip-discovered holders serve pieces
        directly (the pex pool is the only metadata source)."""
        task_id = run.task_id
        n_pieces = (content_length + piece_size - 1) // piece_size
        self.storage.register_task(
            task_id, piece_size=piece_size, content_length=content_length
        )
        run.mark_sized(n_pieces, piece_size, content_length)
        pending_nums = []
        for number in range(n_pieces):
            if self.storage.has_piece(task_id, number):
                run.mark_piece(number)
            else:
                pending_nums.append(number)
        pending = self._order_pending(pending_nums, run, piece_size, n_pieces)
        lock = threading.Lock()
        abort = threading.Event()
        counters = {"nbytes": 0, "done": 0}

        def fetch_one(number: int) -> bool:
            # Gossip holders stand in for the parent list (no scheduler
            # to report to); no holder serving the piece fails the task.
            for holder in self.pex.find_peers_with_piece(task_id, number):
                if holder == self.host.id:
                    continue
                try:
                    data = self.piece_fetcher.fetch(holder, task_id, number)
                except Exception as exc:  # noqa: BLE001 — next holder
                    logging.getLogger(__name__).debug(
                        "pex fetch piece %d from %s: %s", number, holder, exc
                    )
                    continue
                if len(data) != _expected_piece_len(
                    content_length, piece_size, number
                ):
                    continue  # torn body — try the next holder
                run.publish(number, data)
                self.storage.write_piece(task_id, number, data)
                run.mark_piece(number)
                with lock:
                    counters["nbytes"] += len(data)
                    counters["done"] += 1
                return True
            return False

        from ..utils.tracing import TRACEPARENT_HEADER, default_tracer

        self._run_piece_pool(
            pending, fetch_one, abort=abort, name="pex-worker",
            traceparent=default_tracer.inject().get(TRACEPARENT_HEADER),
        )
        if abort.is_set() or pending:
            return DownloadResult(
                ok=False, task_id=task_id, peer_id="",
                pieces=counters["done"], bytes=counters["nbytes"],
                cost_s=time.monotonic() - t0,
            )
        self.pex.advertise(task_id, set(range(n_pieces)))
        return DownloadResult(
            ok=True, task_id=task_id, peer_id="", pieces=n_pieces,
            bytes=counters["nbytes"], cost_s=time.monotonic() - t0,
        )

    # -- the in-engine fetch window (DESIGN.md §28) ---------------------------

    def _native_fetch_window(
        self, task, run: TaskRun, state: "_SwarmState", pending,
        report_finished,
    ) -> None:
        """One native pass over the pending window: pieces whose chosen
        parent has a dialable plain-HTTP endpoint go to the in-engine
        fetch loop (``native.pf_*`` — pooled keep-alive fetch → length
        check → crc+fsync commit, zero Python per-piece overhead); this
        thread drains the bounded completion queue and does the per-piece
        bookkeeping.  Python keeps every SCHEDULING decision — parent
        selection happens here before submit, and any non-zero completion
        status simply leaves the piece in ``pending`` for the ordinary
        retry/hedge/reschedule machinery below.  One attempt per piece:
        hedging needs the latency tracker's clock around a single fetch,
        so stragglers re-enter the Python arm rather than hedge natively.

        Fallback matrix (§28) — the byte-identical Python arm takes over
        whole when: the knob is off, storage is not the native engine,
        the transport cannot be dialed natively (TLS), a stream consumer
        is attached (the tee needs verified bodies in Python), the
        installed fault scenario targets the piece plane (the engine
        cannot fire Python seams per piece), or the library is absent.
        """
        from ..utils import faultinject

        if not self.native_fetch or not pending:
            return
        if not getattr(self.storage, "is_native", False):
            return
        endpoint_of = getattr(self.piece_fetcher, "native_endpoint", None)
        if endpoint_of is None:
            return
        if run.tee.consumer_count() > 0:
            return
        if faultinject.targets(
            "piece.fetch", "piece.fetch.body", "daemon.stream.tee"
        ):
            return
        from .. import native

        if not native.available():
            return
        # Dispatch seam (DF004): a raising fault forces the Python arm;
        # the crash kind SIGKILLs mid-window — the resumability drill's
        # deterministic kill switch for the native path.
        try:
            faultinject.fire("daemon.piece.native_fetch")
        except Exception as exc:  # noqa: BLE001 — injected: Python arm
            logging.getLogger(__name__).debug(
                "native fetch dispatch faulted (%s): Python arm", exc
            )
            return

        with state.lock:
            plist = list(state.parents)
            bitmaps = dict(state.bitmaps)
        endpoints: Dict[str, tuple] = {}
        for p in plist:
            ep = endpoint_of(p.host.id)
            if ep is not None:
                endpoints[p.id] = ep
        if not endpoints:
            return

        def holds_snap(pid: str, number: int) -> bool:
            bm = bitmaps.get(pid)
            return bm is None or (number < len(bm) and bool(bm[number]))

        from ..utils.tracing import default_tracer

        log = logging.getLogger(__name__)
        fetcher = None
        succeeded: Set[int] = set()
        try:
            fetcher = native.NativePieceFetcher(
                self.storage.engine,
                workers=max(self.piece_parallelism, 1),
                tenant=self.tenant,
            )
            slot_of: Dict[str, int] = {}
            id_by_slot: Dict[int, str] = {}
            for pid, (ip, port) in endpoints.items():
                slot = len(slot_of)
                fetcher.set_parent(slot, ip, int(port))
                slot_of[pid] = slot
                id_by_slot[slot] = pid
            n_submitted = 0
            for number in list(pending):
                holders = [
                    p for p in plist
                    if p.id in slot_of and holds_snap(p.id, number)
                ]
                if not holders:
                    continue  # Python path polls bitmaps for this one
                parent = holders[number % len(holders)]
                expected = _expected_piece_len(
                    task.content_length, task.piece_size, number
                )
                # expected 0 → the engine skips the length check (unknown
                # content length); the crc at commit still gates the body.
                if fetcher.submit(
                    task.id, slot_of[parent.id], number, max(expected, 0)
                ):
                    n_submitted += 1
            ndone = 0
            deadline = time.monotonic() + self.piece_wait_timeout_s
            while ndone < n_submitted and time.monotonic() < deadline:
                for number, status, length, slot, cost_ns in fetcher.complete(
                    timeout_ms=1000
                ):
                    ndone += 1
                    # Same seam, per drained record: the chaos drill's
                    # crash kind lands the SIGKILL between a C++ commit
                    # and its Python bookkeeping — the worst spot for
                    # durability; a raise aborts the window and the
                    # Python arm re-fetches whatever went un-booked.
                    faultinject.fire("daemon.piece.native_fetch")
                    if status != 0:
                        continue  # stays pending → Python retry/hedge
                    parent_id = id_by_slot.get(slot, "")
                    # Same per-piece flight-recorder evidence as the
                    # Python arm (DF016's daemon/piece witness), opened
                    # at drain time from the engine's cost clock.
                    with default_tracer.span(
                        "daemon/piece", number=number, task_id=task.id
                    ) as sp:
                        sp.set(parent=parent_id, bytes=length, native=True)
                    run.mark_piece(number)
                    with state.lock:
                        state.nbytes += length
                        self.native_pieces += 1
                    if self.traffic_shaper is not None:
                        self.traffic_shaper.record(task.id, length)
                    report_finished(number, parent_id, length,
                                    max(int(cost_ns), 1))
                    succeeded.add(number)
        except Exception as exc:  # noqa: BLE001 — window is best-effort
            # Whatever did not land stays in `pending`; the Python arm
            # owns it from here (a latched reporter error re-raises there
            # with its ordinary abort semantics).
            log.debug("native fetch window stopped: %s", exc)
        finally:
            if fetcher is not None:
                fetcher.close()
            if succeeded:
                # Commits bypassed DaemonStorage.write_piece — restore
                # the LRU-reclaim evidence in one touch.
                touch = getattr(self.storage, "touch_task", None)
                if touch is not None:
                    touch(task.id)
                remaining = [n for n in pending if n not in succeeded]
                pending.clear()
                pending.extend(remaining)

    # -- the concurrent P2P phase -------------------------------------------

    def _pull_from_parents(
        self, peer: Peer, parents: List[Peer], n_pieces: int, t0: float,
        run: TaskRun,
    ) -> Optional[DownloadResult]:
        """Piece workers over the assigned parents; None → fall to source.

        peertask_conductor.go:1009-1077 shape: ``piece_parallelism``
        workers drain one shared queue of missing pieces; each picks a
        parent that holds its piece per the bitmap sync, polls for
        unclaimed pieces (mid-download parents advertise pieces as they
        land — piecetask_synchronizer semantics), and any worker can
        adopt server-pushed reschedules for the whole pool.
        """
        task = peer.task
        state = _SwarmState(
            parents=list(parents),
            latency=PieceLatencyTracker(
                min_samples=self.hedge_min_samples,
                floor_s=self.hedge_floor_s,
                multiplier=self.hedge_multiplier,
            ),
        )
        self._refresh_bitmaps(task.id, state, force=True)

        # Resume: pieces already on disk are NOT refetched and NOT
        # per-piece reported (a large partial task would cost thousands of
        # sequential RPCs before the first fetch); the closing
        # report_peer_finished settles the scheduler's task/peer state,
        # and other children learn held pieces from the piece plane's
        # bitmaps, not from the scheduler.
        held = self.storage.piece_bitmap(task.id, n_pieces) if n_pieces > 0 else []
        pending = self._order_pending(
            (n for n in range(n_pieces) if not held[n]), run,
            task.piece_size, n_pieces,
        )

        # Report path: batched (one report_pieces_finished per linger
        # window) or direct per-piece calls.  Commit path: pipelined
        # (digest piece N while N+1 is on the wire) or inline.  Both
        # default ON; the benchmark's reference arm turns them off.
        from ..utils.tracing import TRACEPARENT_HEADER, default_tracer

        reporter = (
            PieceReportBatcher(
                self.scheduler, peer, linger_s=self.report_linger_s,
                traceparent=default_tracer.inject().get(TRACEPARENT_HEADER),
            )
            if self.batch_reports
            else None
        )

        def report_finished(number: int, parent_id: str, length: int,
                            cost_ns: int) -> None:
            if reporter is not None:
                if not reporter.submit(number, parent_id, length, cost_ns):
                    raise reporter.error or IOError("report batcher closed")
            else:
                self.scheduler.report_piece_finished(
                    peer, number, parent_id=parent_id, length=length,
                    cost_ns=cost_ns,
                )

        def commit_piece(number: int, data: bytes, parent_id: str,
                         cost_ns: int) -> None:
            """Digest (crc at write) + persist + mark + report enqueue:
            runs on the committer thread when pipelined, inline in the
            worker otherwise — identical semantics either way."""
            # Tee first (DESIGN.md §25): stream consumers get the
            # verified body alongside the disk write — the pass-through
            # fast path never reads back what was just written.
            run.publish(number, data)
            self.storage.write_piece(task.id, number, data)
            run.mark_piece(number)
            with state.lock:
                state.nbytes += len(data)
            if self.traffic_shaper is not None:
                self.traffic_shaper.record(task.id, len(data))
            report_finished(number, parent_id, len(data), cost_ns)

        pipeline = (
            CommitPipeline(commit_piece, depth=self.pipeline_depth)
            if self.pipeline_depth > 0
            else None
        )

        take_pushed = getattr(self.scheduler, "take_pushed_schedule", None)

        def apply_push() -> None:
            """Adopt a server-pushed reschedule (v2 bidi wire) for the
            whole worker pool."""
            if take_pushed is None:
                return
            res = take_pushed(peer)
            if res is None:
                return
            if res.kind is ScheduleResultKind.PARENTS and res.parents:
                with state.lock:
                    state.parents = list(res.parents)
                self._refresh_bitmaps(task.id, state, force=True)
            elif res.kind is ScheduleResultKind.NEED_BACK_TO_SOURCE:
                state.abort.set()  # pool stops; caller falls to source

        def holds(parent: Peer, number: int) -> bool:
            with state.lock:
                bm = state.bitmaps.get(parent.id)
            return bm is None or (number < len(bm) and bool(bm[number]))

        def fetch_one(number: int) -> bool:
            """Fetch piece `number`; True on success, False → task-level
            abort is set.  One ``daemon/piece`` span per piece (bytes,
            parent, retry count — the flight recorder's per-piece
            evidence; head-sampling keeps a 10k-piece task from flooding
            the durable log on every trace)."""
            from ..utils.tracing import default_tracer

            with default_tracer.span(
                "daemon/piece", number=number, task_id=task.id
            ) as piece_span:
                return fetch_one_traced(number, piece_span)

        def fetch_one_traced(number: int, piece_span) -> bool:
            deadline = time.monotonic() + self.piece_wait_timeout_s
            attempt = 0
            while not state.abort.is_set():
                apply_push()
                with state.lock:
                    plist = list(state.parents)
                if not plist:
                    state.abort.set()
                    return False
                holders = [p for p in plist if holds(p, number)]
                if not holders:
                    # "No valid piece temporarily": nobody claims it yet —
                    # poll holder bitmaps until a mid-download parent
                    # commits it (synchronizer analog), not a fetch error.
                    if time.monotonic() >= deadline:
                        state.abort.set()
                        return False
                    self._refresh_bitmaps(task.id, state)
                    time.sleep(self.piece_poll_interval_s)
                    continue
                parent = holders[(number + attempt) % len(holders)]
                expected = _expected_piece_len(
                    task.content_length, task.piece_size, number
                )
                # Hedge plan: once enough fetches establish a latency
                # baseline, a straggler races a SECOND holder through the
                # same fetch/breaker machinery — first valid body wins.
                threshold = (
                    state.latency.threshold_s() if self.hedge_enabled else None
                )
                by_id = {p.id: p for p in holders}
                alt_id = None
                if threshold is not None and len(holders) > 1:
                    cand = holders[(number + attempt + 1) % len(holders)]
                    if cand.id != parent.id:
                        alt_id = cand.id
                try:
                    t_piece = time.monotonic()
                    data, winner_id, hedged = hedged_fetch(
                        lambda pid: self.piece_fetcher.fetch(
                            by_id[pid].host.id, task.id, number
                        ),
                        lambda d: expected < 0 or len(d) == expected,
                        parent.id,
                        alt_id,
                        threshold_s=threshold,
                        wait_timeout_s=self.piece_wait_timeout_s,
                    )
                    if expected >= 0 and len(data) != expected:
                        raise IOError(
                            f"piece {number}: truncated body "
                            f"({len(data)} != {expected} bytes)"
                        )
                    cost_ns = max(int((time.monotonic() - t_piece) * 1e9), 1)
                    if hedged:
                        with state.lock:
                            state.hedges += 1
                    else:
                        # Only unhedged walls feed the baseline — a
                        # straggler's wall would drag the p99 toward the
                        # very tail the hedge exists to cut.
                        state.latency.observe(time.monotonic() - t_piece)
                except Exception:
                    with state.lock:
                        state.failed += 1
                    res = self.scheduler.report_piece_failed(peer, parent.id)
                    if res.kind is ScheduleResultKind.PARENTS and res.parents:
                        with state.lock:
                            state.parents = list(res.parents)
                        self._refresh_bitmaps(task.id, state, force=True)
                    elif res.kind is ScheduleResultKind.NEED_BACK_TO_SOURCE:
                        state.abort.set()
                        return False
                    attempt += 1
                    if attempt > self.max_piece_retries:
                        piece_span.set(retries=attempt, failed=True)
                        state.abort.set()
                        return False
                    continue
                piece_span.set(
                    parent=winner_id, bytes=len(data), retries=attempt,
                    hedged=hedged,
                )
                if pipeline is not None:
                    # Hand off to the committer: this worker goes straight
                    # to its next fetch while piece `number` digests.
                    if not pipeline.submit(number, data, winner_id, cost_ns):
                        state.abort.set()
                        return False
                else:
                    commit_piece(number, data, winner_id, cost_ns)
                return True
            return False

        # In-engine fast path first (§28): one native pass drains what it
        # can; whatever it leaves in `pending` flows to the Python workers
        # below, whose per-piece semantics are the reference arm.
        self._native_fetch_window(task, run, state, pending, report_finished)

        # Worker threads have their OWN (empty) span stacks; hand them the
        # download span's context so their piece reports stay in-trace.
        from ..utils.tracing import TRACEPARENT_HEADER, default_tracer

        download_tp = default_tracer.inject().get(TRACEPARENT_HEADER)
        try:
            self._run_piece_pool(
                pending, fetch_one, abort=state.abort, name="piece-worker",
                traceparent=download_tp,
            )
        finally:
            # Drain in order: commits first (they enqueue reports), then
            # the report flush — every piece report lands BEFORE the
            # closing report_peer_finished, preserving the scheduler's
            # observable event order.
            commit_err = pipeline.close() if pipeline is not None else None
            report_err = reporter.close() if reporter is not None else None

        with state.lock:
            failed, nbytes = state.failed, state.nbytes
        if state.abort.is_set() or pending or commit_err or report_err:
            if commit_err or report_err:
                logging.getLogger(__name__).warning(
                    "p2p phase failed post-fetch (%s): falling to source",
                    commit_err or report_err,
                )
            return None  # fall to source (or honor pushed back-to-source)
        self.scheduler.report_peer_finished(peer)
        if self.pex is not None:
            self.pex.advertise(task.id, set(range(n_pieces)))
        return DownloadResult(
            ok=True,
            task_id=task.id,
            peer_id=peer.id,
            pieces=n_pieces,
            bytes=nbytes,
            failed_pieces=failed,
            cost_s=time.monotonic() - t0,
        )

    def _refresh_bitmaps(
        self, task_id: str, state: _SwarmState, *, force: bool = False
    ) -> None:
        """Piece-metadata sync (SyncPieceTasks analog): which pieces does
        each parent hold RIGHT NOW.  Rate-limited so a pool of pollers
        doesn't hammer the piece plane; `force` refreshes immediately
        (new parents adopted)."""
        if not hasattr(self.piece_fetcher, "piece_bitmap"):
            return
        wait = getattr(self.piece_fetcher, "wait_piece_bitmap", None)
        # Gate at the width of the refresh itself: with the subscription
        # available, ONE worker parks for the window while its siblings
        # skip (claiming last_refresh at entry) — not a fresh long-poller
        # every poll interval.
        gate = (
            self.piece_subscribe_window_s
            if (wait is not None and not force)
            else self.piece_poll_interval_s
        )
        now = time.monotonic()
        with state.lock:
            if not force and now - state.last_refresh < gate:
                return
            state.last_refresh = now
            plist = list(state.parents)
        # The WHOLE refresh is bounded by one window, split across
        # parents — serial full-window parks would delay abort/push/
        # deadline checks by len(parents) × window.
        per_parent_wait = (
            self.piece_subscribe_window_s / max(len(plist), 1)
            if plist else 0.0
        )
        for p in plist:
            if state.abort.is_set():
                return
            try:
                if wait is not None and not force:
                    with state.lock:
                        have = int(sum(state.bitmaps.get(p.id, b"")))
                    bm = wait(p.host.id, task_id, have, per_parent_wait)
                else:
                    bm = self.piece_fetcher.piece_bitmap(p.host.id, task_id)
            except Exception as exc:  # noqa: BLE001 — a dead parent just has no bitmap
                logging.getLogger(__name__).debug(
                    "bitmap from %s: %s", p.host.id, exc
                )
                bm = None
            if bm is not None:
                with state.lock:
                    state.bitmaps[p.id] = bm

    # -- back-to-source ------------------------------------------------------

    def _pull_from_source(
        self,
        peer: Peer,
        n_pieces: int,
        piece_size: int,
        t0: float,
        headers: Optional[dict] = None,
        run: Optional[TaskRun] = None,
    ) -> DownloadResult:
        task = peer.task
        if self.source_fetcher is None:
            return self._fail(peer, t0, "no source fetcher")
        self.scheduler.mark_back_to_source(peer)
        # Resume, don't restart: pieces already fetched from parents stay
        # on disk with their parent attribution intact — the origin only
        # serves what P2P didn't (piece_manager.go resumes from the
        # persisted piece bitmap the same way).
        missing = list(self._order_pending(
            (n for n in range(n_pieces) if not self.storage.has_piece(task.id, n)),
            run, task.piece_size or piece_size, n_pieces,
        ))
        groups = min(self.concurrent_source_groups, len(missing))
        try:
            if groups > 1 and len(missing) >= self.concurrent_source_threshold:
                nbytes = self._source_piece_groups(
                    peer, missing, piece_size, groups, headers, run
                )
            else:
                nbytes = 0
                for number in missing:
                    nbytes += self._source_one_piece(
                        peer, number, piece_size, headers, run
                    )
        except _SourceFetchError as e:
            return self._fail(peer, t0, str(e))
        self.scheduler.report_peer_finished(peer)
        if self.pex is not None:
            self.pex.advertise(task.id, set(range(n_pieces)))
        return DownloadResult(
            ok=True,
            task_id=task.id,
            peer_id=peer.id,
            pieces=n_pieces,
            bytes=nbytes,
            back_to_source=True,
            cost_s=time.monotonic() - t0,
        )

    def _source_one_piece(
        self,
        peer: Peer,
        number: int,
        piece_size: int,
        headers: Optional[dict] = None,
        run: Optional[TaskRun] = None,
    ) -> int:
        """Fetch piece `number` from the origin, persist + report it."""
        from ..source.client import call_with_optional_headers
        from ..utils.tracing import default_tracer

        task = peer.task
        t_piece = time.monotonic()
        with default_tracer.span(
            "daemon/source.piece", number=number, task_id=task.id
        ) as piece_span:
            try:
                data = call_with_optional_headers(
                    self.source_fetcher.fetch, task.url, number, piece_size,
                    headers=headers,
                )
            except Exception:
                raise _SourceFetchError(f"source fetch piece {number}")
            piece_span.set(bytes=len(data))
        expected = _expected_piece_len(task.content_length, piece_size, number)
        if expected >= 0 and len(data) != expected:
            # A short origin body persisted as a full piece would be
            # SILENT corruption (digest mismatch at read time, long after
            # the cause) — fail the task loudly instead.
            raise _SourceFetchError(
                f"source piece {number}: truncated body "
                f"({len(data)} != {expected} bytes)"
            )
        cost_ns = max(int((time.monotonic() - t_piece) * 1e9), 1)
        with self._report_lock:
            if run is not None:
                run.publish(number, data)
            self.storage.write_piece(task.id, number, data)
            if run is not None:
                run.mark_piece(number)
        # Scheduler reports run OUTSIDE the lock (DF008): the scheduler —
        # local service or RPC client — is thread-safe and piece reports
        # carry their own numbers, so ordering between workers is free.
        # Holding _report_lock across a report RPC would stall every
        # concurrent source worker on one slow scheduler round-trip (the
        # p2p piece path already reports unlocked).
        self.scheduler.report_piece_finished(
            peer, number, parent_id="", length=len(data), cost_ns=cost_ns
        )
        # First fetcher of a TINY task publishes the bytes inline so
        # later peers skip the transfer entirely.
        if (
            number == 0
            and 0 < task.content_length <= TINY_FILE_SIZE
            and hasattr(self.scheduler, "set_task_direct_piece")
        ):
            self.scheduler.set_task_direct_piece(
                peer, data[: task.content_length]
            )
        return len(data)

    def _source_piece_groups(
        self,
        peer: Peer,
        missing: Sequence[int],
        piece_size: int,
        groups: int,
        headers: Optional[dict] = None,
        run: Optional[TaskRun] = None,
    ) -> int:
        """Concurrent back-to-source by contiguous piece groups.

        piece_manager.go:793-873: `con` workers each own a contiguous slice
        of the remaining pieces (the first `remainder` groups take one extra);
        the first worker failure cancels the whole task.
        """
        per, rem = divmod(len(missing), groups)
        slices: List[Sequence[int]] = []
        start = 0
        for i in range(groups):
            size = per + (1 if i < rem else 0)
            slices.append(missing[start : start + size])
            start += size
        cancelled = threading.Event()

        def run_group(numbers: Sequence[int]) -> int:
            nbytes = 0
            for number in numbers:
                if cancelled.is_set():
                    raise _SourceFetchError("cancelled by sibling group")
                try:
                    nbytes += self._source_one_piece(
                        peer, number, piece_size, headers, run
                    )
                except Exception as e:
                    # Not just fetch failures: a write/report error
                    # (disk full, scheduler unreachable) is equally
                    # task-fatal and must cancel the siblings rather
                    # than escape past download()'s DownloadResult
                    # contract.
                    cancelled.set()
                    if isinstance(e, _SourceFetchError):
                        raise
                    raise _SourceFetchError(
                        f"piece {number}: {type(e).__name__}: {e}"
                    ) from e
            return nbytes

        with ThreadPoolExecutor(max_workers=groups) as pool:
            futures = [pool.submit(run_group, s) for s in slices]
            total = 0
            error: Optional[_SourceFetchError] = None
            for fut in futures:
                try:
                    total += fut.result()
                except _SourceFetchError as e:
                    error = error or e
        if error is not None:
            raise error
        return total

    def _fail(self, peer: Peer, t0: float, reason: str) -> DownloadResult:
        self.scheduler.report_peer_failed(peer)
        return DownloadResult(
            ok=False,
            task_id=peer.task.id,
            peer_id=peer.id,
            cost_s=time.monotonic() - t0,
        )


class StreamHandle:
    """A started (or reused) stream task: sizing metadata now, bytes as
    pieces commit (peertask_manager.go StartStreamTask's ReadCloser +
    attribute map).

    With a registered :class:`TeeConsumer` (the default for live runs),
    ``chunks`` serves each piece from the commit tee — ZERO disk reads
    on the fast path; the disk is only touched for cache-hit replays
    (``run is None``), pieces committed before this handle registered,
    and slow-reader spills.  ``start``/``length`` narrow the handle to a
    byte window (the ranged-stream serving half; the scheduling half is
    the run's range hint).
    """

    def __init__(
        self,
        conductor: Conductor,
        task_id: str,
        run: Optional[TaskRun],
        *,
        consumer: Optional[TeeConsumer] = None,
        start: int = 0,
        length: Optional[int] = None,
    ) -> None:
        self._conductor = conductor
        self.task_id = task_id
        self._run = run  # None → completed on disk (pure reuse)
        self._consumer = consumer
        storage = conductor.storage
        if run is None:
            self.content_length = storage.content_length(task_id)
            self.piece_size = storage.piece_size(task_id)
            self.n_pieces = max(storage.n_pieces(task_id), 0)
            self.reused = True
        else:
            self.content_length = run.content_length
            self.piece_size = run.piece_size
            self.n_pieces = run.n_pieces
            self.reused = False
        # Byte window, clamped to the sized representation.
        self.start = max(0, start)
        if self.content_length >= 0:
            self.start = min(self.start, self.content_length)
            end = (
                self.content_length
                if length is None
                else min(self.start + max(length, 0), self.content_length)
            )
        else:
            end = -1 if length is None else self.start + max(length, 0)
        self.end = end  # exclusive; -1 → to EOF of an unsized stream
        # Serve-plane evidence for the zero-disk-read witness.
        self.tee_hits = 0
        self.disk_reads = 0

    def close(self) -> None:
        """Detach the tee consumer (released buffers, no more offers).
        ``chunks`` closes automatically at exhaustion or generator
        close; callers that never iterate must close explicitly."""
        if self._consumer is not None:
            self._consumer.close()

    def narrow(self, start: int, end: int) -> "StreamHandle":
        """Late-bound byte window (``end`` exclusive) for callers that
        only learned the representation length from this stream's own
        sizing (e.g. a Range request for an origin that won't answer a
        length probe).  Registers the range hint with the live run —
        best-effort priority: pieces already queued keep their order."""
        self.start = max(0, start)
        if self.content_length >= 0:
            self.start = min(self.start, self.content_length)
            self.end = min(end, self.content_length)
        else:
            self.end = end
        if self._run is not None:
            self._run.add_range_hint(self.start, max(self.end - self.start, 0))
        return self

    def __enter__(self) -> "StreamHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _piece_window(self) -> range:
        """Piece numbers overlapping the byte window, in serve order."""
        if self.n_pieces <= 0:
            return range(0)
        ps = self.piece_size
        if ps <= 0:
            return range(self.n_pieces)
        first = self.start // ps
        if self.end < 0:
            return range(min(first, self.n_pieces), self.n_pieces)
        if self.end <= self.start:
            return range(0)
        last = (self.end - 1) // ps
        return range(min(first, self.n_pieces), min(last + 1, self.n_pieces))

    def chunks(self, *, piece_timeout_s: float = 60.0) -> Iterator[bytes]:
        """Yield the handle's byte window piece by piece, IN ORDER,
        waiting for pieces that have not committed yet.  Raises IOError
        when the underlying download fails or a piece times out.  The
        generator owns the tee consumer: it detaches at exhaustion or
        close, so an abandoned response can't pin tee buffers."""
        try:
            for number in self._piece_window():
                data = self._one_piece(number, piece_timeout_s)
                if data is None:
                    return  # eof on a shrunken run
                data = self._clip(number, data)
                if data:
                    yield data
        finally:
            self._finish_stream()

    def _one_piece(self, number: int, piece_timeout_s: float) -> Optional[bytes]:
        if self._run is not None:
            status = self._run.wait_piece(number, piece_timeout_s)
            if status == "failed":
                raise IOError(f"stream {self.task_id}: download failed")
            if status == "timeout":
                raise IOError(
                    f"stream {self.task_id}: piece {number} timed out"
                )
            if status == "eof":
                return None
        if self._consumer is not None:
            data = self._consumer.take(number)
            if data is not None:
                self.tee_hits += 1
                return data
        self.disk_reads += 1
        return self._conductor.storage.read_piece(self.task_id, number)

    def _clip(self, number: int, data: bytes) -> bytes:
        """Trim a piece body to the handle's byte window + EOF."""
        ps = self.piece_size
        total = self.content_length
        base = number * ps if ps > 0 else 0
        lo = max(self.start - base, 0)
        hi = len(data)
        if total >= 0 and ps > 0:
            hi = min(hi, max(total - base, 0))
        if self.end >= 0:
            hi = min(hi, max(self.end - base, 0))
        return data[lo:hi] if (lo > 0 or hi < len(data)) else data

    def _finish_stream(self) -> None:
        """Detach the consumer and record the serve on the download's
        trace: one `daemon/stream` span carrying the traceparent the
        run's download span injected, so a pass-through serve is visible
        on the SAME trace as the swarm transfer that fed it."""
        consumer = self._consumer
        self._consumer = None
        if consumer is not None:
            consumer.close()
        from ..utils.tracing import default_tracer

        traceparent = self._run.traceparent if self._run is not None else None
        with default_tracer.remote_span(
            "daemon/stream",
            traceparent,
            task_id=self.task_id,
            start=self.start,
            tee_hits=self.tee_hits,
            disk_reads=self.disk_reads,
            reused=self.reused,
        ):
            pass

    def read_all(self, *, piece_timeout_s: float = 60.0) -> bytes:
        return b"".join(self.chunks(piece_timeout_s=piece_timeout_s))

    def result(self) -> Optional[DownloadResult]:
        """The underlying run's final result (None while running, or for
        pure-reuse handles that never ran a download)."""
        return self._run.result if self._run is not None else None

    def wait_result(self, *, timeout_s: float = 30.0) -> Optional[DownloadResult]:
        """Block for the run's FINAL result — chunks() drains at the last
        piece commit, moments before the run finishes (reports, advertise),
        so immediate result() reads race None."""
        if self._run is None:
            return None
        return self._run.wait_done(timeout_s)
