"""Piece data-plane pipeline: overlapped commit, batched reports, hedged
straggler fetch (DESIGN.md §22).

The conductor's piece workers used to run strictly sequential per piece:
fetch → digest+write → report RPC → next fetch.  Three helpers break the
serialization without changing any correctness contract:

- :class:`CommitPipeline` — a bounded hand-off queue + one committer
  thread per download: the worker fetches piece N+1 while piece N is
  digested (crc at write), written, marked ready and queued for report.
  A commit failure aborts the download exactly like an inline failure
  (submit starts returning False; the error surfaces at ``close``).

- :class:`PieceReportBatcher` — coalesces ``report_piece_finished`` RPCs
  into bounded-linger ``report_pieces_finished`` batches (one wire call
  per flush).  Schedulers without the batch method degrade to per-piece
  calls.  ``close()`` flushes, so every piece report lands BEFORE the
  closing ``report_peer_finished``, preserving the scheduler FSM's
  observable order (DF013/DF015 stay green).

- :class:`PieceLatencyTracker` + :func:`hedged_fetch` — per-download
  rolling fetch latencies derive a p99-based hedge threshold; a piece
  exceeding it races a second parent through the SAME fetch path (so
  retry/CircuitBreaker machinery applies to both arms).  First VALID
  body wins; the loser's body is discarded (its socket drains back to
  the pool or is dropped on error) and only the winner reaches the
  commit path — one commit per piece, by construction and by drill.

- :class:`CommitTee` — the pass-through read plane (DESIGN.md §25).
  The committer PUBLISHES each verified piece body to every registered
  stream consumer alongside the disk write, so the proxy / object
  gateway serve bytes straight from the commit path instead of reading
  them back off the disk they were written to a microsecond earlier.
  Buffers are refcounted across consumers; each consumer's buffer depth
  is bounded, and a slow reader SPILLS (its pieces degrade to the disk
  path) instead of backpressuring the committer — a stalled proxy
  client can never wedge the download.  The tee is an optimization over
  a durable source of truth: any delivery failure degrades to the disk
  read, never to a download failure.

Port of ``dragonfly2_tpu/daemon/piece_pipeline.py``, verbatim.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.metrics import default_registry as _reg

logger = logging.getLogger(__name__)

# Registered on the process-default registry (DF017: once, at module
# scope) so the metric journal snapshots them alongside the sketches —
# pre-§23 these were free-floating Counter instances invisible to
# /metrics and the journal.
PIECE_HEDGE_TOTAL = _reg.counter(
    "daemon_piece_hedge_total",
    "Hedged piece fetches by outcome (fired = second arm launched; "
    "won = the hedge arm's body was committed)",
    ("outcome",),
)

REPORT_BATCH_TOTAL = _reg.counter(
    "daemon_piece_report_batches_total",
    "Piece-report flushes by kind (batched = one report_pieces_finished "
    "RPC; fallback = per-piece calls, scheduler has no batch method)",
    ("kind",),
)

# Fleet telemetry sketches (DESIGN.md §23): the per-piece latency tail
# and the report-batch linger, journaled crash-safe and merged
# fleet-wide by tools/fleet_assemble.py — fixed-bucket histograms lose
# exactly the tail these carry.
PIECE_FETCH_SECONDS = _reg.sketch(
    "daemon_piece_fetch_seconds",
    "Per-piece fetch wall latency (hedge-plan baseline samples)",
)
REPORT_LINGER_SECONDS = _reg.sketch(
    "daemon_report_linger_seconds",
    "Piece-report batch linger: first enqueue to flush dispatch",
)

# Pass-through read plane (DESIGN.md §25): every published piece is
# either DELIVERED into a consumer's bounded buffer (served with zero
# disk reads) or SPILLED (slow/closed consumer — the piece degrades to
# the disk path).  The zero-disk-read witness and the stream bench read
# these to prove which plane actually served.
STREAM_TEE_TOTAL = _reg.counter(
    "daemon_stream_tee_pieces_total",
    "Commit-tee piece offers by outcome (delivered = buffered for a "
    "consumer; spilled = bounded buffer full or consumer closed — the "
    "piece is served from disk instead)",
    ("outcome",),
)


def _not_found_class(exc: BaseException) -> bool:
    """Typed NOT_FOUND (the wire's unknown-method answer — also unknown
    peer, which the per-piece fallback re-raises anyway, so branching on
    the code alone is safe-by-retry)."""
    code = getattr(exc, "code", None)
    if code is None:
        return False
    try:
        from ..utils.dferrors import Code

        return int(code) == int(Code.NOT_FOUND)
    except (TypeError, ValueError):
        return False


class CommitPipeline:
    """Digest piece N while piece N+1 is on the wire.

    ``commit_fn(number, data, parent_id, cost_ns)`` runs on ONE committer
    thread (daemon) in submission order; the bounded queue (``depth``)
    backpressures workers when storage falls behind so memory stays
    O(depth × piece_size).  First commit error latches: ``submit``
    returns False from then on and ``close()`` returns the error.
    """

    def __init__(
        self,
        commit_fn: Callable[[int, bytes, str, int], None],
        *,
        depth: int = 4,
        name: str = "piece-commit",
    ) -> None:
        self._commit = commit_fn
        self._depth = max(1, depth)
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._pending: deque = deque()
        self._closed = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True
        )
        self._thread.start()

    @property
    def error(self) -> Optional[BaseException]:
        with self._mu:
            return self._error

    def submit(self, number: int, data: bytes, parent_id: str, cost_ns: int) -> bool:
        """Queue one fetched piece for commit; blocks while the queue is
        full (backpressure).  False → the pipeline failed or closed, the
        caller must abort its download."""
        with self._cv:
            while (
                len(self._pending) >= self._depth
                and self._error is None
                and not self._closed
            ):
                self._cv.wait(0.05)
            if self._error is not None or self._closed:
                return False
            self._pending.append((number, data, parent_id, cost_ns))
            self._cv.notify_all()
        return True

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait(0.05)
                if not self._pending:
                    return  # closed and drained
                item = self._pending.popleft()
                self._cv.notify_all()
            try:
                self._commit(*item)
            except BaseException as exc:  # noqa: BLE001 — latched for close()
                logger.warning(
                    "piece commit failed (piece %d)", item[0], exc_info=True
                )
                with self._cv:
                    self._error = exc
                    self._pending.clear()
                    self._closed = True
                    self._cv.notify_all()
                return

    def close(self) -> Optional[BaseException]:
        """Drain remaining commits, stop the committer, return the first
        error (None = every submitted piece committed)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        while self._thread.is_alive():
            self._thread.join(5.0)
        with self._mu:
            return self._error


class PieceReportBatcher:
    """Bounded-linger coalescing of per-piece finished reports.

    Reports accumulate for up to ``linger_s`` (or ``max_batch`` items)
    and flush as ONE ``report_pieces_finished`` call when the scheduler
    offers it, else per-piece ``report_piece_finished`` calls.  A flush
    failure latches (``error``) — the conductor treats it exactly like an
    inline report failure.  ``close()`` performs the final flush so piece
    reports always precede ``report_peer_finished``.
    """

    def __init__(
        self,
        scheduler,
        peer,
        *,
        linger_s: float = 0.02,
        max_batch: int = 64,
        name: str = "piece-report-batch",
        traceparent: Optional[str] = None,
    ) -> None:
        self._scheduler = scheduler
        self._peer = peer
        # The flush thread has an empty span stack; the download span's
        # context rides in so the report RPCs (and their server handler
        # spans) stay in the download's trace.
        self._traceparent = traceparent
        self._linger_s = linger_s
        self._max_batch = max(1, max_batch)
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._items: List[Tuple[int, str, int, int]] = []
        self._first_ts = 0.0
        self._closed = False
        self._batch_unsupported = False
        self._error: Optional[BaseException] = None
        self.flushes = 0
        self.reported = 0
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True
        )
        self._thread.start()

    @property
    def error(self) -> Optional[BaseException]:
        with self._mu:
            return self._error

    def submit(self, number: int, parent_id: str, length: int, cost_ns: int) -> bool:
        with self._cv:
            if self._error is not None or self._closed:
                return False
            if not self._items:
                # First report of this batch: the linger clock starts
                # here (REPORT_LINGER_SECONDS measures enqueue → flush).
                self._first_ts = time.monotonic()
            self._items.append((number, parent_id, length, cost_ns))
            self._cv.notify_all()
        return True

    def _take_batch(self) -> Optional[List[Tuple[int, str, int, int]]]:
        """Linger until a batch is worth flushing (or close); None → done."""
        with self._cv:
            while not self._items and not self._closed:
                self._cv.wait(0.05)
            if not self._items:
                return None
            if not self._closed and len(self._items) < self._max_batch:
                # Bounded linger: let trailing reports coalesce.
                deadline = time.monotonic() + self._linger_s
                while (
                    len(self._items) < self._max_batch
                    and not self._closed
                ):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(left)
            batch = self._items[: self._max_batch]
            del self._items[: len(batch)]
            linger = time.monotonic() - self._first_ts
            if self._items:
                # Remainder starts a fresh linger window now.
                self._first_ts = time.monotonic()
        # Observe OUTSIDE the cv (sketch lock never nests under batcher
        # state): the fleet-mergeable record of how long reports waited
        # to coalesce — the knob `linger_s` bounds, now measurable.
        REPORT_LINGER_SECONDS.observe(linger)
        return batch

    def _flush(self, batch: List[Tuple[int, str, int, int]]) -> None:
        from ..utils import faultinject
        from ..utils.tracing import default_tracer

        # Chaos seam for the batched-report plane: a drop here is a lost
        # flush — the conductor must fail the download loudly, exactly
        # like a dropped per-piece report.
        faultinject.fire("daemon.report.batch")
        with default_tracer.remote_span(
            "daemon/report.flush", self._traceparent, reports=len(batch)
        ):
            self._flush_calls(batch)

    def _flush_calls(self, batch: List[Tuple[int, str, int, int]]) -> None:
        batch_fn = (
            None
            if self._batch_unsupported
            else getattr(self._scheduler, "report_pieces_finished", None)
        )
        if batch_fn is not None:
            try:
                batch_fn(
                    self._peer,
                    [
                        {
                            "number": n,
                            "parent_id": pid,
                            "length": length,
                            "cost_ns": cost_ns,
                        }
                        for n, pid, length, cost_ns in batch
                    ],
                )
            except Exception as exc:
                # N-1 wire skew (DESIGN.md §10d): a pre-batch scheduler
                # answers NOT_FOUND for the unknown method — degrade to
                # per-piece reports for the rest of this download.  Any
                # other failure is a real report failure and latches.
                if not _not_found_class(exc):
                    raise
                logger.info(
                    "scheduler lacks report_pieces_finished; "
                    "falling back to per-piece reports"
                )
                self._batch_unsupported = True
                for n, pid, length, cost_ns in batch:
                    self._scheduler.report_piece_finished(
                        self._peer, n, parent_id=pid, length=length,
                        cost_ns=cost_ns,
                    )
                REPORT_BATCH_TOTAL.inc(kind="fallback")
                with self._mu:
                    self.flushes += 1
                    self.reported += len(batch)
                return
            REPORT_BATCH_TOTAL.inc(kind="batched")
        else:
            for n, pid, length, cost_ns in batch:
                self._scheduler.report_piece_finished(
                    self._peer, n, parent_id=pid, length=length,
                    cost_ns=cost_ns,
                )
            REPORT_BATCH_TOTAL.inc(kind="fallback")
        with self._mu:
            self.flushes += 1
            self.reported += len(batch)

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                self._flush(batch)
            except BaseException as exc:  # noqa: BLE001 — latched for close()
                logger.warning(
                    "piece report flush failed (%d reports)", len(batch),
                    exc_info=True,
                )
                with self._cv:
                    self._error = exc
                    self._items.clear()
                    self._closed = True
                    self._cv.notify_all()
                return

    def close(self) -> Optional[BaseException]:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        while self._thread.is_alive():
            self._thread.join(5.0)
        with self._mu:
            return self._error


class PieceLatencyTracker:
    """Rolling per-download piece fetch latencies → hedge threshold.

    The threshold is p99 of the observed samples times ``multiplier``
    (floored at ``floor_s`` so a fast LAN never hedges on micro-jitter),
    and only exists once ``min_samples`` fetches have been observed —
    hedging needs evidence of what "normal" looks like before calling
    anything a straggler.
    """

    def __init__(
        self,
        *,
        min_samples: int = 16,
        floor_s: float = 0.05,
        multiplier: float = 1.5,
        maxlen: int = 512,
    ) -> None:
        self.min_samples = max(2, min_samples)
        self.floor_s = floor_s
        self.multiplier = multiplier
        self._mu = threading.Lock()
        self._samples: deque = deque(maxlen=maxlen)

    def observe(self, latency_s: float) -> None:
        # One sketch observe per fetch (outside this tracker's lock):
        # the fleet-mergeable record of the same sample the hedge
        # threshold derives from.
        PIECE_FETCH_SECONDS.observe(latency_s)
        with self._mu:
            self._samples.append(latency_s)

    def threshold_s(self) -> Optional[float]:
        with self._mu:
            n = len(self._samples)
            if n < self.min_samples:
                return None
            ordered = sorted(self._samples)
        p99 = ordered[min(int(n * 0.99), n - 1)]
        return max(p99 * self.multiplier, self.floor_s)


def hedged_fetch(
    fetch: Callable[[str], bytes],
    validate: Callable[[bytes], bool],
    primary: str,
    alternate: Optional[str],
    *,
    threshold_s: Optional[float],
    wait_timeout_s: float = 60.0,
) -> Tuple[bytes, str, bool]:
    """Fetch with a straggler hedge: run ``fetch(primary)``; if no result
    lands within ``threshold_s``, race ``fetch(alternate)`` and take the
    first VALID body → ``(data, winner_parent, hedge_fired)``.

    - ``threshold_s`` None (not enough latency evidence) or no alternate
      → plain primary fetch, errors propagate untouched.
    - A fast primary FAILURE is not a straggler: it propagates so the
      conductor's report/reschedule path runs (the hedge is for slowness,
      not for dead parents — the breaker owns those).
    - The losing arm's body is discarded; its thread drains the response
      and returns the pooled connection.  Nothing downstream ever sees
      two bodies for one piece.
    """
    if threshold_s is None or alternate is None:
        return fetch(primary), primary, False

    results: "queue.Queue[Tuple[str, Optional[bytes], Optional[BaseException]]]" = (
        queue.Queue()
    )

    def attempt(parent_id: str) -> None:
        try:
            data = fetch(parent_id)
            if not validate(data):
                raise IOError(f"invalid body from {parent_id}")
            results.put((parent_id, data, None))
        except BaseException as exc:  # noqa: BLE001 — carried to the chooser
            results.put((parent_id, None, exc))

    from ..utils import faultinject

    t_primary = threading.Thread(
        target=attempt, args=(primary,), name="piece-hedge-primary",
        daemon=True,
    )
    t_primary.start()
    try:
        pid, data, err = results.get(timeout=threshold_s)
    except queue.Empty:
        pid = None
        data = err = None
    if pid is not None:
        if err is not None:
            raise err
        return data, pid, False

    # Straggler: fire the hedge through the same fetch path.
    faultinject.fire("daemon.piece.hedge")
    PIECE_HEDGE_TOTAL.inc(outcome="fired")
    t_hedge = threading.Thread(
        target=attempt, args=(alternate,), name="piece-hedge-alt",
        daemon=True,
    )
    t_hedge.start()
    first_err: Optional[BaseException] = None
    for _ in range(2):
        pid, data, err = results.get(timeout=wait_timeout_s)
        if err is None:
            PIECE_HEDGE_TOTAL.inc(
                outcome="won" if pid == alternate else "primary"
            )
            return data, pid, True
        first_err = first_err or err
    PIECE_HEDGE_TOTAL.inc(outcome="error")
    assert first_err is not None
    raise first_err


# ---------------------------------------------------------------------------
# Pass-through read plane: the commit tee (DESIGN.md §25)
# ---------------------------------------------------------------------------


class RefCountedBuffer:
    """One verified piece body shared by every consumer that buffered it.

    The commit path hands the SAME bytes object to N consumers; each
    holds one reference and releases it on take/close.  When the last
    reference drops, the buffer lets go of the bytes so tee memory is
    bounded by live consumer buffers, never by publish history.
    """

    __slots__ = ("number", "_mu", "_data", "_refs")

    def __init__(self, number: int, data: bytes, refs: int) -> None:
        self.number = number
        self._mu = threading.Lock()
        self._data: Optional[bytes] = data
        self._refs = max(refs, 0)
        if self._refs == 0:
            self._data = None

    @property
    def refs(self) -> int:
        with self._mu:
            return self._refs

    @property
    def data(self) -> Optional[bytes]:
        with self._mu:
            return self._data

    def release(self) -> int:
        """Drop one reference; the last release frees the bytes."""
        with self._mu:
            if self._refs > 0:
                self._refs -= 1
            if self._refs == 0:
                self._data = None
            return self._refs


class TeeConsumer:
    """One stream reader's bounded window onto the commit tee.

    Pieces land out of order (parallel piece workers), so the buffer is
    number-addressed: ``take(number)`` pops the piece when the in-order
    reader reaches it.  The buffer never holds more than ``depth``
    pieces — an offer past the bound is a SPILL (the reader serves that
    piece from disk), which is what makes a stalled proxy client unable
    to grow tee memory or stall the committer.  State is guarded by the
    owning tee's lock (one lock for the whole tee plane).
    """

    def __init__(self, tee: "CommitTee", depth: int) -> None:
        self._tee = tee
        self.depth = max(1, depth)
        self._buffered: Dict[int, RefCountedBuffer] = {}
        self._closed = False
        self.delivered = 0
        self.spilled = 0

    def _offer(self, buf: RefCountedBuffer) -> bool:
        """Committer-side: buffer the piece or spill it.  Never blocks,
        never raises — the commit path's wall is sacred."""
        with self._tee._mu:
            if not self._closed and len(self._buffered) < self.depth:
                self._buffered[buf.number] = buf
                self.delivered += 1
                return True
            self.spilled += 1
        buf.release()
        from ..utils import faultinject

        # Slow-reader spill seam: a chaos scenario SIGKILLs here (crash
        # kind) for the mid-tee kill drill; any raising kind is absorbed
        # — the spill already happened, the disk path serves the piece.
        try:
            faultinject.fire("daemon.stream.spill")
        except Exception:  # noqa: BLE001 — spill is bookkeeping, not delivery
            logger.debug("injected fault at daemon.stream.spill", exc_info=True)
        STREAM_TEE_TOTAL.inc(outcome="spilled")
        return False

    # dflint: hotpath
    def take(self, number: int) -> Optional[bytes]:
        """Reader-side: pop piece ``number`` if the tee delivered it
        (zero disk reads), else None — the reader falls back to disk
        (spill, pre-registration commit, or cache-hit replay)."""
        with self._tee._mu:
            buf = self._buffered.pop(number, None)
        if buf is None:
            return None
        data = buf.data
        buf.release()
        return data

    def buffered_count(self) -> int:
        with self._tee._mu:
            return len(self._buffered)

    def close(self) -> None:
        """Detach from the tee: release every held buffer and stop
        receiving offers.  Idempotent; the committer may be mid-publish
        concurrently (it snapshots consumers, `_offer` re-checks)."""
        with self._tee._mu:
            if self._closed:
                return
            self._closed = True
            bufs = list(self._buffered.values())
            self._buffered.clear()
            if self in self._tee._consumers:
                self._tee._consumers.remove(self)
        for buf in bufs:
            buf.release()


class CommitTee:
    """Publish verified pieces to N registered stream consumers alongside
    the disk write (the pass-through read plane's producer half).

    Delivery is strictly best-effort over a durable fallback: a delivery
    failure (including an injected ``daemon.stream.tee`` fault) degrades
    every consumer to the disk path for that piece — it can never fail
    or slow the download beyond the bounded buffer insert.
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._consumers: List[TeeConsumer] = []
        self.published = 0

    def register(self, *, depth: int = 8) -> TeeConsumer:
        consumer = TeeConsumer(self, depth)
        with self._mu:
            self._consumers.append(consumer)
        return consumer

    def consumer_count(self) -> int:
        with self._mu:
            return len(self._consumers)

    # dflint: hotpath
    def publish(self, number: int, data: bytes) -> int:
        """Offer one verified piece to every registered consumer; returns
        how many buffered it.  No consumers → pure no-op (the common
        non-streaming download pays one lock round-trip)."""
        with self._mu:
            consumers = list(self._consumers)
        if not consumers:
            return 0
        from ..utils import faultinject

        try:
            # Tee delivery seam: an injected drop models a failed
            # delivery — consumers degrade to the disk path for this
            # piece, the download is untouched.
            faultinject.fire("daemon.stream.tee")
        except Exception:  # noqa: BLE001 — tee is best-effort over disk
            logger.debug("tee delivery faulted; piece %d spills", number)
            STREAM_TEE_TOTAL.inc(outcome="spilled")
            return 0
        buf = RefCountedBuffer(number, data, len(consumers))
        delivered = sum([c._offer(buf) for c in consumers])
        with self._mu:
            self.published += 1
        if delivered:
            STREAM_TEE_TOTAL.inc(outcome="delivered")
        return delivered
