"""Shadow scoring: re-rank a sampled slice of announces with a candidate
model, off the announce hot path.

Port of ``dragonfly2_tpu/rollout/shadow.py``, numpy verbatim.  With
``log_path`` the replay log is a DFC1 file over ``SHADOW_COLUMNS``
(a resume starts ``announce_seq`` past every logged row); without it
the log lives in memory.

The serving path already paid for everything a candidate evaluation
needs: ``MLEvaluator._featurize_batch`` built the feature matrix out of
``HostFeatureCache`` rows and the active scorer produced its scores.
``ShadowScorer.offer`` takes exactly those arrays — zero extra
featurization — so shadow mode's marginal cost is one deterministic
hash draw, one bounded-queue append, and (on a worker thread) one
candidate forward pass per sampled announce.

Hot-path contract:

- **deterministic sampling** — announce N of child C is sampled iff
  ``crc32(f"{C}:{n}") % 10000 < rate*10000`` where ``n`` is this
  shadow's own offer counter: replaying the same announce sequence
  shadows the same announces, whatever the thread interleaving did to
  wall time (same coin style as utils/faultinject.py).
- **never blocks, never fails an announce** — the queue is bounded;
  when the worker falls behind, offers are *dropped* (counted), and any
  exception inside ``offer`` is caught and counted.  The arrays handed
  in are the evaluator's freshly-built private copies, safe to score on
  another thread.

The worker scores the candidate on the same rows, computes both
rankings, appends one row per candidate edge to a columnar **replay
log** (records/columnar.py — the same fixed-width format the trainer
ingests), and folds the feature rows into per-feature drift histograms
against the training-snapshot bin stats stamped into the candidate blob
by trainer/export.py (``psi()`` reads them out).
"""

from __future__ import annotations

import itertools
import logging
import threading
import zlib
from collections import deque
from typing import List, Optional

import numpy as np

from ..scheduler import metrics as sched_metrics

logger = logging.getLogger(__name__)

# One replay-log row per candidate edge of a shadowed announce.  All
# values are float32-exact: buckets < 2^20, ranks/counts small ints,
# the digest is folded to 24 bits.
SHADOW_COLUMNS = (
    "announce_seq",
    "candidate_version",
    "active_version",
    "src_bucket",
    "dst_bucket",
    "feature_digest",
    "active_score",
    "candidate_score",
    "active_rank",
    "candidate_rank",
)

_SAMPLE_MOD = 10_000


def sampled(child_id: str, seq: int, rate: float) -> bool:
    """The deterministic shadow coin (exposed for tests/bench)."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = zlib.crc32(f"{child_id}:{seq}".encode("utf-8"))
    return h % _SAMPLE_MOD < int(rate * _SAMPLE_MOD)


def feature_digest(feats: np.ndarray, src_buckets: np.ndarray) -> float:
    """24-bit content digest of the scored inputs (float32-exact); lets
    replay tooling detect featurization skew between log and re-run."""
    base = feats if feats.size else np.ascontiguousarray(src_buckets)
    return float(zlib.crc32(np.ascontiguousarray(base).tobytes()) & 0xFFFFFF)


class _Sample:
    __slots__ = ("seq", "feats", "src", "dst", "active_scores")

    def __init__(self, seq, feats, src, dst, active_scores) -> None:
        self.seq = seq
        self.feats = feats
        self.src = src
        self.dst = dst
        self.active_scores = active_scores


class ShadowScorer:
    """Candidate-vs-active comparison engine for one candidate version.

    Immutable per candidate: a new candidate version gets a NEW
    ShadowScorer (the subscriber swaps the whole object atomically),
    so the worker never races a scorer swap mid-sample.
    """

    def __init__(
        self,
        candidate,
        *,
        candidate_version: int,
        active_version: int = 0,
        sample_rate: float = 0.1,
        log_path: Optional[str] = None,
        max_queue: int = 256,
        max_memory_rows: int = 200_000,
        batch_linger_s: float = 0.02,
    ) -> None:
        self.candidate = candidate
        self.candidate_version = int(candidate_version)
        self.active_version = int(active_version)
        self.sample_rate = float(sample_rate)
        self.log_path = log_path
        self.max_queue = int(max_queue)
        self._max_memory_rows = int(max_memory_rows)
        # How long the worker lets samples pile up after the first one
        # before draining: bigger batches mean fewer GIL-held scoring
        # segments stealing announce throughput; shadow is off the hot
        # path, so 20 ms of staleness is free.
        self.batch_linger_s = float(batch_linger_s)
        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._stopped = False
        self._idle = threading.Event()
        self._idle.set()
        # The announce sequence: itertools.count is C-implemented and
        # GIL-atomic, so the 90 %-unsampled offer path draws a UNIQUE
        # seq without touching any lock (a per-announce cv acquire +
        # metric inc is lock contention on the announce path).
        self._seq = itertools.count()
        # ``offered``/``sampled_out`` are observability counters bumped
        # lock-free on the hot path: a preemption between load and store
        # can rarely lose an increment, which is acceptable for counts
        # that gate nothing (replay seqs come from _seq, never these).
        # scored/dropped/errors/logged mutate under _cv (low-rate paths).
        self.offered = 0
        self.scored_announces = 0
        self.sampled_out = 0
        self.dropped = 0
        self.errors = 0
        self.logged_rows = 0
        self._sampled_out_pushed = 0  # prometheus high-water (stats())
        # In-memory replay rows when no log_path (tests, embedded runs).
        self._rows: List[np.ndarray] = []
        self._writer = None
        if log_path is not None:
            import os

            from ..records.columnar import ColumnarReader, ColumnarWriter

            if os.path.exists(log_path) and os.path.getsize(log_path) > 0:
                # Resuming onto an existing log (scheduler restart,
                # shadow re-attach): start the offer counter past every
                # logged announce_seq so replay groups stay unique.
                # (Read BEFORE the writer opens — its header write is
                # buffered until the first flush.)
                existing = ColumnarReader(log_path)
                if len(existing):
                    start = int(existing.to_array()[:, 0].max()) + 1
                    self._seq = itertools.count(start)
                    self.offered = start
            self._writer = ColumnarWriter(log_path, SHADOW_COLUMNS)
        # Drift accounting against the candidate's training snapshot
        # (trainer/export.py stamps bin edges + expected fractions).
        edges = getattr(candidate, "train_bin_edges", None)
        fracs = getattr(candidate, "train_bin_fracs", None)
        if edges is not None and fracs is not None and len(edges):
            self._bin_edges = np.asarray(edges, np.float64)
            self._bin_fracs = np.asarray(fracs, np.float64)
            self._bin_counts = np.zeros_like(self._bin_fracs, dtype=np.int64)
        else:
            self._bin_edges = self._bin_fracs = self._bin_counts = None
        self._thread = threading.Thread(
            target=self._worker, name="shadow-scorer", daemon=True
        )
        self._thread.start()

    # -- the hot-path surface (called from MLEvaluator.evaluate_parents) -----

    def offer(self, child_id, feats, src_buckets, dst_buckets, active_scores) -> bool:
        """Maybe enqueue one announce's already-built serving arrays for
        shadow evaluation.  Returns True when the announce was sampled
        AND queued.  Never raises, never blocks — and the (common)
        sampled-out path is LOCK-FREE: one atomic seq draw, one crc, two
        racy counter bumps; prometheus totals batch-sync in stats()."""
        try:
            seq = next(self._seq)
            self.offered += 1
            if not sampled(child_id, seq, self.sample_rate):
                self.sampled_out += 1
                return False
            with self._cv:
                if self._stopped or len(self._queue) >= self.max_queue:
                    self.dropped += 1
                    sched_metrics.SHADOW_ANNOUNCES_TOTAL.inc(result="dropped")
                    return False
                self._queue.append(
                    _Sample(seq, feats, src_buckets, dst_buckets, active_scores)
                )
                self._idle.clear()
                self._cv.notify()
            return True
        except Exception:  # noqa: BLE001 — shadow must never fail an announce
            logger.exception("shadow offer failed")
            with self._cv:
                self.errors += 1
            sched_metrics.SHADOW_ANNOUNCES_TOTAL.inc(result="error")
            return False

    # -- worker ---------------------------------------------------------------

    def _worker(self) -> None:
        import time

        while True:
            with self._cv:
                while not self._queue and not self._stopped:
                    self._idle.set()
                    # Bounded wait + loop: offers
                    # still wake the worker immediately; the timeout only
                    # keeps an idle drain visible to watchdog stack dumps.
                    self._cv.wait(30.0)
                if not self._queue and self._stopped:
                    self._idle.set()
                    return
            # Bounded linger OUTSIDE the lock: let concurrent announces
            # pile onto the queue so one drain scores many samples.
            if self.batch_linger_s > 0 and not self._stopped:
                time.sleep(self.batch_linger_s)
            with self._cv:
                # Drain the WHOLE queue per wake-up: under announce load
                # the candidate forward pass, drift binning and the log
                # append then run once over all pending samples — far
                # fewer GIL-held Python segments stealing time from the
                # announcer threads.
                samples = list(self._queue)
                self._queue.clear()
                if not samples:
                    continue
            try:
                rows = self._score_batch(samples)
                self._log_rows(rows)
                with self._cv:
                    self.scored_announces += len(samples)
                    self.logged_rows += rows.shape[0]
                sched_metrics.SHADOW_ANNOUNCES_TOTAL.inc(
                    len(samples), result="scored"
                )
            except Exception:  # noqa: BLE001 — one bad batch must not kill the worker
                logger.exception("shadow scoring failed")
                with self._cv:
                    self.errors += len(samples)
                sched_metrics.SHADOW_ANNOUNCES_TOTAL.inc(
                    len(samples), result="error"
                )

    def _score_batch(self, samples: List[_Sample]) -> np.ndarray:
        """Score a drain's worth of announces in ONE candidate call.
        Safe per the batched-score contract (trainer/export.py
        EdgeScorer): every row scores from that row alone, so rows from
        unrelated announces cannot bleed into each other — the same
        property ScorerBatcher relies on."""
        if len(samples) == 1:
            s = samples[0]
            return self._assemble_rows(
                s,
                np.asarray(
                    self.candidate.score(
                        s.feats, src_buckets=s.src, dst_buckets=s.dst
                    ),
                    dtype=np.float64,
                ),
                drift_feats=s.feats,
            )
        widths = {s.feats.shape[1] for s in samples}
        if len(widths) != 1:
            # Mixed feature widths (scorer-family swap mid-queue): rare
            # enough to score per sample.
            return np.concatenate(
                [self._score_batch([s]) for s in samples], axis=0
            )
        k = len(samples)
        feats = np.concatenate([s.feats for s in samples], axis=0)
        src = np.concatenate([np.asarray(s.src) for s in samples])
        dst = np.concatenate([np.asarray(s.dst) for s in samples])
        cand_scores = np.asarray(
            self.candidate.score(feats, src_buckets=src, dst_buckets=dst),
            dtype=np.float64,
        )
        active_scores = np.concatenate(
            [np.asarray(s.active_scores, dtype=np.float64) for s in samples]
        )
        lens = np.fromiter((len(s.active_scores) for s in samples), np.int64, k)
        groups = np.repeat(np.arange(k), lens)
        starts = np.zeros(k, dtype=np.int64)
        starts[1:] = np.cumsum(lens)[:-1]
        n_total = len(active_scores)
        pos = np.arange(n_total, dtype=np.int64)

        def ranks(scores: np.ndarray) -> np.ndarray:
            # Per-announce rank positions in ONE stable lexsort over the
            # whole drain (same stable-tie order as the per-sample
            # argsort(kind="stable") the serving path uses).
            order = np.lexsort((-scores, groups))
            r = np.empty(n_total, dtype=np.int64)
            r[order] = pos - starts[groups[order]]
            return r

        out = np.empty((n_total, len(SHADOW_COLUMNS)), dtype=np.float32)
        out[:, 0] = np.repeat(
            np.fromiter((s.seq for s in samples), np.float64, k), lens
        )
        out[:, 1] = float(self.candidate_version)
        out[:, 2] = float(self.active_version)
        out[:, 3] = src
        out[:, 4] = dst
        out[:, 5] = np.repeat(
            np.fromiter(
                (feature_digest(s.feats, s.src) for s in samples),
                np.float64, k,
            ),
            lens,
        )
        out[:, 6] = active_scores
        out[:, 7] = cand_scores
        out[:, 8] = ranks(active_scores)
        out[:, 9] = ranks(cand_scores)
        self._accumulate_drift(feats)
        return out

    def _assemble_rows(
        self, sample: _Sample, cand_scores: np.ndarray, *, drift_feats
    ) -> np.ndarray:
        active_scores = np.asarray(sample.active_scores, dtype=np.float64)
        n = len(active_scores)
        # rank[i] = position of edge i in the arm's ordering (0 = best),
        # stable ties like the serving argsort.
        active_rank = np.empty(n, dtype=np.int64)
        active_rank[np.argsort(-active_scores, kind="stable")] = np.arange(n)
        cand_rank = np.empty(n, dtype=np.int64)
        cand_rank[np.argsort(-cand_scores, kind="stable")] = np.arange(n)
        out = np.empty((n, len(SHADOW_COLUMNS)), dtype=np.float32)
        out[:, 0] = float(sample.seq)
        out[:, 1] = float(self.candidate_version)
        out[:, 2] = float(self.active_version)
        out[:, 3] = np.asarray(sample.src, dtype=np.float64)
        out[:, 4] = np.asarray(sample.dst, dtype=np.float64)
        out[:, 5] = feature_digest(sample.feats, sample.src)
        out[:, 6] = active_scores
        out[:, 7] = cand_scores
        out[:, 8] = active_rank
        out[:, 9] = cand_rank
        if drift_feats is not None:
            self._accumulate_drift(drift_feats)
        return out

    def _accumulate_drift(self, feats: np.ndarray) -> None:
        if self._bin_edges is None or not feats.size:
            return
        if getattr(self.candidate, "post_hoc_masked", False):
            # The snapshot stats were computed over rows prepared exactly
            # as trained (post-hoc columns zeroed) — bin the served rows
            # under the same mask or those columns read as pure drift.
            from ..records.features import mask_post_hoc

            feats = mask_post_hoc(feats)
        d = min(feats.shape[1], self._bin_edges.shape[0])
        fresh = np.zeros_like(self._bin_counts)
        for j in range(d):  # per-FEATURE (32 fixed), worker thread only
            idx = np.searchsorted(
                self._bin_edges[j, 1:-1], feats[:, j].astype(np.float64)
            )
            fresh[j] = np.bincount(idx, minlength=fresh.shape[1])
        with self._cv:
            self._bin_counts += fresh

    def _log_rows(self, rows: np.ndarray) -> None:
        if self._writer is not None:
            self._writer.append(rows)
            self._writer.flush()
            return
        with self._cv:
            self._rows.append(rows)
            # Bounded memory: drop the OLDEST rows past the cap.
            total = sum(r.shape[0] for r in self._rows)
            while total > self._max_memory_rows and len(self._rows) > 1:
                total -= self._rows.pop(0).shape[0]

    # -- read side (reporter / tests) ----------------------------------------

    def replay_rows(self) -> np.ndarray:
        """Every logged row as one array (memory mode) or the log file's
        contents (disk mode — readable after ``close`` too)."""
        if self.log_path is not None:
            from ..records.columnar import ColumnarReader

            return ColumnarReader(self.log_path).to_array()
        with self._cv:
            rows = list(self._rows)
        if not rows:
            return np.zeros((0, len(SHADOW_COLUMNS)), dtype=np.float32)
        out = np.zeros(
            (sum(r.shape[0] for r in rows), len(SHADOW_COLUMNS)), np.float32
        )
        off = 0
        for r in rows:  # shard reassembly, not per-item growth
            out[off : off + r.shape[0]] = r
            off += r.shape[0]
        return out

    def psi(self) -> Optional[np.ndarray]:
        """Per-feature Population Stability Index of served features vs
        the candidate's training snapshot; None when the blob carries no
        snapshot (old artifacts, identity-only scorers)."""
        if self._bin_edges is None:
            return None
        with self._cv:
            counts = self._bin_counts.astype(np.float64).copy()
        totals = counts.sum(axis=1, keepdims=True)
        if not totals.any():
            return np.zeros(counts.shape[0])
        eps = 1e-4
        observed = np.maximum(counts / np.maximum(totals, 1.0), eps)
        expected = np.maximum(self._bin_fracs, eps)
        return ((observed - expected) * np.log(observed / expected)).sum(axis=1)

    def stats(self) -> dict:
        with self._cv:
            # Batch-sync the hot-path sampled_out count into prometheus
            # (the per-announce inc was measurable lock contention).
            delta = self.sampled_out - self._sampled_out_pushed
            if delta > 0:
                sched_metrics.SHADOW_ANNOUNCES_TOTAL.inc(
                    delta, result="sampled_out"
                )
                self._sampled_out_pushed = self.sampled_out
            out = {
                "candidate_version": self.candidate_version,
                "active_version": self.active_version,
                "sample_rate": self.sample_rate,
                "offered": self.offered,
                "scored_announces": self.scored_announces,
                "sampled_out": self.sampled_out,
                "dropped": self.dropped,
                "errors": self.errors,
                "logged_rows": self.logged_rows,
            }
        psi = self.psi()
        out["psi_max"] = float(psi.max()) if psi is not None and psi.size else None
        return out

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait until every queued sample has been scored (reporter
        flush point before evaluation reads the log)."""
        return self._idle.wait(timeout)

    def close(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout=10.0)
        if self._writer is not None:
            self._writer.close()
            self._writer = None
