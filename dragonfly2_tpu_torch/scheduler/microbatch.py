"""Cross-request scorer micro-batching for the scheduler serving path.

The reference reserved a Triton/KServe *batched* inference seam for the
parent evaluator (``GRPCInferenceService``, ``model.graphdef`` +
``config.pbtxt``) but never wired it; our in-process scorer was called
once per announce.  ``ScorerBatcher`` restores the batched-inference
shape without the RPC: concurrent ``score()`` calls from the RPC handler
threads coalesce into ONE padded scorer call.

Mechanics (DESIGN.md §14):

- **leader/follower coalescing** — the first thread to enqueue becomes
  the flush leader; it lingers a bounded ``linger_s`` (~1-2 ms) while
  followers pile on, then takes the whole queue in one swap.  No
  background dispatcher thread: an idle batcher costs nothing and there
  is nothing to shut down.
- **bucketed pad sizes** — for scorers that declare ``static_shapes =
  True`` (device inference backends: the fused CUDA scorer), the concatenated rows
  are zero-padded up to a fixed bucket ladder so the backend sees a
  handful of static shapes instead of a recompile per occupancy.  Plain
  numpy scorers are shape-indifferent, so they get exact-size batches —
  padding them is pure wasted compute.
- **singleton bypass** — a flush that collected exactly one request
  calls the scorer on the raw, unpadded arrays.
- **atomic hot-swap** — the scorer reference is snapshotted once per
  flush, so ``ModelSubscriber.refresh`` swapping mid-batch can never
  hand half a batch to each model version.
- **fault seam** — dispatch fires ``scheduler.eval.batch``
  (utils.faultinject).  A dropped/failed coalesced call degrades to
  per-request scoring; announces never stall on the batcher.
- **canary arms / pinned snapshots** — requests carry a ``candidate``
  flag (DESIGN.md §15 canary serving) and, when the caller resolved a
  scorer atomically with its CanaryRoute decision, the exact scorer
  snapshot (DESIGN.md §18).  A flush groups by SNAPSHOT and scores each
  group with its own scorer, so coalescing survives a canary — or a
  float→quantized rollout transition mid-linger — without ever mixing
  model versions or precisions inside one call.  A candidate
  uninstalled mid-queue pins its unpinned requests to the active
  scorer.
- **weighted-fair tenant lanes** (DESIGN.md §26) — requests queue in
  per-tenant FIFO lanes and the leader drains them with deficit round
  robin: each drain FIRST lands every backlogged lane's head request
  (on credit — the deficit goes negative, charging it against the
  lane's future share), then passes over the lanes growing each lane's
  deficit by ``quantum × weight`` and draining whole requests while
  the deficit covers their rows.  A 100-weight flood therefore cannot
  starve a 1-weight tenant (every drain serves every backlogged lane
  at least its head) while throughput still tracks the weights, and
  per-tenant arrival order is preserved (lanes are deques, head pops
  only).  Deficits carry across cap-limited flushes; a lane that
  empties resets (classic DRR).  With ONE active tenant the drain is a
  whole-queue swap — bit-equal to the pre-QoS single-queue behavior
  (the §14 oracle discipline, property-tested).  A flush past
  ``max_batch_rows`` leaves the excess queued and the leader loops
  until the lanes are dry, so followers never stall leaderless.

The scorer contract this relies on is row-independence: ``score`` must
score each row from that row (+ its buckets) alone, so padded rows and
co-batched strangers cannot bleed into each other (trainer/export.py
``EdgeScorer`` docstring — the batched-score contract).

Each coalesced scorer call opens one ``scheduler/eval.flush`` span with
``batch``, ``rows`` and ``jit_compiles``.  The reference reads
``jit_compiles`` from its recompile witness, which this package does not
have yet (ROADMAP queue 1 item 11), so it is 0 here.  The span includes
the device: the flush reads its scores back.
"""

from __future__ import annotations

import bisect
import logging
import threading
import time
from collections import OrderedDict, deque
from typing import List, Optional, Tuple

import numpy as np

from ..utils import faultinject
from ..utils.tracing import default_tracer
from . import metrics

logger = logging.getLogger(__name__)

DEFAULT_PAD_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

# DRR quantum: rows of deficit a weight-1.0 lane earns per drain pass
# (sized to a typical candidate set so one pass serves one announce).
DEFAULT_DRR_QUANTUM = 32

DEFAULT_LANE = "default"


class ScorerUnavailable(RuntimeError):
    """No scorer installed at flush time (deactivated mid-queue); the
    evaluator catches this and falls back to rule-based ranking."""


class _Request:
    __slots__ = (
        "features", "src", "dst", "candidate", "scorer", "tenant", "rows",
        "done", "result", "error",
    )

    def __init__(
        self, features, src, dst, candidate=False, scorer=None, tenant=""
    ) -> None:
        self.features = features
        self.src = src
        self.dst = dst
        # Tenant lane key (DESIGN.md §26): "" rides the default lane.
        self.tenant = tenant or DEFAULT_LANE
        self.rows = int(features.shape[0])
        # Canary arm (DESIGN.md §15): True routes this request to the
        # flush's candidate-scorer snapshot instead of the active one.
        self.candidate = candidate
        # Pinned scorer snapshot, captured by the caller ATOMICALLY with
        # its CanaryRoute decision (DESIGN.md §18): a rollout transition
        # mid-linger (float → quantized candidate swap) must never score
        # this request with a different snapshot than the one its route
        # decision saw, and requests pinned to different snapshots must
        # never share one coalesced call.  None = use the flush snapshot
        # (legacy behavior, also what pins a candidate-gone request to
        # the active scorer).
        self.scorer = scorer
        self.done = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class ScorerBatcher:
    """EdgeScorer wrapper: same ``score`` surface, coalesced execution."""

    def __init__(
        self,
        scorer=None,
        *,
        linger_s: float = 0.0015,
        max_batch_rows: int = 4096,
        pad_buckets=DEFAULT_PAD_BUCKETS,
        drr_quantum: int = DEFAULT_DRR_QUANTUM,
        qos_policy=None,
    ) -> None:
        self._cv = threading.Condition()
        # Per-tenant FIFO lanes (DESIGN.md §26): an OrderedDict so the
        # drain's round-robin order is arrival order of the lanes.
        self._lanes: "OrderedDict[str, deque]" = OrderedDict()
        # DRR deficit per backlogged lane; carries across cap-limited
        # flushes, resets when a lane empties (classic DRR).
        self._deficit: dict = {}
        # Rotating start pointer for the drain's lane order.
        self._rr = 0
        # QoS policy (qos.policy.QoSPolicy, duck-typed on weight_of):
        # None = every lane weighs 1.0.
        self._qos_policy = qos_policy
        self._pending_rows = 0
        self._leader_active = False
        self._scorer = scorer
        self.drr_quantum = max(1, int(drr_quantum))
        # Canary candidate scorer (None = no canary in flight); snapshotted
        # per flush exactly like the active scorer.
        self._candidate = None
        self.linger_s = linger_s
        self.max_batch_rows = max_batch_rows
        self.pad_buckets = tuple(sorted(pad_buckets))
        # Occupancy stats (bench_sched reads these; prometheus gets the
        # histogram in _dispatch).
        self.batches = 0
        self.batched_requests = 0
        self.fallbacks = 0
        # scorer.score calls made by flushes (coalesced, singleton and
        # per-request alike) — one device dispatch each for a fused
        # scorer.
        self.scorer_calls = 0

    # -- hot-swap (ModelSubscriber.refresh) ----------------------------------

    def set_scorer(self, scorer) -> None:
        with self._cv:
            self._scorer = scorer

    def set_candidate(self, scorer) -> None:
        """Install/clear the canary candidate scorer (MLEvaluator.set_canary)."""
        with self._cv:
            self._candidate = scorer

    def set_qos_policy(self, policy) -> None:
        """Install/clear the tenant QoS policy feeding the DRR weights
        (dynconfig observer; None = unweighted lanes)."""
        with self._cv:
            self._qos_policy = policy

    def _weight(self, tenant: str) -> float:
        policy = self._qos_policy
        if policy is None:
            return 1.0
        try:
            return max(float(policy.weight_of(tenant)), 1e-9)
        except Exception as exc:  # noqa: BLE001 — a bad policy must not wedge flushes
            logger.warning("qos policy weight_of(%r) failed: %s", tenant, exc)
            return 1.0

    @property
    def has_scorer(self) -> bool:
        return self._scorer is not None

    @property
    def wants_features(self) -> bool:
        return getattr(self._scorer, "wants_features", True)

    # -- the EdgeScorer surface ----------------------------------------------

    def score(self, features, *, src_buckets=None, dst_buckets=None, candidate=False, scorer=None, tenant=""):  # dflint: hotpath
        features = np.asarray(features, dtype=np.float32)
        req = _Request(features, src_buckets, dst_buckets, candidate, scorer, tenant)
        with self._cv:
            lane = self._lanes.get(req.tenant)
            if lane is None:
                lane = self._lanes[req.tenant] = deque()
            lane.append(req)
            self._pending_rows += req.rows
            lead = not self._leader_active
            if lead:
                self._leader_active = True
            elif self._pending_rows >= self.max_batch_rows:
                # Only a FULL queue is worth interrupting the leader's
                # linger for; waking it per enqueue burned a context
                # switch per follower on the serving profile.
                self._cv.notify_all()
        if lead:
            self._flush_as_leader()
        # Bounded wait + loop (DF008 timeout sweep): the leader's finally
        # block always sets done, so this never times out in practice —
        # but a wedged flush now logs and stays visible to watchdog stack
        # dumps instead of parking every follower forever.
        while not req.done.wait(5.0):  # dflint: disable=DF007 — bounded wait loop, not per-row work
            logger.warning(
                "scorer batch flush slow or wedged; follower still waiting "
                "(%d rows queued)", features.shape[0],
            )
        if req.error is not None:
            raise req.error
        return req.result

    # -- flush machinery -----------------------------------------------------

    def _flush_as_leader(self) -> None:
        deadline = time.monotonic() + self.linger_s
        try:
            while True:
                with self._cv:
                    while self._pending_rows < self.max_batch_rows:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(remaining)
                    batch = self._drain_locked()
                    leftover = self._pending_rows > 0
                    # ONE snapshot of BOTH scorers for the whole flush; a
                    # canary uninstalled mid-queue pins its requests to the
                    # active scorer (never an error, never half-a-batch on
                    # each model version).
                    scorer = self._scorer
                    candidate = self._candidate if self._candidate is not None else scorer
                    if not leftover:
                        self._leader_active = False
                if batch:
                    self._dispatch(batch, scorer, candidate)
                if not leftover:
                    return
                # Cap-limited drain left requests queued: keep the
                # leadership and flush again immediately (no second
                # linger — the backlog IS the coalescing).
                deadline = time.monotonic()
        except BaseException:
            # A dispatch escape must not leave the queue leaderless
            # forever — followers would park on their done events.
            with self._cv:
                self._leader_active = False
            raise

    def _drain_locked(self) -> List[_Request]:
        """Take up to ``max_batch_rows`` rows off the lanes in
        deficit-round-robin order (module doc).  Single active lane =
        whole-queue swap, bit-equal to the pre-QoS behavior."""
        lanes = self._lanes
        if not lanes:
            return []
        if len(lanes) == 1:
            tenant, dq = next(iter(lanes.items()))
            batch = list(dq)
            lanes.clear()
            self._deficit.clear()
            self._pending_rows = 0
            return batch
        batch: List[_Request] = []
        rows = 0
        # Rotating lane order: the guarantee pass's cap spillover must
        # not always favor the same arrival-order prefix.
        keys = list(lanes.keys())
        start = self._rr % len(keys)
        self._rr += 1
        order = keys[start:] + keys[:start]
        # Anti-starvation guarantee: every backlogged lane lands its
        # HEAD request in every drain — deficit arithmetic alone can
        # park a 1-weight lane behind a 100-weight flood for several
        # cap-limited flushes (weight × quantum ≥ the row cap means the
        # flood eats the whole batch before the small lane's turn).
        for tenant in order:
            dq = lanes.get(tenant)
            if not dq or rows >= self.max_batch_rows:
                continue
            req = dq.popleft()
            # The head rides on credit: the deficit goes negative so the
            # DRR passes below charge it against the lane's future share
            # (weights stay honest over time).
            self._deficit[tenant] = (
                self._deficit.get(tenant, 0.0) - req.rows
            )
            batch.append(req)
            rows += req.rows
            if not dq:
                lanes.pop(tenant, None)
                self._deficit.pop(tenant, None)
        while rows < self.max_batch_rows and any(
            lanes.get(t) for t in order
        ):
            progressed = False
            for tenant in order:
                dq = lanes.get(tenant)
                if not dq:
                    continue
                self._deficit[tenant] = (
                    self._deficit.get(tenant, 0.0)
                    + self.drr_quantum * self._weight(tenant)
                )
                while (
                    dq
                    and rows < self.max_batch_rows
                    and self._deficit[tenant] >= dq[0].rows
                ):
                    req = dq.popleft()
                    self._deficit[tenant] -= req.rows
                    batch.append(req)
                    rows += req.rows
                    progressed = True
                if not dq:
                    # Lane drained: drop it and reset its deficit
                    # (classic DRR — an idle lane must not bank credit).
                    lanes.pop(tenant, None)
                    self._deficit.pop(tenant, None)
            if not progressed and rows < self.max_batch_rows:
                # Pathological quanta (microscopic weights vs a huge
                # head request): force the first backlogged head through
                # rather than spinning deficit passes — progress per
                # pass is a structural guarantee, not a tuning outcome.
                for tenant in order:
                    dq = lanes.get(tenant)
                    if dq:
                        self._deficit[tenant] = max(
                            self._deficit.get(tenant, 0.0),
                            float(dq[0].rows),
                        )
                        break
        self._pending_rows -= rows
        return batch

    def _pad_size(self, rows: int) -> int:
        i = bisect.bisect_left(self.pad_buckets, rows)
        if i < len(self.pad_buckets):
            return self.pad_buckets[i]
        top = self.pad_buckets[-1]
        return ((rows + top - 1) // top) * top

    def _dispatch(self, batch: List[_Request], scorer, candidate=None) -> None:
        """Split the flush by SCORER SNAPSHOT (requests for different
        model versions/precisions must not share a scorer call) and
        score each group coalesced with its own snapshot.

        A request's snapshot is, in priority order: the scorer it was
        pinned to at enqueue time (captured atomically with its
        CanaryRoute decision — a rollout transition mid-linger can
        therefore never produce a mixed-precision call), else the
        flush's candidate snapshot for canary-tagged requests (active
        when the candidate vanished mid-queue — pinned, never an
        error), else the flush's active snapshot."""
        groups: "OrderedDict[int, Tuple[object, List[_Request]]]" = OrderedDict()
        for r in batch:
            if r.scorer is not None:
                engine = r.scorer
            elif r.candidate:
                engine = candidate if candidate is not None else scorer
            else:
                engine = scorer
            key = id(engine)
            grp = groups.get(key)
            if grp is None:
                groups[key] = (engine, [r])
            else:
                grp[1].append(r)
        for engine, group in groups.values():
            self._dispatch_group(group, engine)

    def _dispatch_group(self, batch: List[_Request], scorer) -> None:
        # One ``scheduler/eval.flush`` span per coalesced scorer call
        # (per flush, never per announce): batch size + the compile
        # counter ride as attributes (0 until the recompile witness is
        # part of this package).
        t0 = time.perf_counter()
        with default_tracer.span(
            "scheduler/eval.flush",
            batch=len(batch),
            rows=sum(r.features.shape[0] for r in batch),
            jit_compiles=0,
        ):
            self._score_group(batch, scorer)
        # Flush latency into the mergeable sketch (DESIGN.md §23): one
        # observe per FLUSH, never per announce.
        metrics.EVAL_FLUSH_SECONDS.observe(time.perf_counter() - t0)

    def _score_group(self, batch: List[_Request], scorer) -> None:
        try:
            if scorer is None:
                raise ScorerUnavailable("scorer deactivated while queued")
            feat_dim = batch[0].features.shape[1]
            if len(batch) == 1 or any(
                r.features.shape[1] != feat_dim for r in batch
            ):
                # Singleton bypass — and the hot-swap corner where queued
                # requests were featurized for scorers with different
                # input widths (no common padded matrix exists).
                self._score_each(batch, scorer)
                return
            rows = [r.features.shape[0] for r in batch]
            total = sum(rows)
            # Pad ladder only for static-shape (device) backends; a
            # numpy scorer runs the exact concatenated size — padding it
            # is pure wasted compute (BENCHMARKS.md).
            if getattr(scorer, "static_shapes", False):
                padded = self._pad_size(total)
                feats = np.zeros((padded, feat_dim), dtype=np.float32)
                src = np.zeros(padded, dtype=np.int64)
                dst = np.zeros(padded, dtype=np.int64)
            else:
                padded = total
                feats = np.empty((total, feat_dim), dtype=np.float32)
                src = np.empty(total, dtype=np.int64)
                dst = np.empty(total, dtype=np.int64)
            off = 0
            for r in batch:
                n = r.features.shape[0]
                feats[off : off + n] = r.features
                src[off : off + n] = r.src if r.src is not None else 0
                dst[off : off + n] = r.dst if r.dst is not None else 0
                off += n
            faultinject.fire("scheduler.eval.batch")
            self._note_scorer_calls(1)
            scores = np.asarray(
                scorer.score(feats, src_buckets=src, dst_buckets=dst)
            )
            off = 0
            for r, n in zip(batch, rows):
                r.result = scores[off : off + n]
                off += n
            self._note_batch(len(batch))
        except ScorerUnavailable as exc:
            for r in batch:
                r.error = exc
        except Exception as exc:  # noqa: BLE001 — degrade, never stall announces
            logger.warning(
                "coalesced scorer batch of %d request(s) failed (%s); "
                "degrading to per-request scoring", len(batch), exc,
            )
            with self._cv:
                self.fallbacks += 1
            metrics.EVAL_BATCH_FALLBACK_TOTAL.inc()
            self._score_each(batch, scorer)
        finally:
            for r in batch:
                r.done.set()

    def _score_each(self, batch: List[_Request], scorer) -> None:
        """Per-request scoring: the singleton bypass and the degraded mode
        after a failed coalesced call (one bad request must not sink its
        batch-mates)."""
        self._note_scorer_calls(len(batch))
        for r in batch:
            try:
                r.result = np.asarray(
                    scorer.score(
                        r.features, src_buckets=r.src, dst_buckets=r.dst
                    )
                )
            except Exception as exc:  # noqa: BLE001 — per-request verdicts
                logger.warning("per-request scoring failed: %s", exc)
                r.error = exc
        self._note_batch(len(batch))

    def _note_scorer_calls(self, n: int) -> None:
        with self._cv:
            self.scorer_calls += n

    def _note_batch(self, n_requests: int) -> None:
        metrics.EVAL_BATCH_SIZE.observe(n_requests)
        with self._cv:
            self.batches += 1
            self.batched_requests += n_requests

    def mean_occupancy(self) -> float:
        with self._cv:
            return self.batched_requests / self.batches if self.batches else 0.0
