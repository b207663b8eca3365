"""Parent-peer evaluators: rule-based, network-topology, and ML.

Reference parity (scheduler/scheduling/evaluator/):
- algorithm dispatch by name default/nt/ml/plugin (evaluator.go:28-46,
  :76-90).  In the reference, ``ml`` is a TODO that falls back to the base
  evaluator (evaluator.go:84-86); here it is real.
- base scoring: 6 weighted features summing to 1.0 — finished-piece 0.2,
  upload-success 0.2, free-upload 0.15, host-type 0.15, IDC 0.15,
  location 0.15 (evaluator_base.go:28-45, evaluate :71-84).
- nt scoring: adds probe-RTT weight 0.12 and lowers host-type/IDC/location
  to 0.11 each; RTT is normalized against the 1 s ping timeout
  (evaluator_network_topology.go:30-56, :215-224).  Without a probe store
  ``nt`` ranks with the base rules, as in the reference.
- bad-node test: needs ≥2 piece-cost samples; <30 samples → last cost >
  20× mean of the rest; ≥30 → last cost > mean + 3σ (evaluator.go:92-129).

ML evaluator: instead of a Triton RPC per
scheduling decision (the reference's planned KServe client,
pkg/rpc/inference/client/client_v1.go:86-100), the trainer exports a
**local scorer** — model weights applied host-side via numpy (microsecond
cost, no RPC on the hot path).  See ``trainer/export.py`` for the scorer
artifact.  When no model is loaded the ML evaluator degrades to the base
rules, exactly like the reference's fallback.

Serving engine (DESIGN.md §14): ``evaluate_parents`` is the announce hot
path, so ranking runs **vectorized** — per-parent inputs are gathered
into arrays once and the weighted sum / featurization is numpy over all
candidates, with per-host feature rows served from ``HostFeatureCache``
and scorer calls optionally coalesced across concurrent announces by
``ScorerBatcher``.  The rule path's pre-vectorization scalar
implementation is kept as ``evaluate_parents_reference``, the ordering
oracle the vectorized path must reproduce byte-for-byte, including
argsort tie-break stability (tests/test_torch_serving_slice.py).
"""

from __future__ import annotations

import functools
import logging
import statistics
import time
from collections import OrderedDict
from typing import TYPE_CHECKING, List, Optional, Protocol, Sequence

import numpy as np

from ..records.features import EDGE_FEATURE_DIM as _EDGE_DIM
from ..records.features import edge_features_batch as _edge_features_batch
from ..records.schema import MAX_PIECES_PER_PARENT
from ..utils.types import HostType
from . import metrics
from .featcache import HostFeatureCache
from .resource import (
    PEER_BACK_TO_SOURCE,
    PEER_FAILED,
    PEER_LEAVE,
    PEER_PENDING,
    PEER_RECEIVED_EMPTY,
    PEER_RECEIVED_NORMAL,
    PEER_RECEIVED_SMALL,
    PEER_RECEIVED_TINY,
    PEER_RUNNING,
    Peer,
)

if TYPE_CHECKING:
    from .microbatch import ScorerBatcher
    from .networktopology import NetworkTopology

logger = logging.getLogger(__name__)

DEFAULT_ALGORITHM = "default"
NETWORK_TOPOLOGY_ALGORITHM = "nt"
ML_ALGORITHM = "ml"

MAX_SCORE = 1.0
MIN_SCORE = 0.0

# Location affinity looks at up to 5 '|'-separated elements (evaluator.go maxElementLen).
MAX_ELEMENT_LEN = 5
# ≥30 cost samples ⇒ treat as normal distribution (evaluator.go normalDistributionLen).
NORMAL_DISTRIBUTION_LEN = 30
MIN_AVAILABLE_COST_LEN = 2

PING_TIMEOUT_NS = 1_000_000_000  # 1 s (evaluator_network_topology.go defaultPingTimeout)

_BAD_STATES = (
    PEER_FAILED,
    PEER_LEAVE,
    PEER_PENDING,
    PEER_RECEIVED_EMPTY,
    PEER_RECEIVED_TINY,
    PEER_RECEIVED_SMALL,
    PEER_RECEIVED_NORMAL,
)


def piece_score(parent: Peer, child: Peer, total_piece_count: int) -> float:
    if total_piece_count > 0:
        return parent.finished_piece_count() / total_piece_count
    return float(parent.finished_piece_count() - child.finished_piece_count())


def upload_success_score(parent: Peer) -> float:
    uploads = parent.host.upload_count
    failed = parent.host.upload_failed_count
    if uploads < failed:
        return MIN_SCORE
    if uploads == 0 and failed == 0:
        return MAX_SCORE  # never scheduled → try it first
    return (uploads - failed) / uploads


def free_upload_score(parent: Peer) -> float:
    limit = parent.host.concurrent_upload_limit
    free = parent.host.free_upload_count()
    if limit > 0 and free > 0:
        return free / limit
    return MIN_SCORE


def host_type_score(parent: Peer) -> float:
    """Seed peers win on first download (still fetching), dfdaemon peers
    otherwise (evaluator_base.go:126-143)."""
    if parent.host.type is not HostType.NORMAL:
        if parent.fsm.current in (PEER_RECEIVED_NORMAL, PEER_RUNNING):
            return MAX_SCORE
        return MIN_SCORE
    return MAX_SCORE * 0.5


def idc_affinity_score(dst: str, src: str) -> float:
    if not dst or not src:
        return MIN_SCORE
    return MAX_SCORE if dst.lower() == src.lower() else MIN_SCORE


@functools.lru_cache(maxsize=65536)
def location_affinity_score(dst: str, src: str) -> float:
    # lru_cache: the location vocabulary is small and recurs on every
    # announce; the split/lower loop showed up in the serving profile.
    if not dst or not src:
        return MIN_SCORE
    if dst.lower() == src.lower():
        return MAX_SCORE
    de, se = dst.split("|"), src.split("|")
    n = min(len(de), len(se), MAX_ELEMENT_LEN)
    score = 0
    for i in range(n):
        if de[i].lower() != se[i].lower():
            break
        score += 1
    return score / MAX_ELEMENT_LEN


# Label-bound histogram children per algorithm: label resolution paid
# once, not per announce (utils.metrics._HistogramChild).
_EVAL_SECONDS_CHILDREN: dict = {}


def _eval_seconds(algorithm: str):
    child = _EVAL_SECONDS_CHILDREN.get(algorithm)
    if child is None:
        child = _EVAL_SECONDS_CHILDREN[algorithm] = metrics.EVAL_SECONDS.labels(
            algorithm=algorithm
        )
    return child


# Piece-score weight for the columnar rule path (the host-side term
# weights are baked into the store's pre-scaled columns, featcache.py).
_W_PIECE = 0.2


class Evaluator:
    """Base (rule-based) evaluator + shared bad-node detection.

    ``evaluate`` (scalar, per-parent) is the semantic source of truth;
    ``evaluate_all`` computes the same weighted sum for ALL parents in
    one set of numpy expressions — identical operation order per
    element, so scores (and therefore orderings) match bit-for-bit.

    With a columnar host store attached (``feature_cache``, DESIGN.md
    §18), the host-side score terms come pre-scaled straight off the
    slot columns (one locked gather), and the only per-parent Python
    work left is one fromiter over the peers — the attribute gathers
    that kept ``vector_rule`` at ~1× are gone.  Without a store the
    earlier fromiter path is kept verbatim (NetworkTopologyEvaluator and
    storeless constructions still use it).
    """

    ALGORITHM = DEFAULT_ALGORITHM
    _feature_cache: Optional[HostFeatureCache] = None

    def __init__(self, feature_cache: Optional[HostFeatureCache] = None) -> None:
        self._feature_cache = feature_cache

    @property
    def feature_cache(self) -> Optional[HostFeatureCache]:
        return self._feature_cache

    def evaluate(self, parent: Peer, child: Peer, total_piece_count: int) -> float:
        return (
            0.2 * piece_score(parent, child, total_piece_count)
            + 0.2 * upload_success_score(parent)
            + 0.15 * free_upload_score(parent)
            + 0.15 * host_type_score(parent)
            + 0.15 * idc_affinity_score(parent.host.stats.network.idc, child.host.stats.network.idc)
            + 0.15
            * location_affinity_score(
                parent.host.stats.network.location, child.host.stats.network.location
            )
        )

    # -- vectorized scoring (the serving path) -------------------------------

    def _component_arrays(
        self, parents: Sequence[Peer], child: Peer, total_piece_count: int
    ):
        """The 6 base score components as float64 arrays, one entry per
        parent, each computed exactly like its scalar counterpart."""
        n = len(parents)
        # Direct field reads, not the locked accessors: a GIL-atomic
        # snapshot of an int is exactly as consistent as the scalar
        # path's lock-per-parent reads taken at 50 different instants,
        # and the lock round-trips dominated this gather's profile.
        # TWO gather passes total (one numeric, one for the python-scored
        # terms) — eight separate fromiter loops dominated the old one.
        child_idc = child.host.stats.network.idc
        child_loc = child.host.stats.network.location
        nums = np.fromiter(
            (
                (
                    len(p.finished_pieces),
                    p.host.upload_count,
                    p.host.upload_failed_count,
                    p.host.concurrent_upload_limit,
                    p.host.concurrent_upload_count,
                )
                for p in parents
            ),
            dtype=np.dtype((np.float64, 5)),
            count=n,
        )
        scored = np.fromiter(
            (
                (
                    host_type_score(p),
                    idc_affinity_score(p.host.stats.network.idc, child_idc),
                    location_affinity_score(
                        p.host.stats.network.location, child_loc
                    ),
                )
                for p in parents
            ),
            dtype=np.dtype((np.float64, 3)),
            count=n,
        )
        finished = nums[:, 0]
        uploads = nums[:, 1]
        failed = nums[:, 2]
        limit = nums[:, 3]
        free = limit - nums[:, 4]

        if total_piece_count > 0:
            ps = finished / total_piece_count
        else:
            ps = finished - float(child.finished_piece_count())

        us = np.where(
            uploads < failed,
            MIN_SCORE,
            np.where(
                (uploads == 0.0) & (failed == 0.0),
                MAX_SCORE,
                (uploads - failed) / np.maximum(uploads, 1.0),
            ),
        )
        fs = np.where(
            (limit > 0) & (free > 0), free / np.maximum(limit, 1.0), MIN_SCORE
        )
        return ps, us, fs, scored[:, 0], scored[:, 1], scored[:, 2]

    def evaluate_all(  # dflint: hotpath
        self, parents: Sequence[Peer], child: Peer, total_piece_count: int
    ) -> np.ndarray:
        """[n] float64 scores — one numpy expression over all parents,
        term order matching ``evaluate`` so every element is bit-equal.
        With a columnar host store attached the host-side terms are
        pre-scaled column gathers; fromiter fallback otherwise."""
        cache = self._feature_cache
        if cache is None:
            ps, us, fs, hts, idcs, locs = self._component_arrays(
                parents, child, total_piece_count
            )
            return (
                0.2 * ps + 0.2 * us + 0.15 * fs + 0.15 * hts + 0.15 * idcs + 0.15 * locs
            )
        return self._evaluate_all_columnar(cache, parents, child, total_piece_count)

    def _evaluate_all_columnar(  # dflint: hotpath
        self, cache: HostFeatureCache, parents, child: Peer, total_piece_count: int
    ) -> np.ndarray:
        """Columnar rule scoring: host terms come pre-scaled off the slot
        columns (``RuleGather``); the only per-parent Python pass reads
        the two PEER-side inputs (finished-piece count, FSM-state
        mirror).  Term order and every float product match ``evaluate``
        bit-for-bit: the pre-scaled columns are written with the exact
        per-host math the scalar path runs per call (featcache
        write-through), and multiplication/addition order is preserved
        below."""
        n = len(parents)
        if n == 0:
            return np.zeros(0, dtype=np.float64)
        # Steady state: one lock-free featcache call computes the whole
        # score vector (slot gather + pre-scaled adds) — see
        # HostFeatureCache.rule_scores for the seqlock discipline.
        score = cache.rule_scores(child, parents, total_piece_count)
        if score is not None:
            return score
        sv = cache.rule_serve(child.host, parents)
        enc = sv.peer_enc
        counts = enc >> 1
        if total_piece_count > 0:
            score = _W_PIECE * (counts / total_piece_count)
        else:
            score = _W_PIECE * (counts - child.finished_piece_count())
        # In-place adds: bitwise identical to out-of-place, half the
        # allocation churn on a path measured in numpy dispatches.  The
        # host-type term is a pairwise gather — column 2 + elevated bit
        # holds the exact scalar 0.15 * host_type_score product for that
        # (host type, peer state) combination (featcache fill).
        w = sv.w_host
        np.add(score, w[:, 0], out=score)
        np.add(score, w[:, 1], out=score)
        np.add(score, sv.w_ht, out=score)
        aff = sv.w_aff
        np.add(score, aff[:, 0], out=score)
        np.add(score, aff[:, 1], out=score)
        return score

    def evaluate_parents(  # dflint: hotpath
        self, parents: List[Peer], child: Peer, total_piece_count: int
    ) -> List[Peer]:
        if len(parents) <= 1:
            return list(parents)
        t0 = time.perf_counter()
        # Steady-state shortcut: one lock-free featcache call computes
        # the whole score vector (rule_scores); evaluate_all covers every
        # other condition with identical bit-level results.
        cache = self._feature_cache
        scores = (
            cache.rule_scores(child, parents, total_piece_count)
            if cache is not None
            else None
        )
        if scores is None:
            scores = self.evaluate_all(parents, child, total_piece_count)
        # Stable descending sort == sorted(reverse=True): ties keep their
        # candidate-sample order on both paths.  The negation runs in
        # place (scores is this announce's private array) and the order
        # iterates as python ints — both measured on the announce path.
        np.negative(scores, out=scores)
        order = scores.argsort(kind="stable")
        _eval_seconds(self.ALGORITHM).observe(time.perf_counter() - t0)
        # order is a host-side numpy array (no device transfer): tolist
        # only converts to python ints for the C-level map/getitem.
        return list(map(parents.__getitem__, order.tolist()))  # dflint: disable=DF011

    def evaluate_parents_reference(
        self, parents: List[Peer], child: Peer, total_piece_count: int
    ) -> List[Peer]:
        """Pre-vectorization scalar path, kept verbatim: the ordering
        oracle for the property tests and bench_sched's baseline."""
        return sorted(
            parents,
            key=lambda p: self.evaluate(p, child, total_piece_count),
            reverse=True,
        )

    # -- bad-node detection ---------------------------------------------------

    def is_bad_node(self, peer: Peer) -> bool:
        if peer.fsm.current in _BAD_STATES:
            return True
        costs = peer.piece_costs()
        n = len(costs)
        if n < MIN_AVAILABLE_COST_LEN:
            return False
        last = costs[-1]
        mean = statistics.fmean(costs[:-1])
        if n < NORMAL_DISTRIBUTION_LEN:
            return last > mean * 20
        stdev = statistics.pstdev(costs[:-1])
        return last > mean + 3 * stdev

    def is_bad_nodes(self, peers: Sequence[Peer]) -> np.ndarray:
        """[n] bool — ``is_bad_node`` for a whole candidate set with the
        cost statistics vectorized (segment reductions over one flat
        array instead of ``statistics`` per peer).  Equivalent to the
        scalar test; the 3σ threshold is computed with the numerically
        stable two-pass formula, so verdicts can differ from the scalar
        oracle only for a sample sitting within float rounding of the
        exact threshold (asserted equal over random populations in
        tests/test_sched_vectorized.py)."""
        n = len(peers)
        bad = np.zeros(n, dtype=bool)
        rows: List[int] = []
        lens: List[int] = []
        flat: List[int] = []
        for i, p in enumerate(peers):
            if p.fsm.current in _BAD_STATES:
                bad[i] = True
                continue
            costs = p.piece_costs()
            if len(costs) < MIN_AVAILABLE_COST_LEN:
                continue
            rows.append(i)
            lens.append(len(costs))
            flat.extend(costs)
        if not rows:
            return bad
        lens_a = np.asarray(lens, dtype=np.int64)
        flat_a = np.asarray(flat, dtype=np.float64)
        ends = np.cumsum(lens_a)
        starts = ends - lens_a
        last = flat_a[ends - 1]
        m = (lens_a - 1).astype(np.float64)
        head_sum = np.add.reduceat(flat_a, starts) - last
        mean = head_sum / m
        verdict = last > mean * 20
        big = lens_a >= NORMAL_DISTRIBUTION_LEN
        if np.any(big):
            centered = flat_a - np.repeat(mean, lens_a)
            centered[ends - 1] = 0.0  # the probe sample is not in the window
            sq = np.add.reduceat(centered * centered, starts)
            std = np.sqrt(sq / m)
            verdict = np.where(big, last > mean + 3 * std, verdict)
        bad[np.asarray(rows, dtype=np.int64)] = verdict
        return bad


class NetworkTopologyEvaluator(Evaluator):
    """Adds probe-RTT affinity (evaluator_network_topology.go)."""

    ALGORITHM = NETWORK_TOPOLOGY_ALGORITHM

    def __init__(self, networktopology: "NetworkTopology") -> None:
        self._nt = networktopology

    def _rtt_score(self, parent_host_id: str, child_host_id: str) -> float:
        rtt_ns = self._nt.average_rtt(parent_host_id, child_host_id)
        if rtt_ns is None:
            return MIN_SCORE
        return (PING_TIMEOUT_NS - rtt_ns) / PING_TIMEOUT_NS

    def evaluate(self, parent: Peer, child: Peer, total_piece_count: int) -> float:
        return (
            0.2 * piece_score(parent, child, total_piece_count)
            + 0.2 * upload_success_score(parent)
            + 0.15 * free_upload_score(parent)
            + 0.11 * host_type_score(parent)
            + 0.11 * idc_affinity_score(parent.host.stats.network.idc, child.host.stats.network.idc)
            + 0.11
            * location_affinity_score(
                parent.host.stats.network.location, child.host.stats.network.location
            )
            + 0.12 * self._rtt_score(parent.host.id, child.host.id)
        )

    def evaluate_all(  # dflint: hotpath
        self, parents: Sequence[Peer], child: Peer, total_piece_count: int
    ) -> np.ndarray:
        ps, us, fs, hts, idcs, locs = self._component_arrays(
            parents, child, total_piece_count
        )
        child_id = child.host.id
        rtts = np.fromiter(
            (self._rtt_score(p.host.id, child_id) for p in parents),
            np.float64,
            count=len(parents),
        )
        return (
            0.2 * ps
            + 0.2 * us
            + 0.15 * fs
            + 0.11 * hts
            + 0.11 * idcs
            + 0.11 * locs
            + 0.12 * rtts
        )


class EdgeScorer(Protocol):
    """What the trainer exports for the scheduler (trainer/export.py).

    Scores [n] candidate edges given featurized inputs; higher = better
    parent.  Implementations must be cheap (numpy, no device transfer) —
    this sits on the scheduling hot path — and must score each row
    independently of its batch-mates (the batched-score contract:
    ``ScorerBatcher`` pads and coalesces rows from concurrent announces
    into one call)."""

    def score(
        self,
        features: np.ndarray,
        *,
        src_buckets: Optional[np.ndarray] = None,
        dst_buckets: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """[n, DOWNLOAD_FEATURE_DIM] features (+ parent/child host hash
        buckets) → [n] scores. Feature-based scorers may ignore the
        buckets; identity-based scorers (GNN) may ignore the features and
        set ``wants_features = False`` to skip featurization entirely."""
        ...


class CanaryRoute:
    """Atomic canary routing state: one immutable object per (candidate
    scorer, percent, version), swapped whole by ``MLEvaluator.set_canary``
    — the same single-reference-read discipline as the scorer hot-swap,
    so an announce can never see half a canary config.

    Bucketing is deterministic per child host: ``crc32(host_id) % 100 <
    percent`` — a child stays on one arm for the whole canary (outcome
    attribution stays clean) and drills can predict the split."""

    __slots__ = ("scorer", "percent", "version")

    def __init__(self, scorer, percent: int, version: int) -> None:
        self.scorer = scorer
        self.percent = int(percent)
        self.version = int(version)

    def routes_to_candidate(self, host_id: str) -> bool:
        import zlib

        return (zlib.crc32(host_id.encode("utf-8")) % 100) < self.percent


class MLEvaluator(Evaluator):
    """Learned evaluator: ranks parents with the trainer's exported scorer.

    The reference reserved this slot (evaluator.go:84 `case MLAlgorithm:
    // TODO`) and planned a Triton round-trip; we featurize the candidate
    edges exactly like training rows (records/features.py) and apply the
    exported model locally.  No model → base-rule fallback, mirroring the
    reference's fallback behavior.

    Serving engine wiring: host feature rows come from a
    ``HostFeatureCache`` gather, edge features are computed in one
    vectorized pass, and — when a ``ScorerBatcher`` is attached —
    concurrent announces coalesce into one padded scorer call.  The
    scorer reference is read ONCE per evaluate (immutable snapshot), so
    ``ModelSubscriber.refresh`` hot-swapping mid-call can never fault the
    ranking; any scorer-path failure degrades to rule ranking instead of
    failing the announce.
    """

    ALGORITHM = ML_ALGORITHM
    _SERVED_CACHE_MAX = 4096

    def __init__(
        self,
        scorer: Optional[EdgeScorer] = None,
        *,
        feature_cache: Optional[HostFeatureCache] = None,
        batcher: Optional["ScorerBatcher"] = None,
    ) -> None:
        self._scorer = scorer
        # child peer id -> (piece count, served-piece groups); see
        # _served_groups.  Only touched from evaluate (GIL-serialized
        # dict ops on a private map).
        self._served_cache: "OrderedDict[str, tuple]" = OrderedDict()
        # `is None`, not `or`: an empty cache is len()==0 and falsy.
        self._feature_cache = (
            feature_cache if feature_cache is not None else HostFeatureCache()
        )
        self._batcher = batcher
        if batcher is not None:
            batcher.set_scorer(scorer)
        # Rollout plane (DESIGN.md §15): both references are read ONCE
        # per evaluate (atomic snapshot, like the scorer) and cost a
        # None-check when no rollout is in flight.
        self._shadow = None            # rollout.shadow.ShadowScorer
        self._canary: Optional[CanaryRoute] = None
        # Announces ranked by the rule fallback after a scorer-path
        # failure (the degrade below is silent to the caller by design).
        self.degrades = 0

    def set_scorer(self, scorer: Optional[EdgeScorer]) -> None:
        self._scorer = scorer
        if self._batcher is not None:
            self._batcher.set_scorer(scorer)

    # -- rollout plane (ModelSubscriber candidate poll) ----------------------

    def set_shadow(self, shadow) -> None:
        """Attach/detach the shadow comparison engine (None = off)."""
        self._shadow = shadow

    @property
    def shadow(self):
        return self._shadow

    def set_canary(self, route: Optional[CanaryRoute]) -> None:
        """Install/clear canary routing; the batcher gets the candidate
        scorer so canaried announces keep coalescing (per-arm groups)."""
        self._canary = route
        if self._batcher is not None:
            self._batcher.set_candidate(route.scorer if route else None)

    @property
    def canary(self) -> Optional[CanaryRoute]:
        return self._canary

    @property
    def has_model(self) -> bool:
        return self._scorer is not None

    @property
    def feature_cache(self) -> HostFeatureCache:
        return self._feature_cache

    @property
    def batcher(self) -> Optional["ScorerBatcher"]:
        return self._batcher

    # -- featurization --------------------------------------------------------

    def _served_groups(self, child: Peer, piece_size: int) -> dict:
        """parent-id → (truncated count, truncated length sum, full count)
        of the child's pieces attributed to that parent — ONE pass over
        the child's pieces instead of ``to_parent_record``'s scan per
        parent, mirroring the record's ``MAX_PIECES_PER_PARENT`` split.
        Memoized per child against its piece count: pieces only accrue
        during a download, so an unchanged count means unchanged groups
        (re-announces between piece finishes are the common case)."""
        n_pieces = len(child.pieces)  # GIL-atomic len read
        cached = self._served_cache.get(child.id)
        if cached is not None and cached[0] == n_pieces:
            # No move_to_end on hits: eviction order is least-recently-
            # REBUILT, which keeps active downloaders (their piece count
            # moves) and is race-free for concurrent announce threads.
            return cached[1]
        raw: dict = {}
        for pc in child.snapshot_pieces():
            raw.setdefault(pc.parent_id, []).append(pc.length or piece_size)
        groups = {}
        for parent_id, lens in raw.items():
            kept = lens[:MAX_PIECES_PER_PARENT]
            groups[parent_id] = (len(kept), sum(kept), len(lens))
        self._served_cache[child.id] = (n_pieces, groups)
        self._served_cache.move_to_end(child.id)
        while len(self._served_cache) > self._SERVED_CACHE_MAX:
            self._served_cache.popitem(last=False)
        return groups

    def _served_stats(self, child: Peer, parents: Sequence[Peer], piece_size: int):
        """Per-parent arrays of ``_served_groups`` for a candidate set."""
        groups = self._served_groups(child, piece_size)
        n = len(parents)
        trunc_counts = np.zeros(n, dtype=np.int64)
        trunc_lens = np.zeros(n, dtype=np.int64)
        full_counts = np.zeros(n, dtype=np.int64)
        if groups:
            for i, p in enumerate(parents):
                g = groups.get(p.id)
                if g is not None:
                    trunc_counts[i] = g[0]
                    trunc_lens[i] = g[1]
                    full_counts[i] = g[2]
        return trunc_counts, trunc_lens, full_counts

    def _edge_inputs(self, sv, parents: Sequence[Peer], child: Peer, n: int) -> dict:
        """The ``edge_features_batch`` kwargs for one candidate set —
        shared by the assembled-matrix featurizer and the fused
        slot-path featurizer.  ONE python pass for both per-peer reads
        (direct len() read — GIL-atomic, see _component_arrays)."""
        task = child.task
        piece_size = task.piece_size or (4 << 20)
        trunc_counts, trunc_lens, full_counts = self._served_stats(
            child, parents, piece_size
        )
        fin_cost = np.fromiter(
            ((len(p.finished_pieces), p.cost_ns) for p in parents),
            dtype=np.dtype((np.int64, 2)),
            count=n,
        )
        return dict(
            same_idc=sv.same_idc,
            location_affinity=sv.location_affinity,
            served_counts=trunc_counts,
            served_len_sums=trunc_lens,
            content_length=task.content_length,
            finished_piece_counts=fin_cost[:, 0],
            total_piece_count=max(task.total_piece_count, 0),
            cost_ns=fin_cost[:, 1],
            upload_piece_counts=full_counts,
        )

    def _featurize_batch(  # dflint: hotpath
        self, parents: Sequence[Peer], child: Peer
    ):
        """([n, DOWNLOAD_FEATURE_DIM] rows, src hash buckets [n], child hash bucket) —
        buckets and the idc/location affinity terms all ride the cache's
        single-lock serve sweep (featcache.ServingGather)."""
        n = len(parents)
        sv = self._feature_cache.serve(child.host, [p.host for p in parents])
        kw = self._edge_inputs(sv, parents, child, n)
        h = sv.child_row.shape[0]
        out = np.empty((n, 2 * h + _EDGE_DIM), dtype=np.float32)
        out[:, :h] = sv.child_row
        out[:, h : 2 * h] = sv.rows
        # written in place, no temp + copy
        _edge_features_batch(out=out[:, 2 * h :], **kw)
        return out, sv.src_buckets, sv.dst_bucket

    def _featurize_slots(  # dflint: hotpath
        self, parents: Sequence[Peer], child: Peer
    ):
        """(edge block [n, E], parent slot ids, child slot id, buckets)
        for a fused gather+score scorer (ops/fused_score.py): the host
        feature rows are NOT assembled host-side — the kernel gathers
        them from its device mirror of the slot matrix by slot id, so
        the per-announce host cost is the edge block alone.  Slot ids
        are None when the store served uncached (oversized set)."""
        n = len(parents)
        sv = self._feature_cache.serve(child.host, [p.host for p in parents])
        kw = self._edge_inputs(sv, parents, child, n)
        edge = _edge_features_batch(**kw)
        return edge, sv.src_slots, sv.child_slot, sv.src_buckets, sv.dst_bucket

    # -- ranking --------------------------------------------------------------

    def evaluate_parents(  # dflint: hotpath
        self, parents: List[Peer], child: Peer, total_piece_count: int
    ) -> List[Peer]:
        scorer = self._scorer  # ONE snapshot: refresh() swaps can't race us
        if scorer is None or not parents:
            return super().evaluate_parents(parents, child, total_piece_count)
        if len(parents) == 1:
            return list(parents)
        t0 = time.perf_counter()
        # Canary routing: one snapshot read; with no rollout in flight
        # this is a None-compare and the path below is unchanged.  The
        # scorer that will score THIS announce (``engine``) is resolved
        # HERE, atomically with the route decision, and — for candidate
        # arms — carried into the batcher flush as a pinned snapshot: a
        # rollout transition mid-linger (e.g. float → quantized
        # candidate swap) can therefore never mix scorer snapshots
        # inside one coalesced call (tests/test_rollout.py).
        canary = self._canary
        use_candidate = False
        if canary is not None:
            use_candidate = canary.routes_to_candidate(child.host.id)
            metrics.CANARY_ANNOUNCES_TOTAL.inc(
                arm="candidate" if use_candidate else "active"
            )
        engine = canary.scorer if use_candidate else scorer
        shadow = self._shadow
        try:
            cache = self._feature_cache
            feats = None
            n = len(parents)
            if getattr(engine, "wants_slots", False) and shadow is None:
                # Fused gather+score: the scorer gathers host rows from
                # its device mirror of the slot matrix by slot id — only
                # the edge block is built host-side.  (With a shadow
                # engine attached the assembled path below runs instead:
                # the shadow comparison needs the full feature matrix.)
                edge, src_slots, child_slot, src_buckets, dst_bucket = (
                    self._featurize_slots(parents, child)
                )
                if src_slots is not None:
                    dst_slots = np.broadcast_to(np.int64(child_slot), (n,))
                    if self._batcher is not None:
                        # Slot-path requests ALWAYS pin their snapshot:
                        # the payload shape is scorer-specific, so a
                        # flush snapshot swap must not re-route them.
                        scores = np.asarray(
                            self._batcher.score(
                                edge,
                                src_buckets=src_slots,
                                dst_buckets=dst_slots,
                                candidate=use_candidate,
                                scorer=engine,
                                tenant=getattr(child, "tenant", ""),
                            )
                        )
                    else:
                        scores = np.asarray(
                            engine.score(
                                edge, src_buckets=src_slots, dst_buckets=dst_slots
                            )
                        )
                else:
                    # Store served uncached (oversized candidate set) —
                    # no slots exist; score the assembled rows with the
                    # scorer's reference path.
                    feats, src_buckets, dst_bucket = self._featurize_batch(
                        parents, child
                    )
                    scores = np.asarray(engine.score_rows(feats))
            else:
                # Identity-only scorers (GNN embedding lookup) skip
                # featurization — building the feature matrix is the
                # expensive part of this path.
                fused = getattr(engine, "wants_slots", False)
                if getattr(engine, "wants_features", True):
                    feats, src_buckets, dst_bucket = self._featurize_batch(
                        parents, child
                    )
                else:
                    feats = np.zeros((n, 0), dtype=np.float32)
                    src_buckets = np.fromiter(
                        (cache.bucket(p.host) for p in parents),
                        np.int64,
                        count=n,
                    )
                    dst_bucket = cache.bucket(child.host)
                # broadcast_to: the scorer only reads the buckets — no
                # per-announce materialized array.
                dst_buckets = np.broadcast_to(np.int64(dst_bucket), (n,))
                if fused:
                    # Fused scorer forced onto the assembled path (the
                    # shadow engine needs the full feature matrix):
                    # score via its reference path, off the batcher.
                    scores = np.asarray(engine.score_rows(feats))
                elif self._batcher is not None:
                    scores = np.asarray(
                        self._batcher.score(
                            feats,
                            src_buckets=src_buckets,
                            dst_buckets=dst_buckets,
                            candidate=use_candidate,
                            # Candidate arms pin the snapshot resolved
                            # with the route decision; active arms keep
                            # the flush-snapshot coalescing economics.
                            scorer=engine if use_candidate else None,
                            # Weighted-fair lane key (DESIGN.md §26).
                            tenant=getattr(child, "tenant", ""),
                        )
                    )
                else:
                    scores = np.asarray(
                        engine.score(
                            feats, src_buckets=src_buckets, dst_buckets=dst_buckets
                        )
                    )
        except Exception as exc:  # noqa: BLE001 — degrade to rules, never fail the announce
            logger.warning("ML scorer path failed (%s); ranking with rules", exc)
            self.degrades += 1
            metrics.EVAL_RULE_DEGRADE_TOTAL.inc()
            return super().evaluate_parents(parents, child, total_piece_count)
        # Shadow comparison rides the arrays this announce already built
        # (zero extra featurization); only active-armed announces offer —
        # the comparison needs the ACTIVE scores as its baseline.  The
        # fused fast path never offers (feats is None) — it only engages
        # with no shadow attached.
        if shadow is not None and not use_candidate and feats is not None:
            dst_buckets = np.broadcast_to(np.int64(dst_bucket), (len(parents),))
            shadow.offer(child.host.id, feats, src_buckets, dst_buckets, scores)
        order = np.argsort(-scores, kind="stable")
        _eval_seconds(self.ALGORITHM).observe(time.perf_counter() - t0)
        return [parents[i] for i in order]


def new_evaluator(
    algorithm: str = DEFAULT_ALGORITHM,
    *,
    networktopology: Optional["NetworkTopology"] = None,
    scorer: Optional[EdgeScorer] = None,
    feature_cache: Optional[HostFeatureCache] = None,
    batcher: Optional["ScorerBatcher"] = None,
) -> Evaluator:
    """Algorithm dispatch (evaluator.go:76-90)."""
    if algorithm == NETWORK_TOPOLOGY_ALGORITHM and networktopology is not None:
        return NetworkTopologyEvaluator(networktopology)
    if algorithm == ML_ALGORITHM:
        return MLEvaluator(scorer, feature_cache=feature_cache, batcher=batcher)
    # The rule evaluator gets the columnar host store too (DESIGN.md
    # §18): with one attached, host-side score terms gather pre-scaled
    # off the slot columns instead of per-parent attribute reads.
    return Evaluator(feature_cache=feature_cache)
