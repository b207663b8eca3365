"""Parent-selection engine (reference: scheduler/scheduling/scheduling.go).

Semantics preserved:
- retry loop with back-to-source escalation (scheduling.go:85-215):
  peers needing back-to-source (flag set, or candidate search failed
  ``retry_back_to_source_limit`` times while the task still has
  back-to-source budget) get a NeedBackToSource response; past
  ``retry_limit`` total scheduling fails hard.
- filter pipeline (scheduling.go:500-573 filterCandidateParents): sample
  ``filter_parent_limit`` random peers from the task DAG, drop blocklisted,
  same-host, orphaned normal peers (in-degree 0, not back-to-source /
  succeeded / seed), bad nodes, full upload slots, and cycle-creating edges.
- evaluator ranks the survivors; top ``candidate_parent_limit`` become
  parents (scheduling.go:384 FindCandidateParents) and edges are added to
  the task DAG.
- defaults: filter 15 / candidate 4, retry 5, back-to-source retry 4,
  interval 500 ms (scheduler/config/constants.go:33-37, :66-73).

Transport-neutral: responses are returned as plain result objects rather
than written to a gRPC stream, so the engine runs identically under the
in-process swarm simulator, the unit tests, and the native RPC server.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from enum import Enum, auto
from typing import Callable, List, Optional, Set

from ..utils.dag import DAGError
from ..utils.types import HostType
from .evaluator import Evaluator
from .resource import PEER_BACK_TO_SOURCE, PEER_SUCCEEDED, Peer


@dataclass
class SchedulingConfig:
    """scheduler/config/config.go SchedulerConfig (:121-142) + cluster limits."""

    candidate_parent_limit: int = 4
    filter_parent_limit: int = 15
    retry_limit: int = 5
    retry_back_to_source_limit: int = 4
    retry_interval: float = 0.5  # seconds


class ScheduleResultKind(Enum):
    PARENTS = auto()           # NormalTaskResponse: candidate parents attached
    NEED_BACK_TO_SOURCE = auto()
    FAILED = auto()            # exceeded retry limit


@dataclass
class ScheduleResult:
    kind: ScheduleResultKind
    parents: List[Peer] = field(default_factory=list)
    description: str = ""
    retries: int = 0


class Scheduling:
    """The engine (scheduling.go Scheduling iface :43-62)."""

    def __init__(
        self,
        evaluator: Evaluator,
        config: Optional[SchedulingConfig] = None,
        *,
        sleep: Callable[[float], None] = time.sleep,
        rng: Optional[random.Random] = None,
    ) -> None:
        self.evaluator = evaluator
        self.config = config or SchedulingConfig()
        self._sleep = sleep
        # The candidate sampler's generator (the reference samples with
        # the process-global one); seed it to replay a schedule.
        self.rng = rng if rng is not None else random.Random()

    # -- candidate search ---------------------------------------------------

    def filter_candidate_parents(
        self, peer: Peer, blocklist: Optional[Set[str]] = None
    ) -> List[Peer]:
        blocklist = blocklist or set()
        prelim: List[Peer] = []
        for cand in peer.task.load_random_peers(
            self.config.filter_parent_limit, self.rng
        ):
            if cand.id in blocklist or cand.id in peer.block_parents:
                continue
            # Two daemons downloading from each other deadlocks piece sync.
            if cand.host.id == peer.host.id:
                continue
            try:
                in_degree = peer.task.peer_in_degree(cand.id)
            except DAGError:
                # Candidate reaped by GC between sampling and inspection —
                # skip it, like the reference's InDegree error branch
                # (scheduling.go:526-530).
                continue
            # A normal peer with no parent that isn't fetching from source
            # and hasn't finished has nothing to serve.
            if (
                cand.host.type is HostType.NORMAL
                and in_degree == 0
                and cand.fsm.current not in (PEER_BACK_TO_SOURCE, PEER_SUCCEEDED)
            ):
                continue
            prelim.append(cand)
        if not prelim:
            return []
        # One vectorized bad-node pass over the survivors (the cost
        # statistics dominate this filter); every check is per-candidate
        # independent, so batching it after the cheap screens keeps the
        # accepted set identical to the reference's one-at-a-time order.
        bad = self.evaluator.is_bad_nodes(prelim)
        candidates: List[Peer] = []
        for cand, cand_bad in zip(prelim, bad):
            if cand_bad:
                continue
            if cand.host.free_upload_count() <= 0:
                continue
            if not peer.task.can_add_peer_edge(cand.id, peer.id):
                continue
            candidates.append(cand)
        return candidates

    def find_candidate_parents(
        self, peer: Peer, blocklist: Optional[Set[str]] = None
    ) -> List[Peer]:
        """Filter + rank + cap (scheduling.go:384-446)."""
        candidates = self.filter_candidate_parents(peer, blocklist)
        if not candidates:
            return []
        ranked = self.evaluator.evaluate_parents(
            candidates, peer, max(peer.task.total_piece_count, 0)
        )
        return ranked[: self.config.candidate_parent_limit]

    def find_success_parent(
        self, peer: Peer, blocklist: Optional[Set[str]] = None
    ) -> Optional[Peer]:
        """Succeeded parents only (piece metadata source, scheduling.go:448-498)."""
        candidates = [
            c
            for c in self.filter_candidate_parents(peer, blocklist)
            if c.fsm.current == PEER_SUCCEEDED
        ]
        if not candidates:
            return None
        ranked = self.evaluator.evaluate_parents(
            candidates, peer, max(peer.task.total_piece_count, 0)
        )
        return ranked[0]

    # -- the scheduling loop ------------------------------------------------

    def schedule_once(
        self, peer: Peer, blocklist: Optional[Set[str]] = None
    ) -> ScheduleResult:
        """Single-shot reschedule for server-push paths: no retry loop, no
        sleeping (pushes run on stream handler / stall-monitor threads),
        and — unlike the retry loop — the peer's CURRENT edges are only
        detached once replacement candidates exist, so a failed attempt
        leaves the child's real assignment untouched.
        """
        parents = self.find_candidate_parents(peer, blocklist)
        if not parents:
            return ScheduleResult(
                kind=ScheduleResultKind.FAILED,
                description="no candidates (single-shot)",
            )
        # Attach-first: candidates never include current parents (the
        # filter's can_add_peer_edge rejects existing edges), so the new
        # edges land alongside the old ones, and only once at least one
        # replacement holds do the previous parents detach.  Losing every
        # upload-slot race therefore leaves the child's real assignment
        # untouched — the failure mode ADVICE r2 found (detach-first left
        # the child edgeless and invisible to reschedule_stalled).
        try:
            old_parents = peer.task.load_parents(peer.id)
        except DAGError:
            # The child left between candidate search and here (its vertex
            # is gone); attachments below will lose too and report FAILED —
            # raising would convert an unrelated peer's piece report into
            # an RPC error on the push path (service.py bad-parent sweep).
            old_parents = []
        attached = [p for p in parents if peer.task.add_peer_edge(p, peer)]
        if not attached:
            return ScheduleResult(
                kind=ScheduleResultKind.FAILED,
                description="upload-slot races lost (single-shot)",
            )
        for old in old_parents:
            peer.task.delete_peer_edge(old, peer.id)
        return ScheduleResult(kind=ScheduleResultKind.PARENTS, parents=attached)

    def schedule_candidate_parents(
        self, peer: Peer, blocklist: Optional[Set[str]] = None
    ) -> ScheduleResult:
        """v2 loop (scheduling.go:85-215)."""
        n = 0
        while True:
            if peer.task.can_back_to_source():
                if peer.need_back_to_source:
                    return ScheduleResult(
                        kind=ScheduleResultKind.NEED_BACK_TO_SOURCE,
                        description="peer needs back-to-source",
                        retries=n,
                    )
                if n >= self.config.retry_back_to_source_limit:
                    return ScheduleResult(
                        kind=ScheduleResultKind.NEED_BACK_TO_SOURCE,
                        description="scheduling exceeded RetryBackToSourceLimit",
                        retries=n,
                    )
            if n >= self.config.retry_limit:
                return ScheduleResult(
                    kind=ScheduleResultKind.FAILED,
                    description="scheduling exceeded RetryLimit",
                    retries=n,
                )

            # Reschedule from a clean slate: detach current parents.
            peer.task.delete_peer_in_edges(peer.id)

            parents = self.find_candidate_parents(peer, blocklist)
            if not parents:
                n += 1
                self._sleep(self.config.retry_interval)
                continue

            attached = []
            for parent in parents:
                if peer.task.add_peer_edge(parent, peer):
                    attached.append(parent)
            if not attached:
                # Every edge-add lost its upload-slot race — treat like a
                # found-nothing round so the peer keeps progressing toward
                # back-to-source instead of stalling with zero parents.
                n += 1
                self._sleep(self.config.retry_interval)
                continue
            return ScheduleResult(
                kind=ScheduleResultKind.PARENTS, parents=attached, retries=n
            )
