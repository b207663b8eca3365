"""Scheduler service layer: peer lifecycle handling + training-record birth.

Transport-neutral port of the reference's gRPC handler logic
(scheduler/service/service_v1.go, service_v2.go).  The daemon (or the
in-process swarm simulator) calls these methods where the reference
demuxes stream messages:

- ``register_peer``       — service_v2.go:866 handleRegisterPeerRequest /
  service_v1.go:95 RegisterPeerTask: load-or-create host/task/peer, FSM
  register event by size scope, schedule.
- ``report_piece_finished`` — service_v2.go:1157: piece cost bookkeeping
  on the child peer (parent-attributed — the training signal).
- ``report_peer_finished``  — service_v1.go:1284 handlePeerSuccess →
  :1418 createDownloadRecord: FSM success + **Download record written to
  storage** (the row the trainer trains on; v1 is the only record-writing
  path in the reference too).
- ``report_peer_failed``   — FSM failure + reschedule bookkeeping.
- ``leave_peer`` / ``leave_host`` — teardown.
- ``sync_probes_start`` / ``sync_probes_finished`` — the probe store's
  SyncProbes exchange (service_v2.go:721-866).

The cold-task seed trigger (``seed_peer_trigger``, any callable
``(url, task_id) -> bool``) and the tenant QoS policy (``set_qos_policy``,
``on_qos_config``) are the reference's.  The push hub (ROADMAP queue 1
item 12c) and the shard guard (item 14) are not part of this package
yet: their arguments keep their places and take only None, and the
paths that would call them (server push, ownership and admission
checks, the policy's admission accounting) are absent.  The reference's
seed client, ``scheduler/seed_client.RemoteSeedPeerClient``, is the
trigger ``cli/scheduler.build`` passes.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Set

from ..records import schema
from ..records.storage import Storage
from ..utils import idgen
from ..utils.fsm import FSM, InvalidEventError
from ..utils.types import TINY_FILE_SIZE, Priority, SizeScope
from . import metrics
from .networktopology import NetworkTopology, Probe
from .resource import Host, Peer, Piece, Resource, Task
from .scheduling import ScheduleResult, ScheduleResultKind, Scheduling

logger = logging.getLogger(__name__)


def _try_event(fsm: FSM, name: str) -> bool:
    """Fire an event if currently legal, atomically.

    ``if fsm.can(x): fsm.event(x)`` is check-then-act — under the wire
    binding two handler threads race it and the loser crashes the RPC with
    InvalidEventError.  The FSM's own event() is atomic; losing the race
    is a legal no-op here (the state the event wanted is already reached
    or superseded).
    """
    try:
        fsm.event(name)
        return True
    except InvalidEventError:
        return False


@dataclass
class RegisterResult:
    peer: Peer
    size_scope: SizeScope
    schedule: Optional[ScheduleResult] = None
    direct_piece: bytes = b""


class SchedulerService:
    """The composition the rpcserver binds (scheduler/scheduler.go:69-301)."""

    def __init__(
        self,
        resource: Resource,
        scheduling: Scheduling,
        storage: Optional[Storage] = None,
        networktopology: Optional[NetworkTopology] = None,
        *,
        seed_peer_trigger=None,
        hub=None,
        shard_guard=None,
    ) -> None:
        # The push hub and the shard guard are not part of this package
        # yet: the arguments keep their places and take only None.
        for name, value in (("hub", hub), ("shard_guard", shard_guard)):
            if value is not None:
                raise NotImplementedError(f"SchedulerService({name}=...) is not ported")
        self.resource = resource
        self.scheduling = scheduling
        self.storage = storage
        self.networktopology = networktopology
        # Optional callable(url, task_id) -> bool: asks a seed peer to warm
        # the task (resource/seed_peer.go:93-229 TriggerDownloadTask; wired
        # to a seed daemon's conductor in-process, an RPC in deployments).
        self.seed_peer_trigger = seed_peer_trigger
        self._mu = threading.Lock()
        self._seed_triggered: set = set()  # task ids already warmed
        self._gauges_refreshed_at = float("-inf")
        # Columnar host store (DESIGN.md §18): when the evaluator carries
        # one, announce decode binds hosts on arrival so their serving
        # state lives in slot columns from birth and the evaluate path
        # never marshals objects into the matrix.
        self._host_store = getattr(scheduling.evaluator, "feature_cache", None)
        # Tenant QoS policy (DESIGN.md §26): installed via dynconfig
        # (set_qos_policy) and re-published on announce answers so
        # daemons converge on it without their own manager dependency.
        self.qos_policy = None

    # -- tenant QoS (DESIGN.md §26) ------------------------------------------

    def set_qos_policy(self, policy) -> None:
        """Install a ``qos.QoSPolicy`` across this scheduler's
        enforcement points: the scorer batcher's DRR weights (the
        reference also hands it to the shard guard's admission
        accounting, which is not part of this package)."""
        self.qos_policy = policy
        batcher = getattr(self.scheduling.evaluator, "batcher", None)
        if batcher is not None:
            batcher.set_qos_policy(policy)

    def on_qos_config(self, config: dict) -> None:
        """Dynconfig observer: adopt the manager-published ``tenant_qos``
        blob.  Malformed payloads are skipped (an observer exception
        would take down the dynconfig refresh for every observer)."""
        payload = config.get("tenant_qos")
        if not isinstance(payload, dict) or not payload:
            return
        from ..qos.policy import QoSPolicy

        try:
            self.set_qos_policy(QoSPolicy.from_payload(payload))
        except (KeyError, TypeError, ValueError):
            logger.warning("ignoring malformed tenant_qos payload")

    # -- registration -------------------------------------------------------

    def register_peer(
        self,
        *,
        host: Host,
        url: str,
        peer_id: Optional[str] = None,
        task_id: Optional[str] = None,
        priority: Priority = Priority.LEVEL0,
        tag: str = "",
        application: str = "",
        tenant: str = "",
        blocklist: Optional[Set[str]] = None,
    ) -> RegisterResult:
        host = self.resource.store_host(host)
        freshly_bound = False
        if self._host_store is not None:
            # Columnar from birth: registration is an announce — the
            # host's serving state moves into the slot columns NOW, so
            # the evaluate path finds a bound host (pure gather, no
            # object→matrix marshalling).
            freshly_bound = self._host_store.adopt(host)
        # A fresh bind just filled the row from these stats; stamp
        # freshness instead of paying a second identical fill.
        if freshly_bound:
            host.touch_stamp()
        else:
            host.touch()
        tid = task_id or idgen.task_id(url)
        task = self.resource.store_task(Task(tid, url, tag=tag, application=application))
        task.touch()
        peer = Peer(
            peer_id or idgen.peer_id(host.ip, host.hostname),
            task,
            host,
            priority=priority,
            tag=tag,
            application=application,
            tenant=tenant,
        )
        # Resource.store_peer inserts into the task DAG and host peer map
        # for newly created peers — single insertion point.
        peer = self.resource.store_peer(peer)

        _try_event(task.fsm, "Download")

        scope = task.size_scope()
        # _try_event: a retried registration (same client-generated peer_id
        # re-sent after a wire timeout) finds the peer already registered —
        # the event is then a legal no-op, not an error.
        if scope is SizeScope.EMPTY:
            _try_event(peer.fsm, "RegisterEmpty")
            metrics.REGISTER_PEER_TOTAL.inc(result="ok")
            self._refresh_gauges()
            return RegisterResult(peer=peer, size_scope=scope)
        if scope is SizeScope.TINY and task.can_reuse_direct_piece():
            _try_event(peer.fsm, "RegisterTiny")
            metrics.REGISTER_PEER_TOTAL.inc(result="ok")
            self._refresh_gauges()
            return RegisterResult(
                peer=peer, size_scope=scope, direct_piece=task.direct_piece
            )
        if scope is SizeScope.SMALL:
            _try_event(peer.fsm, "RegisterSmall")
        else:
            _try_event(peer.fsm, "RegisterNormal")
        schedule = self.scheduling.schedule_candidate_parents(peer, blocklist)
        if (
            schedule.kind is ScheduleResultKind.NEED_BACK_TO_SOURCE
            and self.seed_peer_trigger is not None
            and not task.has_available_peer()
            # A SEED registering a cold task IS the warm-up — triggering
            # for it would call back into the very daemon that is mid-
            # register (its conductor dedups same-task downloads, so the
            # nested obtain would join the blocked run: a trigger↔register
            # deadlock until both sides' timeouts unwind).  Seeds go
            # straight to source; only normal peers get a seed warmed.
            and not host.type.is_seed
        ):
            # Cold task: warm a seed peer first, then reschedule once —
            # the child gets a parent instead of hitting the origin
            # (service_v2.go:1370 downloadTaskBySeedPeer).  Once per task,
            # claimed under the lock: the seed's OWN registration re-enters
            # this path (observed: unbounded recursive triggering without
            # the claim), and concurrent cold registrations must not launch
            # duplicate seed downloads.  The trigger is synchronous here
            # (in-process seed); the wire deployment should pass an async
            # trigger and rely on the client's reschedule-on-piece-failure.
            with self._mu:
                first = task.id not in self._seed_triggered
                if first:
                    self._seed_triggered.add(task.id)
            triggered = False
            if first:
                try:
                    triggered = self.seed_peer_trigger(task.url, task.id)
                except Exception as exc:  # noqa: BLE001 — trigger failure → back-to-source
                    logger.warning("seed trigger for %s failed: %s", task.id, exc)
                    triggered = False
            if triggered:
                schedule = self.scheduling.schedule_candidate_parents(peer, blocklist)
        metrics.SCHEDULE_TOTAL.inc(outcome=schedule.kind.name.lower())
        metrics.SCHEDULE_RETRIES.observe(schedule.retries)
        metrics.REGISTER_PEER_TOTAL.inc(result="ok")
        self._refresh_gauges()
        if schedule.kind is ScheduleResultKind.NEED_BACK_TO_SOURCE:
            task.back_to_source_peers.add(peer.id)
            _try_event(peer.fsm, "DownloadBackToSource")
        elif schedule.kind is ScheduleResultKind.PARENTS:
            _try_event(peer.fsm, "Download")
        return RegisterResult(peer=peer, size_scope=scope, schedule=schedule)

    def announce_host(self, host: Host, *, tenant: str = "") -> Host:
        """Host stats announce (service_v2 AnnounceHost): store-or-refresh
        the host record and WRITE ITS COLUMNS on arrival (DESIGN.md §18)
        — the announce decode is the marshalling point, not the evaluate
        path.  ``tenant`` is accepted for the announce surface; the
        reference's per-tenant accounting and announce-rate caps ride its
        shard guard's admission, which is not part of this package."""
        t0 = time.monotonic()
        stored = self.resource.store_host(host)
        if stored is not host:
            # Refresh announce-time stats AND addresses on the existing
            # record — a restarted daemon announces a fresh download_port
            # and children must not be handed the dead one.
            stored.stats = host.stats
            stored.concurrent_upload_limit = host.concurrent_upload_limit
            stored.ip = host.ip
            stored.port = host.port
            stored.download_port = host.download_port
        freshly_bound = False
        if self._host_store is not None:
            freshly_bound = self._host_store.adopt(stored)
        # touch() on a bound host recomputes the whole slot row in place
        # (the stats just changed) — the announce pays the marshalling
        # once so every subsequent serve is a pure fancy-index.  When
        # the adopt above BOUND the host, the bind already computed the
        # row from these stats: only the freshness stamp remains (the
        # double fill cost cold announces ~2× at fleet scale).
        if freshly_bound:
            stored.touch_stamp()
        else:
            stored.touch()
        metrics.ANNOUNCE_SECONDS.observe(time.monotonic() - t0)
        return stored

    # Lifecycle gauges refresh at most this often: every register/leave
    # used to take all three resource-manager locks just to re-publish
    # sizes — pure overhead at 100k-peer announce rates.
    _GAUGE_REFRESH_S = 0.5

    def _refresh_gauges(self) -> None:
        now = time.monotonic()
        if now - self._gauges_refreshed_at < self._GAUGE_REFRESH_S:
            return
        # Benign race: two concurrent refreshes both publish CURRENT
        # sizes; the stamp write is a plain store either way.
        self._gauges_refreshed_at = now
        metrics.HOSTS_GAUGE.set(len(self.resource.host_manager))
        metrics.PEERS_GAUGE.set(len(self.resource.peer_manager))
        metrics.TASKS_GAUGE.set(len(self.resource.task_manager))

    def set_task_info(
        self,
        peer: Peer,
        content_length: int,
        total_piece_count: int,
        piece_size: int,
    ) -> None:
        """First peer reports origin metadata (the reference carries this on
        RegisterPeerTask / piece results)."""
        task = peer.task
        with self._mu:
            if task.content_length < 0:
                task.content_length = content_length
                task.total_piece_count = total_piece_count
                task.piece_size = piece_size

    def set_task_direct_piece(self, peer: Peer, data: bytes) -> None:
        """First peer of a TINY task publishes the content inline; later
        registrations get the bytes in the response instead of scheduling
        (task.go DirectPiece / service_v1 tiny shortcut)."""
        task = peer.task
        with self._mu:
            if (
                not task.direct_piece
                and 0 < len(data) <= TINY_FILE_SIZE
                and len(data) == task.content_length
            ):
                # Must cover the WHOLE content (can_reuse_direct_piece
                # compares lengths) — a short read would poison the slot.
                task.direct_piece = data

    def mark_back_to_source(self, peer: Peer) -> None:
        """Peer fell back to origin download (conductor's source path)."""
        _try_event(peer.fsm, "DownloadBackToSource")
        peer.task.back_to_source_peers.add(peer.id)
        # peer.go:270-279 (PeerEventDownloadBackToSource callback): the
        # abandoned parent assignments release their upload slots.
        peer.task.delete_peer_in_edges(peer.id)

    # -- piece / peer results ----------------------------------------------

    def report_piece_finished(
        self,
        peer: Peer,
        piece_number: int,
        *,
        parent_id: str = "",
        length: int = 0,
        cost_ns: int = 0,
    ) -> None:
        """DownloadPieceFinishedRequest (service_v2.go:1157)."""
        metrics.PIECE_RESULT_TOTAL.inc(result="finished")
        is_new = peer.finish_piece(
            piece_number, cost_ns, parent_id=parent_id, length=length
        )
        peer.task.store_piece(
            Piece(piece_number, parent_id=parent_id, length=length, cost_ns=cost_ns)
        )
        if not is_new or not parent_id:
            # Retried report (wire client re-sent after a timeout): the
            # child side already deduped; the parent-side serve evidence
            # must not double-count either.
            return
        # Serve-side evidence: the observed piece cost describes the PARENT
        # as a server; it feeds the same 3σ/20×-mean bad-node test the
        # evaluator runs on candidates (evaluator.go:92-129).
        parent = self.resource.peer_manager.load(parent_id)
        if parent is None:
            return
        parent.append_piece_cost(cost_ns)

    def report_pieces_finished(self, peer: Peer, pieces) -> None:
        """Batched piece results (the daemon's report batcher coalesces a
        linger window of finished pieces into ONE call).  Each entry is a
        dict with number/parent_id/length/cost_ns; semantics are exactly
        N report_piece_finished calls."""
        for p in pieces:
            self.report_piece_finished(
                peer,
                int(p["number"]),
                parent_id=p.get("parent_id", ""),
                length=int(p.get("length", 0)),
                cost_ns=int(p.get("cost_ns", 0)),
            )

    def report_piece_failed(self, peer: Peer, parent_id: str) -> ScheduleResult:
        """Piece failure → blocklist the parent and reschedule
        (service handleDownloadPieceFailedRequest)."""
        metrics.PIECE_RESULT_TOTAL.inc(result="failed")
        peer.block_parents.add(parent_id)
        result = self.scheduling.schedule_candidate_parents(peer)
        metrics.SCHEDULE_TOTAL.inc(outcome=result.kind.name.lower())
        metrics.SCHEDULE_RETRIES.observe(result.retries)
        return result

    def report_peer_finished(self, peer: Peer) -> None:
        """handlePeerSuccess (:1284) + createDownloadRecord (:1418-1629)."""
        metrics.PEER_RESULT_TOTAL.inc(result="succeeded")
        _try_event(peer.fsm, "DownloadSucceeded")
        peer.cost_ns = int((time.time() - peer.created_at) * 1e9)
        task = peer.task
        _try_event(task.fsm, "DownloadSucceeded")
        # The record must capture parent attribution BEFORE the DAG edges
        # are dropped (createDownloadRecord at service_v1.go:1418 runs with
        # the graph intact; the FSM callback releases slots afterwards).
        record = (
            self._build_download_record(peer) if self.storage is not None else None
        )
        # Reference peer.go:280-292 (PeerEventDownloadSucceeded callback):
        # a finished child detaches from its parents, RELEASING their
        # upload slots — without this, every completed download holds a
        # slot forever and the seed saturates at concurrent_upload_limit.
        peer.task.delete_peer_in_edges(peer.id)
        if self.storage is not None:
            self.storage.create_download(record)
            metrics.DOWNLOAD_RECORDS_TOTAL.inc()

    def report_peer_failed(self, peer: Peer) -> None:
        metrics.PEER_RESULT_TOTAL.inc(result="failed")
        _try_event(peer.fsm, "DownloadFailed")
        record = (
            self._build_download_record(peer, state="Failed")
            if self.storage is not None
            else None
        )
        # peer.go:293-305 (PeerEventDownloadFailed callback).
        peer.task.delete_peer_in_edges(peer.id)
        if self.storage is not None:
            self.storage.create_download(record)
            metrics.DOWNLOAD_RECORDS_TOTAL.inc()

    def leave_peer(self, peer: Peer) -> None:
        _try_event(peer.fsm, "Leave")
        peer.task.delete_peer_in_edges(peer.id)
        peer.task.delete_peer_out_edges(peer.id)
        self._refresh_gauges()

    def leave_host(self, host: Host) -> None:
        host.leave_peers()
        if self.networktopology is not None:
            self.networktopology.delete_host(host.id)
        # A departed host frees its feature-cache slot immediately instead
        # of aging out of the LRU (featcache invalidation rule, DESIGN §14).
        cache = getattr(self.scheduling.evaluator, "feature_cache", None)
        if cache is not None:
            cache.invalidate(host.id)
        self._refresh_gauges()

    # -- probes (service_v2.go:721-866 SyncProbes) ---------------------------

    def sync_probes_start(self, host: Host) -> List[Host]:
        if self.networktopology is None:
            return []
        metrics.PROBE_SYNC_TOTAL.inc(phase="start")
        return self.networktopology.find_probed_hosts(host.id)

    def sync_probes_finished(
        self, host: Host, results: List[tuple]
    ) -> None:
        """results: [(dest_host_id, rtt_ns)]"""
        if self.networktopology is None:
            return
        metrics.PROBE_SYNC_TOTAL.inc(phase="finished")
        for dest_id, rtt_ns in results:
            self.networktopology.store(host.id, dest_id)
            self.networktopology.enqueue_probe(
                host.id, dest_id, Probe(host_id=dest_id, rtt_ns=int(rtt_ns))
            )

    # -- record construction (service_v1.go:1418-1629) -----------------------

    def _build_download_record(
        self, peer: Peer, state: Optional[str] = None
    ) -> schema.Download:
        parents = [
            parent.to_parent_record(peer)
            for parent in peer.task.load_parents(peer.id)
        ][: schema.MAX_PARENTS_PER_DOWNLOAD]
        return schema.Download(
            id=peer.id,
            tag=peer.tag,
            application=peer.application,
            state=state or peer.fsm.current,
            cost=peer.cost_ns,
            finished_piece_count=peer.finished_piece_count(),
            task=peer.task.to_record(),
            host=peer.host.to_record(),
            parents=parents,
            created_at=int(peer.created_at * 1e9),
            updated_at=int(peer.updated_at * 1e9),
        )
