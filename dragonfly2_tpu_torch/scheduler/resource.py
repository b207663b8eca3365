"""In-memory cluster state: Host / Task / Peer resources with FSMs.

Reference parity (scheduler/resource/):
- peer lifecycle FSM: states & events mirror peer.go:52-110 (Pending →
  Received{Empty,Tiny,Small,Normal} → Running / BackToSource →
  Succeeded / Failed → Leave).
- task lifecycle FSM: task.go:57-85 (Pending/Running/Succeeded/Failed/Leave,
  re-download allowed from terminal states).
- per-task peer DAG: task.go:155, edges :276-365 — parents point at
  children; in-degree 0 + not-seed + not-finished means "has no parent yet".
- size scope: task.go:444-470 (EMPTY =0B, TINY ≤128B, SMALL single piece,
  NORMAL else, UNKNOWN when length or piece count is unknown).
- managers: sync.Map stores with TTL-based GC (host_manager.go,
  peer_manager.go, task_manager.go), LoadRandomPeers (task.go:243),
  LoadRandomHosts (host_manager.go:121-140).

Everything here is the *source of the training signal*: piece costs append
into ``Peer.piece_costs`` (bad-node statistics, evaluator features) and
finished downloads are converted into ``records.schema.Download`` rows by
the service layer.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

from ..records import schema
from ..utils.dag import DAG, DAGError
from ..utils.fsm import FSM, EventDesc
from ..utils.hostinfo import BuildInfo, CPUStat, DiskStat, MemoryStat, NetworkStat
from ..utils.types import (
    EMPTY_FILE_SIZE,
    TINY_FILE_SIZE,
    HostType,
    Priority,
    SizeScope,
)

# ---------------------------------------------------------------------------
# Peer FSM (peer.go:52-110)
# ---------------------------------------------------------------------------

PEER_PENDING = "Pending"
PEER_RECEIVED_EMPTY = "ReceivedEmpty"
PEER_RECEIVED_TINY = "ReceivedTiny"
PEER_RECEIVED_SMALL = "ReceivedSmall"
PEER_RECEIVED_NORMAL = "ReceivedNormal"
PEER_RUNNING = "Running"
PEER_BACK_TO_SOURCE = "BackToSource"
PEER_SUCCEEDED = "Succeeded"
PEER_FAILED = "Failed"
PEER_LEAVE = "Leave"

_RECEIVED_STATES = (
    PEER_RECEIVED_EMPTY,
    PEER_RECEIVED_TINY,
    PEER_RECEIVED_SMALL,
    PEER_RECEIVED_NORMAL,
)

PEER_EVENTS = (
    EventDesc("RegisterEmpty", (PEER_PENDING,), PEER_RECEIVED_EMPTY),
    EventDesc("RegisterTiny", (PEER_PENDING,), PEER_RECEIVED_TINY),
    EventDesc("RegisterSmall", (PEER_PENDING,), PEER_RECEIVED_SMALL),
    EventDesc("RegisterNormal", (PEER_PENDING,), PEER_RECEIVED_NORMAL),
    EventDesc("Download", _RECEIVED_STATES, PEER_RUNNING),
    EventDesc(
        "DownloadBackToSource",
        _RECEIVED_STATES + (PEER_RUNNING,),
        PEER_BACK_TO_SOURCE,
    ),
    EventDesc(
        "DownloadSucceeded",
        _RECEIVED_STATES + (PEER_RUNNING, PEER_BACK_TO_SOURCE),
        PEER_SUCCEEDED,
    ),
    EventDesc(
        "DownloadFailed",
        (PEER_PENDING,)
        + _RECEIVED_STATES
        + (PEER_RUNNING, PEER_BACK_TO_SOURCE, PEER_SUCCEEDED),
        PEER_FAILED,
    ),
    EventDesc(
        "Leave",
        (PEER_PENDING,)
        + _RECEIVED_STATES
        + (PEER_RUNNING, PEER_BACK_TO_SOURCE, PEER_FAILED, PEER_SUCCEEDED),
        PEER_LEAVE,
    ),
)

# ---------------------------------------------------------------------------
# Task FSM (task.go:57-85)
# ---------------------------------------------------------------------------

TASK_PENDING = "Pending"
TASK_RUNNING = "Running"
TASK_SUCCEEDED = "Succeeded"
TASK_FAILED = "Failed"
TASK_LEAVE = "Leave"

TASK_EVENTS = (
    EventDesc(
        "Download", (TASK_PENDING, TASK_SUCCEEDED, TASK_FAILED, TASK_LEAVE), TASK_RUNNING
    ),
    EventDesc(
        "DownloadSucceeded", (TASK_LEAVE, TASK_RUNNING, TASK_FAILED), TASK_SUCCEEDED
    ),
    EventDesc("DownloadFailed", (TASK_RUNNING,), TASK_FAILED),
    EventDesc(
        "Leave", (TASK_PENDING, TASK_RUNNING, TASK_SUCCEEDED, TASK_FAILED), TASK_LEAVE
    ),
)


def _now() -> float:
    return time.monotonic()


@dataclass
class HostStats:
    """Mutable announce-time stats (host.go:133-347 Host fields)."""

    cpu: CPUStat = field(default_factory=CPUStat)
    memory: MemoryStat = field(default_factory=MemoryStat)
    network: NetworkStat = field(default_factory=NetworkStat)
    disk: DiskStat = field(default_factory=DiskStat)
    build: BuildInfo = field(default_factory=BuildInfo)


class Host:
    """A peer machine (scheduler/resource/host.go).

    Columnar ownership (DESIGN.md §18): when a ``HostFeatureCache`` binds
    this host to a slot (``_cols = (store, slot)``), the store's slot
    columns become the *source of truth* for the hot serving fields —
    upload counters/limit, ``updated_at``, peer count — and the shadow
    attributes here go stale until detach copies the columns back.  The
    property accessors read/write through the binding, so every legacy
    caller (``to_record``, the scalar ``*_reference`` oracles, tests)
    observes exactly the column state; the serving gather never touches
    this object at all.  The binding is flipped only while holding BOTH
    the store lock and this host's lock (store → host order, §16), and
    ``_mut`` is a monotonic mutation stamp bumped by every write so
    non-owning caches can validate their copies.
    """

    def __init__(
        self,
        id: str,
        hostname: str,
        ip: str,
        *,
        port: int = 0,
        download_port: int = 0,
        type: HostType = HostType.NORMAL,
        concurrent_upload_limit: int = 50,
        os: str = "",
        platform: str = "",
        scheduler_cluster_id: int = 0,
    ) -> None:
        self.id = id
        self.hostname = hostname
        self.ip = ip
        self.port = port
        self.download_port = download_port
        self.type = type
        self.os = os
        self.platform = platform
        self.scheduler_cluster_id = scheduler_cluster_id
        self.stats = HostStats()
        self._mu = threading.Lock()
        # Columnar binding + mutation stamp come FIRST: the property
        # setters below consult them.
        self._cols = None  # (HostFeatureCache, slot) when column-owned
        # Slot in the process's PRIMARY store (featcache._primary_ref),
        # -1 otherwise: the lock-free rule gather validates ownership
        # with ONE attribute read per candidate instead of a binding
        # tuple walk (maintained by bind/detach).
        self._pslot = -1
        self._mut = 0
        self._concurrent_upload_limit = concurrent_upload_limit
        self._concurrent_upload_count = 0
        self._upload_count = 0
        self._upload_failed_count = 0
        self.peers: Dict[str, "Peer"] = {}
        self.created_at = time.time()
        self._updated_at = self.created_at
        # Negotiated wire dialect for this host's connections
        # (rpc/version.py; 1 = the legacy unversioned dialect).
        self.protocol_version = 1

    # -- columnar thin-view accessors ---------------------------------------
    #
    # Getters are lock-free: a single column read is as atomic as the old
    # plain attribute read, and the re-check of `_cols` closes the detach/
    # slot-recycle window (a detach copies columns back to the shadows
    # BEFORE clearing the binding, so a raced read falls back to a value
    # at least as fresh).  Setters serialize under the host lock against
    # bind/detach, which also hold it.

    def _col_read(self, col_name: str, shadow_name: str):
        b = self._cols
        if b is None:
            return getattr(self, shadow_name)
        v = getattr(b[0], col_name)[b[1]]
        if self._cols is b:
            return v
        return getattr(self, shadow_name)

    @property
    def upload_count(self) -> int:
        return int(self._col_read("_upload_count_col", "_upload_count"))

    @upload_count.setter
    def upload_count(self, v: int) -> None:
        with self._mu:
            self._mut += 1
            b = self._cols
            if b is None:
                self._upload_count = int(v)
            else:
                b[0].write_upload_state(b[1], self._mut, upload_count=int(v))

    @property
    def upload_failed_count(self) -> int:
        return int(self._col_read("_upload_failed_col", "_upload_failed_count"))

    @upload_failed_count.setter
    def upload_failed_count(self, v: int) -> None:
        with self._mu:
            self._mut += 1
            b = self._cols
            if b is None:
                self._upload_failed_count = int(v)
            else:
                b[0].write_upload_state(b[1], self._mut, upload_failed_count=int(v))

    @property
    def concurrent_upload_count(self) -> int:
        return int(self._col_read("_concurrent_upload_col", "_concurrent_upload_count"))

    @concurrent_upload_count.setter
    def concurrent_upload_count(self, v: int) -> None:
        with self._mu:
            self._mut += 1
            b = self._cols
            if b is None:
                self._concurrent_upload_count = int(v)
            else:
                b[0].write_upload_state(b[1], self._mut, concurrent_upload_count=int(v))

    @property
    def concurrent_upload_limit(self) -> int:
        return int(self._col_read("_upload_limit_col", "_concurrent_upload_limit"))

    @concurrent_upload_limit.setter
    def concurrent_upload_limit(self, v: int) -> None:
        with self._mu:
            self._mut += 1
            b = self._cols
            if b is None:
                self._concurrent_upload_limit = int(v)
            else:
                b[0].write_upload_state(b[1], self._mut, concurrent_upload_limit=int(v))

    @property
    def updated_at(self) -> float:
        return float(self._col_read("_updated_at_col", "_updated_at"))

    @updated_at.setter
    def updated_at(self, v: float) -> None:
        with self._mu:
            self._mut += 1
            b = self._cols
            if b is None:
                self._updated_at = float(v)
            else:
                b[0].write_updated_at(b[1], self._mut, float(v))

    def free_upload_count(self) -> int:
        with self._mu:
            b = self._cols
            if b is None:
                return self._concurrent_upload_limit - self._concurrent_upload_count
            store, slot = b
            return int(store._upload_limit_col[slot]) - int(
                store._concurrent_upload_col[slot]
            )

    def acquire_upload(self) -> bool:
        with self._mu:
            b = self._cols
            if b is None:
                if self._concurrent_upload_count >= self._concurrent_upload_limit:
                    return False
                self._mut += 1
                self._concurrent_upload_count += 1
                return True
            store, slot = b
            cur = int(store._concurrent_upload_col[slot])
            if cur >= int(store._upload_limit_col[slot]):
                return False
            self._mut += 1
            store.write_upload_state(slot, self._mut, concurrent_upload_count=cur + 1)
            return True

    def release_upload(self, succeeded: bool = True) -> None:
        with self._mu:
            self._mut += 1
            b = self._cols
            if b is None:
                self._concurrent_upload_count = max(
                    self._concurrent_upload_count - 1, 0
                )
                self._upload_count += 1
                if not succeeded:
                    self._upload_failed_count += 1
                return
            store, slot = b
            failed = int(store._upload_failed_col[slot]) + (0 if succeeded else 1)
            store.write_upload_state(
                slot,
                self._mut,
                concurrent_upload_count=max(
                    int(store._concurrent_upload_col[slot]) - 1, 0
                ),
                upload_count=int(store._upload_count_col[slot]) + 1,
                upload_failed_count=failed,
            )

    def store_peer(self, peer: "Peer") -> None:
        with self._mu:
            self.peers[peer.id] = peer
            b = self._cols
            if b is not None:
                b[0].write_peer_count(b[1], len(self.peers))

    def delete_peer(self, peer_id: str) -> None:
        with self._mu:
            self.peers.pop(peer_id, None)
            b = self._cols
            if b is not None:
                b[0].write_peer_count(b[1], len(self.peers))

    def peer_count(self) -> int:
        with self._mu:
            return len(self.peers)

    def leave_peers(self) -> None:
        """Mark all this host's peers as leaving (host going away)."""
        with self._mu:
            peers = list(self.peers.values())
        for p in peers:
            if p.fsm.can("Leave"):
                p.fsm.event("Leave")

    def touch(self) -> None:
        """Announce-path stats refresh: for a column-owned host this
        recomputes the whole slot row in place (stats may have changed —
        the same contract the earlier stamp expressed: every feature-input
        mutation must be accompanied by a ``touch``)."""
        self._mut += 1
        b = self._cols
        if b is None:
            self._updated_at = time.time()
        else:
            b[0].refresh_row(self)

    def touch_stamp(self) -> None:
        """Freshness-only touch for the adopt→announce sequence: the
        bind that just ran computed the row from these very stats, so
        only ``updated_at`` needs writing (the full ``touch`` here was
        a second identical row fill per cold announce).  The mutation
        counter still advances — foreign stamped copies must revalidate
        against the new stamp."""
        self._mut += 1
        b = self._cols
        if b is None:
            self._updated_at = time.time()
        else:
            b[0].stamp_row(self)

    def to_record(self) -> schema.HostRecord:
        return schema.HostRecord(
            id=self.id,
            type=self.type.name_str,
            hostname=self.hostname,
            ip=self.ip,
            port=self.port,
            download_port=self.download_port,
            os=self.os,
            platform=self.platform,
            concurrent_upload_limit=self.concurrent_upload_limit,
            concurrent_upload_count=self.concurrent_upload_count,
            upload_count=self.upload_count,
            upload_failed_count=self.upload_failed_count,
            cpu=self.stats.cpu,
            memory=self.stats.memory,
            network=self.stats.network,
            disk=self.stats.disk,
            build=self.stats.build,
            scheduler_cluster_id=self.scheduler_cluster_id,
            created_at=int(self.created_at * 1e9),
            updated_at=int(self.updated_at * 1e9),
        )


class Piece:
    """Piece metadata cached on the task (task.go StorePiece)."""

    __slots__ = ("number", "parent_id", "offset", "length", "digest", "cost_ns", "created_at")

    def __init__(
        self,
        number: int,
        *,
        parent_id: str = "",
        offset: int = 0,
        length: int = 0,
        digest: str = "",
        cost_ns: int = 0,
    ) -> None:
        self.number = number
        self.parent_id = parent_id
        self.offset = offset
        self.length = length
        self.digest = digest
        self.cost_ns = cost_ns
        self.created_at = time.time()


class Task:
    """A piece of content being distributed; owns the per-task peer DAG
    (scheduler/resource/task.go)."""

    def __init__(
        self,
        id: str,
        url: str,
        *,
        type: str = "standard",
        digest: str = "",
        tag: str = "",
        application: str = "",
        filtered_query_params: tuple = (),
        back_to_source_limit: int = 3,
    ) -> None:
        self.id = id
        self.url = url
        self.type = type
        self.digest = digest
        self.tag = tag
        self.application = application
        self.filtered_query_params = filtered_query_params
        self.content_length = -1
        self.total_piece_count = -1
        self.piece_size = 0
        self.direct_piece = b""  # TINY payload carried inline (task.go DirectPiece)
        self.back_to_source_limit = back_to_source_limit
        self.back_to_source_peers: set[str] = set()
        self.fsm = FSM(TASK_PENDING, TASK_EVENTS)
        self.dag: DAG[Peer] = DAG()
        self.pieces: Dict[int, Piece] = {}
        self._mu = threading.RLock()
        self.created_at = time.time()
        self.updated_at = self.created_at

    # -- peers / DAG --------------------------------------------------------

    def store_peer(self, peer: "Peer") -> None:
        with self._mu:
            if peer.id not in self.dag:
                self.dag.add_vertex(peer.id, peer)

    def load_peer(self, peer_id: str) -> Optional["Peer"]:
        with self._mu:
            if peer_id not in self.dag:
                return None
            return self.dag.get_vertex(peer_id).value

    def delete_peer(self, peer_id: str) -> None:
        with self._mu:
            if peer_id in self.dag:
                self.dag.delete_vertex(peer_id)

    def peer_count(self) -> int:
        with self._mu:
            return len(self.dag)

    def load_random_peers(self, n: int, rng: random.Random) -> List["Peer"]:
        """Uniform random peer sample (task.go:243 LoadRandomPeers), drawn
        from the caller's generator."""
        with self._mu:
            ids = self.dag.vertex_ids()
            rng.shuffle(ids)
            return [self.dag.get_vertex(i).value for i in ids[:n]]

    def can_add_peer_edge(self, parent_id: str, child_id: str) -> bool:
        with self._mu:
            try:
                return self.dag.can_add_edge(parent_id, child_id)
            except DAGError:
                return False

    def add_peer_edge(self, parent: "Peer", child: "Peer") -> bool:
        """parent → child edge; consumes one of parent's upload slots
        (task.go:276-311 AddPeerEdge)."""
        with self._mu:
            try:
                self.dag.add_edge(parent.id, child.id)
            except DAGError:
                return False
        if not parent.host.acquire_upload():
            with self._mu:
                try:
                    self.dag.delete_edge(parent.id, child.id)
                except DAGError:
                    pass
            return False
        return True

    def delete_peer_in_edges(self, peer_id: str) -> None:
        """Detach peer from its parents, releasing their upload slots
        (task.go:313-340 DeletePeerInEdges)."""
        with self._mu:
            if peer_id not in self.dag:
                return
            vertex = self.dag.get_vertex(peer_id)
            parents = list(vertex.parents)
            self.dag.delete_vertex_in_edges(peer_id)
        for pv in parents:
            pv.value.host.release_upload(succeeded=True)

    def delete_peer_edge(self, parent: "Peer", child_id: str) -> bool:
        """Detach ONE parent→child edge, releasing that parent's upload
        slot — the selective form schedule_once needs to swap edge sets
        attach-first (old parents detach only after replacements hold)."""
        with self._mu:
            try:
                self.dag.delete_edge(parent.id, child_id)
            except DAGError:
                return False
        parent.host.release_upload(succeeded=True)
        return True

    def delete_peer_out_edges(self, peer_id: str) -> None:
        with self._mu:
            if peer_id not in self.dag:
                return
            vertex = self.dag.get_vertex(peer_id)
            n_children = len(vertex.children)
            self.dag.delete_vertex_out_edges(peer_id)
            peer = vertex.value
        for _ in range(n_children):
            peer.host.release_upload(succeeded=True)

    def peer_in_degree(self, peer_id: str) -> int:
        with self._mu:
            return self.dag.get_vertex(peer_id).in_degree()

    def peer_out_degree(self, peer_id: str) -> int:
        with self._mu:
            return self.dag.get_vertex(peer_id).out_degree()

    def load_parents(self, peer_id: str) -> List["Peer"]:
        with self._mu:
            v = self.dag.get_vertex(peer_id)
            return [p.value for p in v.parents]

    def load_children(self, peer_id: str) -> List["Peer"]:
        with self._mu:
            v = self.dag.get_vertex(peer_id)
            return [c.value for c in v.children]

    # -- pieces -------------------------------------------------------------

    def store_piece(self, piece: Piece) -> None:
        with self._mu:
            self.pieces[piece.number] = piece

    def load_piece(self, number: int) -> Optional[Piece]:
        with self._mu:
            return self.pieces.get(number)

    # -- scope / state ------------------------------------------------------

    def size_scope(self) -> SizeScope:
        if self.content_length < 0 or self.total_piece_count < 0:
            return SizeScope.UNKNOWN
        if self.content_length == EMPTY_FILE_SIZE:
            return SizeScope.EMPTY
        if self.content_length <= TINY_FILE_SIZE:
            return SizeScope.TINY
        if self.total_piece_count == 1:
            return SizeScope.SMALL
        return SizeScope.NORMAL

    def can_back_to_source(self) -> bool:
        return len(self.back_to_source_peers) <= self.back_to_source_limit

    def can_reuse_direct_piece(self) -> bool:
        return len(self.direct_piece) > 0 and len(self.direct_piece) == self.content_length

    def has_available_peer(self, blocklist: Optional[set] = None) -> bool:
        """Any peer that could serve as a parent (task.go HasAvailablePeer)."""
        blocklist = blocklist or set()
        with self._mu:
            peers = [self.dag.get_vertex(i).value for i in self.dag.vertex_ids()]
        for p in peers:
            if p.id in blocklist:
                continue
            if p.fsm.current in (PEER_SUCCEEDED, PEER_RUNNING, PEER_BACK_TO_SOURCE):
                return True
        return False

    def touch(self) -> None:
        self.updated_at = time.time()

    def to_record(self) -> schema.TaskRecord:
        return schema.TaskRecord(
            id=self.id,
            url=self.url,
            type=self.type,
            content_length=self.content_length,
            total_piece_count=max(self.total_piece_count, 0),
            back_to_source_limit=self.back_to_source_limit,
            back_to_source_peer_count=len(self.back_to_source_peers),
            state=self.fsm.current,
            created_at=int(self.created_at * 1e9),
            updated_at=int(self.updated_at * 1e9),
        )


class Peer:
    """One download of one task by one host (scheduler/resource/peer.go:137-201)."""

    def __init__(
        self,
        id: str,
        task: Task,
        host: Host,
        *,
        priority: Priority = Priority.LEVEL0,
        tag: str = "",
        application: str = "",
        tenant: str = "",
    ) -> None:
        self.id = id
        self.task = task
        self.host = host
        self.priority = priority
        self.tag = tag
        self.application = application
        # Tenant identity (DESIGN.md §26): stamped from the daemon's
        # declared/derived tenant at registration; "" = default tenant.
        self.tenant = tenant
        self.range: Optional[tuple] = None
        # Lock-free FSM-state mirrors for the vectorized serving gather:
        # `fsm.current` takes the FSM's RLock per read, which the rule
        # evaluator paid once per candidate per announce.  The mirrors
        # are written by the FSM's own enter_state callback (after the
        # transition commits) and read GIL-atomically — the same
        # different-instants snapshot consistency the scalar path's
        # per-candidate locked reads already had.  ``fsm_elevated``
        # pre-computes the host_type_score state test.
        self.fsm_state = PEER_PENDING
        self.fsm_elevated = False
        # Packed serving encoding (finished_piece_count << 1 | elevated),
        # maintained by finish_piece and the FSM mirror — the rule
        # gather reads ONE attribute per candidate (featcache.rule_serve).
        self._enc = 0
        self.fsm = FSM(
            PEER_PENDING, PEER_EVENTS, callbacks={"enter_state": self._mirror_fsm}
        )
        self._mu = threading.Lock()
        self.finished_pieces: set[int] = set()
        self.piece_costs_ns: List[int] = []
        # Pieces THIS peer downloaded, keyed by number, each attributed to the
        # parent that served it (the reference keeps peer.Pieces with ParentID,
        # service_v1.go:1505-1519 — the Download record's per-parent piece
        # costs come from the child's pieces, not the parent's own downloads).
        self.pieces: Dict[int, Piece] = {}
        self.block_parents: set[str] = set()
        self.need_back_to_source = False
        self.cost_ns = 0
        self.created_at = time.time()
        self.updated_at = self.created_at

    def _mirror_fsm(self, fsm, event: str, src: str, dst: str) -> None:
        self.fsm_state = dst
        elevated = dst in (PEER_RECEIVED_NORMAL, PEER_RUNNING)
        self.fsm_elevated = elevated
        self._enc = (len(self.finished_pieces) << 1) | elevated

    def append_piece_cost(self, cost_ns: int) -> None:
        with self._mu:
            self.piece_costs_ns.append(cost_ns)

    def piece_costs(self) -> List[int]:
        with self._mu:
            return list(self.piece_costs_ns)

    def finish_piece(
        self,
        number: int,
        cost_ns: int,
        *,
        parent_id: str = "",
        length: int = 0,
    ) -> bool:
        """Record a finished piece; False for a duplicate report.

        Idempotent: a retried report (wire client re-sending after a
        timeout) must not double-count the piece cost — callers use the
        return value to gate THEIR side effects (parent serve-cost
        evidence) on the first delivery only.
        """
        with self._mu:
            if number in self.finished_pieces:
                return False
            self.finished_pieces.add(number)
            self.piece_costs_ns.append(cost_ns)
            self.pieces[number] = Piece(
                number, parent_id=parent_id, length=length, cost_ns=cost_ns
            )
            self._enc = (len(self.finished_pieces) << 1) | self.fsm_elevated
        self.updated_at = time.time()
        return True

    def finished_piece_count(self) -> int:
        with self._mu:
            return len(self.finished_pieces)

    def snapshot_pieces(self) -> List[Piece]:
        """Consistent copy of this peer's downloaded pieces (insertion
        order) — the serving-path featurizer groups them by serving
        parent in one pass (evaluator.MLEvaluator._served_stats)."""
        with self._mu:
            return list(self.pieces.values())

    def is_done(self) -> bool:
        return self.fsm.current in (PEER_SUCCEEDED, PEER_FAILED, PEER_LEAVE)

    def touch(self) -> None:
        self.updated_at = time.time()

    def to_parent_record(self, child: Optional["Peer"] = None) -> schema.Parent:
        """Snapshot as a Download.parents[] entry (storage/types.go Parent).

        ``child`` is the downloading peer whose record this parent entry
        belongs to: the per-piece costs are the CHILD's pieces attributed to
        this parent (service_v1.go:1505-1519), so
        ``Parent.observed_bandwidth()`` measures the parent→child transfer.
        ``upload_piece_count`` is likewise the count of child pieces this
        parent served.
        """
        piece_size = self.task.piece_size or (4 << 20)
        pieces: List[schema.Piece] = []
        upload_piece_count = 0
        if child is not None:
            with child._mu:
                served = [p for p in child.pieces.values() if p.parent_id == self.id]
            upload_piece_count = len(served)
            pieces = [
                schema.Piece(
                    length=p.length or piece_size,
                    cost=p.cost_ns,
                    created_at=int(p.created_at * 1e9),
                )
                for p in served[: schema.MAX_PIECES_PER_PARENT]
            ]
        with self._mu:
            finished = len(self.finished_pieces)
        return schema.Parent(
            id=self.id,
            tag=self.tag,
            application=self.application,
            state=self.fsm.current,
            cost=self.cost_ns,
            upload_piece_count=upload_piece_count,
            finished_piece_count=finished,
            host=self.host.to_record(),
            pieces=pieces,
            created_at=int(self.created_at * 1e9),
            updated_at=int(self.updated_at * 1e9),
        )


# ---------------------------------------------------------------------------
# Managers (sync.Map + TTL GC in the reference)
# ---------------------------------------------------------------------------


class _TTLManager:
    def __init__(self, ttl: float) -> None:
        self._mu = threading.Lock()
        self._items: Dict[str, object] = {}
        self.ttl = ttl

    def load(self, key: str):
        with self._mu:
            return self._items.get(key)

    def store(self, key: str, value) -> None:
        with self._mu:
            self._items[key] = value

    def load_or_store(self, key: str, value):
        """Returns (existing_or_new, loaded)."""
        with self._mu:
            if key in self._items:
                return self._items[key], True
            self._items[key] = value
            return value, False

    def delete(self, key: str) -> None:
        with self._mu:
            self._items.pop(key, None)

    def items(self) -> list:
        with self._mu:
            return list(self._items.values())

    def __len__(self) -> int:
        with self._mu:
            return len(self._items)


class HostManager(_TTLManager):
    """host_manager.go — reaps hosts idle past TTL (no announce)."""

    def __init__(self, ttl: float = 6 * 3600) -> None:
        super().__init__(ttl)

    def load_random_hosts(
        self, n: int, rng: random.Random, blocklist: Optional[set] = None
    ) -> List[Host]:
        blocklist = blocklist or set()
        hosts = [h for h in self.items() if h.id not in blocklist]
        rng.shuffle(hosts)
        return hosts[:n]

    def run_gc(self) -> int:
        now = time.time()
        reaped = 0
        for host in self.items():
            if now - host.updated_at > self.ttl and host.peer_count() == 0:
                self.delete(host.id)
                reaped += 1
            elif now - host.updated_at > self.ttl:
                host.leave_peers()
        return reaped


class TaskManager(_TTLManager):
    """task_manager.go — reaps tasks with no peers past TTL."""

    def __init__(self, ttl: float = 2 * 3600) -> None:
        super().__init__(ttl)

    def run_gc(self) -> int:
        now = time.time()
        reaped = 0
        for task in self.items():
            if task.peer_count() == 0 and now - task.updated_at > self.ttl:
                if task.fsm.can("Leave"):
                    task.fsm.event("Leave")
                self.delete(task.id)
                reaped += 1
        return reaped


class PeerManager(_TTLManager):
    """peer_manager.go — reaps finished/idle peers past TTL."""

    def __init__(self, ttl: float = 24 * 3600) -> None:
        super().__init__(ttl)

    def run_gc(self) -> int:
        now = time.time()
        reaped = 0
        for peer in self.items():
            idle = now - peer.updated_at
            if peer.fsm.current == PEER_LEAVE or (peer.is_done() and idle > self.ttl):
                peer.task.delete_peer_in_edges(peer.id)
                peer.task.delete_peer_out_edges(peer.id)
                peer.task.delete_peer(peer.id)
                peer.host.delete_peer(peer.id)
                self.delete(peer.id)
                reaped += 1
        return reaped


class Resource:
    """Composition of the three managers (scheduler/resource/resource.go:32-47)."""

    def __init__(
        self,
        *,
        host_ttl: float = 6 * 3600,
        task_ttl: float = 2 * 3600,
        peer_ttl: float = 24 * 3600,
    ) -> None:
        self.host_manager = HostManager(host_ttl)
        self.task_manager = TaskManager(task_ttl)
        self.peer_manager = PeerManager(peer_ttl)

    def store_host(self, host: Host) -> Host:
        existing, loaded = self.host_manager.load_or_store(host.id, host)
        return existing

    def store_task(self, task: Task) -> Task:
        existing, loaded = self.task_manager.load_or_store(task.id, task)
        return existing

    def store_peer(self, peer: Peer) -> Peer:
        existing, loaded = self.peer_manager.load_or_store(peer.id, peer)
        if not loaded:
            peer.task.store_peer(peer)
            peer.host.store_peer(peer)
        return existing

    def run_gc(self) -> dict:
        return {
            "peers": self.peer_manager.run_gc(),
            "tasks": self.task_manager.run_gc(),
            "hosts": self.host_manager.run_gc(),
        }
