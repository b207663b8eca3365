"""RemoteScheduler: the client side of the scheduler wire API.

Implements the SchedulerService surface the daemon's Conductor uses
(register_peer / report_* / sync_probes_*) by forwarding over HTTP and
maintaining **local mirrors** of Host/Task/Peer — real resource classes —
so the conductor's code path is identical in embedded and remote modes
(the reference daemon likewise keeps local peer state synchronized with
the scheduler's view through the gRPC stream).

Port of ``dragonfly2_tpu/rpc/scheduler_client.py``, verbatim: requests
carry the caller's ``traceparent`` header, so either package's server
links its handler span into the caller's trace.
"""

from __future__ import annotations

import base64
import json
import threading
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Set, Tuple

from ..scheduler.resource import Host, Peer, Task
from ..scheduler.scheduling import ScheduleResult, ScheduleResultKind
from ..scheduler.service import RegisterResult
from ..utils.types import SizeScope
from .retry import retry_call
from .scheduler_server import host_from_wire, host_to_wire
from .version import PROTOCOL_VERSION


class RPCError(RuntimeError):
    def __init__(self, message: str, *, code: int = 0):
        super().__init__(message)
        self.code = code


class RemoteScheduler:
    def __init__(
        self,
        base_url: str,
        *,
        timeout: float = 10.0,
        protocol_version: Optional[int] = None,
    ):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        # protocol_version=1 is the N-1 SHIM: requests carry no version
        # field (byte-identical to pre-handshake clients) and v2-only
        # features stay off — tests/test_compat.py downloads through it
        # against the current scheduler every CI run.
        self.protocol_version = (
            PROTOCOL_VERSION if protocol_version is None else protocol_version
        )
        # What the server negotiated at announce (known after the first
        # announce_host; assume own version until told otherwise).
        self.negotiated_version = self.protocol_version
        self.server_capabilities: tuple = ()
        # Last ring payload the server re-published on announce (§24).
        self.scheduler_ring: Optional[dict] = None
        # Last tenant_qos payload re-published on announce (§26) and the
        # tenant identity stamped on this client's announces/registers
        # (the daemon's declared/derived tenant).
        self.tenant_qos: Optional[dict] = None
        self.tenant = ""
        self._mu = threading.Lock()
        self._tasks: Dict[str, Task] = {}
        self._hosts: Dict[str, Host] = {}
        self._peers: Dict[str, Peer] = {}
        self._announced: Set[str] = set()
        # Remote transport has no probe store mirrored locally.
        self.networktopology = None

    # -- wire ---------------------------------------------------------------

    def _call(
        self, method: str, req: dict, *, deadline_s: Optional[float] = None
    ) -> dict:
        def once() -> dict:
            from ..utils import faultinject
            from ..utils.tracing import default_tracer

            # Chaos seam: drop/delay/typed-error per call site, fired
            # INSIDE the retried attempt so injected faults exercise the
            # same retry machinery real transport failures do.
            faultinject.fire(f"rpc.client.{method}")

            body = json.dumps(req).encode()
            # Trace propagation (otelgrpc client-interceptor analog): the
            # caller's active span rides the wire so the server links its
            # handler span into the SAME trace.
            headers = {"Content-Type": "application/json"}
            headers.update(default_tracer.inject())
            http_req = urllib.request.Request(
                f"{self.base_url}/rpc/{method}",
                data=body,
                headers=headers,
                method="POST",
            )
            try:
                with urllib.request.urlopen(http_req, timeout=self.timeout) as resp:
                    return json.loads(resp.read())
            except urllib.error.HTTPError as exc:
                payload = exc.read()
                code = 0
                parsed: dict = {}
                try:
                    parsed = json.loads(payload)
                    message = parsed.get("error", "")
                    code = int(parsed.get("code", 0))
                except json.JSONDecodeError:
                    message = payload[:200].decode(errors="replace")
                # Sharded-fleet steering answers (DESIGN.md §24) surface
                # as their typed exceptions so the ShardRouter can act on
                # them; neither is retryable against THIS endpoint.
                if exc.code == 421 and message == "wrong_shard":
                    from ..scheduler.sharding import WrongShardError

                    raise WrongShardError(
                        str(parsed.get("task_id", "")),
                        owner_id=str(parsed.get("owner_id", "")),
                        owner_url=str(parsed.get("owner_url", "")),
                        ring_version=int(parsed.get("ring_version", 0)),
                    ) from exc
                if exc.code == 503 and message == "shard_saturated":
                    from ..scheduler.sharding import ShardSaturatedError

                    raise ShardSaturatedError(
                        retry_after_s=float(parsed.get("retry_after_s", 1.0)),
                        reason=str(parsed.get("reason", "")),
                    ) from exc
                raise RPCError(
                    f"{method}: HTTP {exc.code}: {message}", code=code
                ) from exc

        return retry_call(
            once,
            retry_on=(ConnectionError, TimeoutError, OSError),
            deadline_s=deadline_s,
        )

    # -- mirrors ------------------------------------------------------------

    def _mirror_host(self, data: dict) -> Host:
        with self._mu:
            existing = self._hosts.get(data["id"])
            if existing is not None:
                # Refresh addresses: the server's parent entries carry the
                # host's CURRENT announce (a restarted daemon has a new
                # download_port) and resolve_host must follow it.
                existing.ip = data.get("ip", existing.ip)
                existing.port = data.get("port", existing.port)
                existing.download_port = data.get(
                    "download_port", existing.download_port
                )
                return existing
            host = host_from_wire(data)
            self._hosts[host.id] = host
            return host

    def _mirror_task(self, task_id: str, url: str) -> Task:
        with self._mu:
            task = self._tasks.get(task_id)
            if task is None:
                task = Task(task_id, url)
                self._tasks[task_id] = task
            return task

    def _mirror_parent(self, task: Task, data: dict) -> Peer:
        with self._mu:
            peer = self._peers.get(data["peer_id"])
        if peer is None:
            host = self._mirror_host(data["host"])
            peer = Peer(data["peer_id"], task, host)
            # Mirror state: remote parents are serveable by definition.
            peer.fsm.set_state("Running")
            with self._mu:
                self._peers[peer.id] = peer
        return peer

    # -- SchedulerService surface -------------------------------------------

    def announce_host(self, host: Host) -> None:
        req = {"host": host_to_wire(host)}
        if self.tenant:
            req["tenant"] = self.tenant
        if self.protocol_version >= 2:
            # The v1 shim sends NO version field — that absence is the
            # legacy dialect's signature (rpc/version.py).
            req["protocol_version"] = self.protocol_version
        resp = self._call("announce_host", req)
        proto = resp.get("protocol")
        if proto:
            # Downgrade to what the server negotiated; a v1 server
            # answers {} and we keep speaking the legacy dialect.
            self.negotiated_version = int(
                proto.get("negotiated", self.protocol_version)
            )
            self.server_capabilities = tuple(proto.get("capabilities", ()))
        elif self.protocol_version >= 2:
            # A pre-handshake server (rollback at the same URL): drop to
            # the legacy dialect AND forget the old server's advertised
            # capabilities — they described a different server.
            self.negotiated_version = 1
            self.server_capabilities = ()
        # Ring re-publication (DESIGN.md §24): the server's adopted
        # shard ring rides the announce answer; steering compositions
        # read it off the client after each announce fan-out.
        self.scheduler_ring = resp.get("scheduler_ring")
        # Tenant QoS re-publication (DESIGN.md §26): the daemon adopts
        # upload caps/weights off the same answer.
        qos = resp.get("tenant_qos")
        if isinstance(qos, dict) and qos:
            self.tenant_qos = qos
        with self._mu:
            self._hosts[host.id] = host
            self._announced.add(host.id)

    def register_peer(
        self,
        *,
        host: Host,
        url: str,
        peer_id: Optional[str] = None,
        task_id: Optional[str] = None,
        tag: str = "",
        application: str = "",
        priority=None,
        tenant: str = "",
        **_ignored,
    ) -> RegisterResult:
        with self._mu:
            announced = host.id in self._announced
        if not announced:
            # One announce per host per client; periodic re-announce is the
            # announcer's job, not every registration's.
            self.announce_host(host)
        # Client-generated peer id = idempotency key: a retried POST after a
        # timeout re-registers the SAME peer (the server's load_or_store
        # dedupes) instead of leaking an orphan.
        from ..utils import idgen

        peer_id = peer_id or idgen.peer_id(host.ip, host.hostname)
        req = {"host_id": host.id, "url": url, "peer_id": peer_id,
               "task_id": task_id, "tag": tag, "application": application,
               "tenant": tenant or self.tenant,
               "priority": int(priority) if priority is not None else 0}
        try:
            resp = self._call("register_peer", req)
        except RPCError as exc:
            from ..utils.dferrors import Code

            if exc.code != int(Code.NOT_FOUND):
                raise
            # Scheduler restarted (or GC'd the host) since our announce:
            # re-announce and retry once.
            self.announce_host(host)
            resp = self._call("register_peer", req)
        task = self._mirror_task(resp["task_id"], url)
        task.content_length = resp["content_length"]
        task.total_piece_count = resp["total_piece_count"]
        task.piece_size = resp.get("piece_size", 0)
        peer = Peer(resp["peer_id"], task, host)
        peer.fsm.set_state("ReceivedNormal")
        with self._mu:
            self._peers[peer.id] = peer

        schedule: Optional[ScheduleResult] = None
        if resp.get("need_back_to_source"):
            schedule = ScheduleResult(kind=ScheduleResultKind.NEED_BACK_TO_SOURCE)
        elif resp.get("failed"):
            schedule = ScheduleResult(kind=ScheduleResultKind.FAILED)
        elif resp.get("parents"):
            parents = [self._mirror_parent(task, p) for p in resp["parents"]]
            schedule = ScheduleResult(kind=ScheduleResultKind.PARENTS, parents=parents)
        else:
            schedule = ScheduleResult(kind=ScheduleResultKind.NEED_BACK_TO_SOURCE)
        direct = base64.b64decode(resp.get("direct_piece", "") or "")
        return RegisterResult(
            peer=peer,
            size_scope=SizeScope(resp["size_scope"]),
            schedule=schedule,
            direct_piece=direct,
        )

    def set_task_info(
        self, peer: Peer, content_length: int, total_piece_count: int, piece_size: int
    ) -> None:
        resp = self._call(
            "set_task_info",
            {
                "peer_id": peer.id,
                "content_length": content_length,
                "total_piece_count": total_piece_count,
                "piece_size": piece_size,
            },
        )
        task = peer.task
        task.content_length = resp["content_length"]
        task.total_piece_count = resp["total_piece_count"]
        task.piece_size = resp["piece_size"]

    def report_piece_finished(
        self, peer: Peer, number: int, *, parent_id: str = "", length: int = 0, cost_ns: int = 0
    ) -> None:
        peer.finish_piece(number, cost_ns, parent_id=parent_id, length=length)
        self._call(
            "report_piece_finished",
            {"peer_id": peer.id, "number": number, "parent_id": parent_id,
             "length": length, "cost_ns": cost_ns},
        )

    def report_pieces_finished(self, peer: Peer, pieces) -> None:
        """Batched piece results: ONE wire call for a linger window of
        finished pieces (the daemon's report batcher).  Mirror updates
        (Peer.finish_piece) run per entry exactly like the singles path."""
        items = []
        for p in pieces:
            number = int(p["number"])
            parent_id = p.get("parent_id", "")
            length = int(p.get("length", 0))
            cost_ns = int(p.get("cost_ns", 0))
            peer.finish_piece(number, cost_ns, parent_id=parent_id, length=length)
            items.append(
                {"number": number, "parent_id": parent_id,
                 "length": length, "cost_ns": cost_ns}
            )
        self._call(
            "report_pieces_finished", {"peer_id": peer.id, "pieces": items}
        )

    def report_piece_failed(self, peer: Peer, parent_id: str) -> ScheduleResult:
        peer.block_parents.add(parent_id)
        resp = self._call(
            "report_piece_failed", {"peer_id": peer.id, "parent_id": parent_id}
        )
        if resp.get("parents"):
            parents = [self._mirror_parent(peer.task, p) for p in resp["parents"]]
            return ScheduleResult(kind=ScheduleResultKind.PARENTS, parents=parents)
        if resp.get("need_back_to_source"):
            return ScheduleResult(kind=ScheduleResultKind.NEED_BACK_TO_SOURCE)
        return ScheduleResult(kind=ScheduleResultKind.FAILED)

    def report_peer_finished(self, peer: Peer) -> None:
        if peer.fsm.can("DownloadSucceeded"):
            peer.fsm.event("DownloadSucceeded")
        self._call("report_peer_finished", {"peer_id": peer.id})

    def report_peer_failed(self, peer: Peer) -> None:
        if peer.fsm.can("DownloadFailed"):
            peer.fsm.event("DownloadFailed")
        self._call("report_peer_failed", {"peer_id": peer.id})

    def set_task_direct_piece(self, peer: Peer, data: bytes) -> None:
        self._call(
            "set_task_direct_piece",
            {"peer_id": peer.id, "data_b64": base64.b64encode(data).decode()},
        )

    def mark_back_to_source(self, peer: Peer) -> None:
        if peer.fsm.can("DownloadBackToSource"):
            peer.fsm.event("DownloadBackToSource")
        peer.task.back_to_source_peers.add(peer.id)
        self._call("mark_back_to_source", {"peer_id": peer.id})

    def leave_peer(self, peer: Peer) -> None:
        if peer.fsm.can("Leave"):
            peer.fsm.event("Leave")
        self._call("leave_peer", {"peer_id": peer.id})

    def resolve_host(self, host_id: str) -> Tuple[str, int]:
        """host id → (ip, download_port) from the mirror table — the piece
        fetcher's address resolver."""
        with self._mu:
            host = self._hosts[host_id]
        return host.ip, host.download_port

    def sync_probes_start(self, host: Host) -> List[Host]:
        resp = self._call("sync_probes_start", {"host_id": host.id})
        return [self._mirror_host(t) for t in resp.get("targets", [])]

    def sync_probes_finished(self, host: Host, results: List[Tuple[str, int]]) -> None:
        self._call(
            "sync_probes_finished",
            {"host_id": host.id, "results": [[d, int(r)] for d, r in results]},
        )
