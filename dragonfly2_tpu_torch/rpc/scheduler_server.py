"""Scheduler HTTP/JSON server: the wire binding of SchedulerService.

Reference counterpart: scheduler/rpcserver + pkg/rpc/scheduler/server —
a gRPC surface over the service layer.  Here the same service methods are
exposed as POST /rpc/<method> with JSON bodies (stdlib ThreadingHTTPServer;
a gRPC binding can sit on the identical adapter).  The server owns the
authoritative Host/Task/Peer state; clients hold ids.

Wire methods:
  announce_host      {host: {...stats}}                 → {}
  register_peer      {host_id, url, peer_id?, task_id?, tag?, application?}
                                                        → registration view
  set_task_info      {peer_id, content_length, total_piece_count, piece_size}
  report_piece_finished / report_piece_failed / report_peer_finished /
  report_peer_failed / leave_peer                        (by peer_id)
  sync_probes_start  {host_id}                          → {targets: [...]}
  sync_probes_finished {host_id, results: [[dest, rtt]]}

Port of ``dragonfly2_tpu/rpc/scheduler_server.py``.  The wire (paths,
JSON fields, base64 payloads, ``PROTOCOL_VERSION``, status and error
codes) is the reference's byte for byte, so either package's client
talks to either package's server.  Differences: the handler opens no
span (the tracer is ROADMAP queue 1 item 10), and the announce answer
carries no ``scheduler_ring`` or ``tenant_qos`` (the shard guard and the
QoS plane, items 14 and 10, are not ported; the reference adds neither
key when they are off).  ``SchedulerHTTPServer.stats`` is new: the
server's own time per method, around the whole request and around the
service call.
"""

from __future__ import annotations

import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Tuple

from ._server import ThreadedHTTPService
from .version import (
    BASE_CAPABILITIES,
    UnsupportedProtocolError,
    negotiate,
    protocol_info,
)

from ..scheduler.resource import Host, Peer
from ..scheduler.scheduling import ScheduleResultKind
from ..scheduler.service import SchedulerService
from ..scheduler.sharding import ShardSaturatedError, WrongShardError
from ..utils.dferrors import Code
from ..utils.types import HostType


def host_from_wire(data: dict) -> Host:
    h = Host(
        id=data["id"],
        hostname=data.get("hostname", ""),
        ip=data.get("ip", ""),
        port=data.get("port", 0),
        download_port=data.get("download_port", 0),
        type=HostType(data.get("type", 0)),
        concurrent_upload_limit=data.get("concurrent_upload_limit", 50),
    )
    net = data.get("network", {})
    h.stats.network.idc = net.get("idc", "")
    h.stats.network.location = net.get("location", "")
    h.stats.cpu.percent = data.get("cpu_percent", 0.0)
    h.stats.memory.used_percent = data.get("mem_used_percent", 0.0)
    return h


def schedule_to_wire(res) -> dict:
    """ScheduleResult → the wire dict both transports use for schedule
    responses (request-paired and server-pushed alike)."""
    out = {"need_back_to_source": False, "parents": []}
    if res.kind is ScheduleResultKind.PARENTS:
        out["parents"] = [
            {"peer_id": p.id, "host": host_to_wire(p.host)} for p in res.parents
        ]
    elif res.kind is ScheduleResultKind.NEED_BACK_TO_SOURCE:
        out["need_back_to_source"] = True
    return out


def host_to_wire(h: Host) -> dict:
    return {
        "id": h.id,
        "hostname": h.hostname,
        "ip": h.ip,
        "port": h.port,
        "download_port": h.download_port,
        "type": int(h.type),
        "concurrent_upload_limit": h.concurrent_upload_limit,
        "network": {"idc": h.stats.network.idc, "location": h.stats.network.location},
    }


class SchedulerRPCAdapter:
    """Maps wire dicts ↔ the in-memory service (transport-independent)."""

    def __init__(self, service: SchedulerService) -> None:
        self.service = service
        # What THIS transport can do; the gRPC binding appends
        # "push-reschedule" (its bidi stream) — the HTTP wire must not
        # advertise pushes it cannot deliver.
        self.capabilities = tuple(BASE_CAPABILITIES)
        self._mu = threading.Lock()
        # Weak values: when the resource layer's GC reaps a peer, the wire
        # mapping evaporates with it instead of leaking one entry per
        # download for the scheduler's lifetime.
        import weakref

        self._peers: "weakref.WeakValueDictionary[str, Peer]" = (
            weakref.WeakValueDictionary()
        )

    def _peer(self, peer_id: str) -> Peer:
        with self._mu:
            peer = self._peers.get(peer_id)
        if peer is None:
            raise KeyError(f"unknown peer {peer_id}")
        return peer

    def _track(self, peer: Peer) -> None:
        with self._mu:
            self._peers[peer.id] = peer

    # -- methods -------------------------------------------------------------

    def announce_host(self, req: dict) -> dict:
        # Versioned handshake (rpc/version.py): a field-less request is
        # the v1 legacy dialect; too-old dialects get the typed refusal.
        # proto3 renders an unset int32 as 0 — both absence and 0 mean
        # the legacy v1 dialect.
        negotiated = negotiate(int(req.get("protocol_version") or 1))
        host = host_from_wire(req["host"])
        host.protocol_version = negotiated
        # The service owns the announce decode (stats refresh + columnar
        # write-on-arrival, DESIGN.md §18) — the adapter only negotiates.
        stored = self.service.announce_host(
            host, tenant=str(req.get("tenant", "") or "")
        )
        stored.protocol_version = negotiated
        return {"protocol": protocol_info(negotiated, self.capabilities)}

    def register_peer(self, req: dict) -> dict:
        host = self.service.resource.host_manager.load(req["host_id"])
        if host is None:
            raise KeyError(f"unknown host {req['host_id']} (announce first)")
        from ..utils.types import Priority

        result = self.service.register_peer(
            host=host,
            url=req["url"],
            peer_id=req.get("peer_id"),
            task_id=req.get("task_id"),
            tag=req.get("tag", ""),
            application=req.get("application", ""),
            tenant=str(req.get("tenant", "") or ""),
            # Clamp: wire clients may send out-of-range levels; an invalid
            # priority must not fail the registration.
            priority=Priority(max(0, min(6, int(req.get("priority", 0) or 0)))),
        )
        peer = result.peer
        self._track(peer)
        task = peer.task
        out = {
            "peer_id": peer.id,
            "task_id": task.id,
            "size_scope": int(result.size_scope),
            "direct_piece": base64.b64encode(result.direct_piece).decode()
            if result.direct_piece
            else "",
            "content_length": task.content_length,
            "total_piece_count": task.total_piece_count,
            "piece_size": task.piece_size,
            "need_back_to_source": False,
            "parents": [],
        }
        if result.schedule is not None:
            if result.schedule.kind is ScheduleResultKind.PARENTS:
                out["parents"] = [
                    {"peer_id": p.id, "host": host_to_wire(p.host)}
                    for p in result.schedule.parents
                ]
            elif result.schedule.kind is ScheduleResultKind.NEED_BACK_TO_SOURCE:
                out["need_back_to_source"] = True
            else:
                out["failed"] = True
        return out

    def set_task_info(self, req: dict) -> dict:
        peer = self._peer(req["peer_id"])
        self.service.set_task_info(
            peer,
            int(req["content_length"]),
            int(req["total_piece_count"]),
            int(req.get("piece_size", 4 << 20)),
        )
        task = peer.task
        return {
            "content_length": task.content_length,
            "total_piece_count": task.total_piece_count,
            "piece_size": task.piece_size,
        }

    def report_piece_finished(self, req: dict) -> dict:
        self.service.report_piece_finished(
            self._peer(req["peer_id"]),
            int(req["number"]),
            parent_id=req.get("parent_id", ""),
            length=int(req.get("length", 0)),
            cost_ns=int(req.get("cost_ns", 0)),
        )
        return {}

    def report_pieces_finished(self, req: dict) -> dict:
        self.service.report_pieces_finished(
            self._peer(req["peer_id"]),
            [
                {
                    "number": int(p["number"]),
                    "parent_id": p.get("parent_id", ""),
                    "length": int(p.get("length", 0)),
                    "cost_ns": int(p.get("cost_ns", 0)),
                }
                for p in req.get("pieces", [])
            ],
        )
        return {}

    def report_piece_failed(self, req: dict) -> dict:
        res = self.service.report_piece_failed(
            self._peer(req["peer_id"]), req.get("parent_id", "")
        )
        return schedule_to_wire(res)

    def report_peer_finished(self, req: dict) -> dict:
        self.service.report_peer_finished(self._peer(req["peer_id"]))
        return {}

    def report_peer_failed(self, req: dict) -> dict:
        self.service.report_peer_failed(self._peer(req["peer_id"]))
        return {}

    def set_task_direct_piece(self, req: dict) -> dict:
        self.service.set_task_direct_piece(
            self._peer(req["peer_id"]), base64.b64decode(req["data_b64"])
        )
        return {}

    def mark_back_to_source(self, req: dict) -> dict:
        self.service.mark_back_to_source(self._peer(req["peer_id"]))
        return {}

    def leave_peer(self, req: dict) -> dict:
        self.service.leave_peer(self._peer(req["peer_id"]))
        return {}

    def sync_probes_start(self, req: dict) -> dict:
        host = self.service.resource.host_manager.load(req["host_id"])
        if host is None:
            return {"targets": []}
        targets = self.service.sync_probes_start(host)
        return {"targets": [host_to_wire(t) for t in targets]}

    def sync_probes_finished(self, req: dict) -> dict:
        host = self.service.resource.host_manager.load(req["host_id"])
        if host is not None:
            self.service.sync_probes_finished(
                host, [(d, int(r)) for d, r in req.get("results", [])]
            )
        return {}

    def topology_rtt(self, req: dict) -> dict:
        """Observability read: THIS replica's folded probe-graph RTT for
        one edge (the nt-evaluator's ranking input) — how a deployed
        multi-replica e2e proves a probe pushed to replica A reached
        replica B's evaluator via the manager's shared-topology sync
        (the reference inspects this state in redis)."""
        nt = getattr(self.service, "networktopology", None)
        if nt is None:
            return {"rtt_ns": None}
        return {"rtt_ns": nt.average_rtt(req["src"], req["dst"])}

    METHODS = frozenset(
        {
            "announce_host",
            "register_peer",
            "set_task_info",
            "report_piece_finished",
            "report_pieces_finished",
            "report_piece_failed",
            "report_peer_finished",
            "report_peer_failed",
            "set_task_direct_piece",
            "mark_back_to_source",
            "leave_peer",
            "sync_probes_start",
            "sync_probes_finished",
            "topology_rtt",
        }
    )

    def dispatch(self, method: str, req: dict) -> dict:
        if method not in self.METHODS:
            raise KeyError(f"unknown method {method}")
        return getattr(self, method)(req)


class ServerStats:
    """Per-method request count and the server's own seconds: around
    the whole request (read, decode, dispatch, encode, write) and around
    the service call alone."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._by_method: dict = {}

    def add(self, method: str, request_s: float, service_s: float) -> None:
        with self._mu:
            row = self._by_method.setdefault(method, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += request_s
            row[2] += service_s

    def snapshot(self) -> dict:
        """{method: {"requests", "request_s", "service_s"}}."""
        with self._mu:
            return {
                m: {"requests": n, "request_s": req, "service_s": svc}
                for m, (n, req, svc) in self._by_method.items()
            }

    def reset(self) -> None:
        with self._mu:
            self._by_method.clear()


class SchedulerHTTPServer:
    """POST /rpc/<method> with JSON bodies over ThreadingHTTPServer."""

    def __init__(
        self,
        service: SchedulerService,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        rate_limit=None,
    ):
        self.adapter = SchedulerRPCAdapter(service)
        self.stats = ServerStats()
        adapter = self.adapter
        stats = self.stats

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def do_POST(self):
                t_request = time.perf_counter()
                service_s = 0.0
                if rate_limit is not None and not rate_limit.take():
                    # interceptor.go rate limiter → 429 on the JSON wire.
                    from .metrics import RATE_LIMITED_TOTAL

                    RATE_LIMITED_TOTAL.inc(transport="http")
                    body = json.dumps(
                        {"error": "rate limit exceeded",
                         "code": int(Code.RESOURCE_EXHAUSTED)}
                    ).encode()
                    self.send_response(429)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if not self.path.startswith("/rpc/"):
                    self.send_error(404)
                    return
                method = self.path[len("/rpc/") :]
                length = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                    t_service = time.perf_counter()
                    try:
                        resp = adapter.dispatch(method, req)
                    finally:
                        service_s = time.perf_counter() - t_service
                    body = json.dumps(resp).encode()
                    self.send_response(200)
                except KeyError as exc:
                    # Typed code rides the payload so clients branch on it,
                    # never on the human-readable message text.
                    body = json.dumps(
                        {"error": str(exc), "code": int(Code.NOT_FOUND)}
                    ).encode()
                    self.send_response(404)
                except UnsupportedProtocolError as exc:
                    body = json.dumps(
                        {"error": str(exc), "code": int(exc.code)}
                    ).encode()
                    self.send_response(400)
                except WrongShardError as exc:
                    # REDIRECT-style steering answer (DESIGN.md §24): 421
                    # Misdirected Request with the owning shard's address
                    # — the router re-announces there, it never retries
                    # here.
                    body = json.dumps(
                        {
                            "error": "wrong_shard",
                            "code": int(Code.FAILED_PRECONDITION),
                            "task_id": exc.task_id,
                            "owner_id": exc.owner_id,
                            "owner_url": exc.owner_url,
                            "ring_version": exc.ring_version,
                        }
                    ).encode()
                    self.send_response(421)
                except ShardSaturatedError as exc:
                    # Load shed: 503 + Retry-After (the §20 standby
                    # discipline) so a backlogged fleet backs off instead
                    # of dogpiling a melting shard.
                    body = json.dumps(
                        {
                            "error": "shard_saturated",
                            "code": int(Code.RESOURCE_EXHAUSTED),
                            "retry_after_s": exc.retry_after_s,
                            "reason": exc.reason,
                        }
                    ).encode()
                    self.send_response(503)
                    self.send_header(
                        "Retry-After", f"{exc.retry_after_s:.3f}"
                    )
                except Exception as exc:  # noqa: BLE001 — wire boundary
                    body = json.dumps(
                        {"error": str(exc), "code": int(Code.UNKNOWN)}
                    ).encode()
                    self.send_response(500)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                stats.add(method, time.perf_counter() - t_request, service_s)

        self._svc = ThreadedHTTPService(Handler, host, port, "scheduler-http")
        self.address: Tuple[str, int] = self._svc.address

    @property
    def url(self) -> str:
        return self._svc.url

    def serve(self) -> None:
        self._svc.serve()

    def stop(self) -> None:
        self._svc.stop()
