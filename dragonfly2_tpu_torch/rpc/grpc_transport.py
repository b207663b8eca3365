"""gRPC bindings of the wire adapters (binary protobuf transport).

Reference: pkg/rpc — every service speaks gRPC (scheduler server at
pkg/rpc/scheduler/server/server.go:64-95, trainer Train client stream at
pkg/rpc/trainer/client/client_v1.go:82-97).  The TPU build's adapters
(SchedulerRPCAdapter, TrainerService) are transport-independent, so this
module binds the SAME adapters the HTTP/JSON servers use onto grpc:

- messages: protos/dragonfly.proto, protoc-generated (no grpc codegen
  plugin in the image → method handlers and stubs are registered through
  grpc's generic-handler API, which is wire-identical);
- proto ↔ adapter-dict conversion via protobuf json_format with
  preserving_proto_field_name (the JSON mapping of the proto IS the
  HTTP wire schema), plus an int64 fix-up (proto3 JSON renders int64 as
  strings);
- GRPCRemoteScheduler reuses RemoteScheduler wholesale — only ``_call``
  swaps transports, so retry/mirroring/error semantics stay identical;
- Trainer.Train is a real client-streaming RPC: first chunk keys the
  session, data chunks append shards, stream end kicks training.

Port of ``dragonfly2_tpu/rpc/grpc_transport.py``.  The messages are the
reference's (``protos/`` holds byte-identical descriptors in package
``dragonfly2tpu``), so the method paths and the bytes on the wire are
equal and either package's client talks to either package's server.
This module, ``protos/`` and ``rpc/ratelimit_grpc.py`` are the only
places of the port that import ``grpc`` or ``google.protobuf``; nothing
a binary runs at its defaults imports them.  One difference:
``ManagerGRPCServer`` has no RBAC and no CA (ROADMAP queue 1 item 14):
it authorizes every call, as the reference does with no verifier, its
``issue_certificate`` answers NOT_FOUND, as the reference's does with no
CA, and a ``token_verifier``, ``users``, ``ca`` or ``server_credentials``
other than None raises naming item 14.
"""

from __future__ import annotations

import enum
import json
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import grpc
from google.protobuf.json_format import MessageToDict, ParseDict

from .protos import dragonfly_pb2 as pb
from .protos import tenantext as pbx
from .protos.batch import ReportPiecesFinishedRequest
from .scheduler_client import RemoteScheduler, RPCError

SCHEDULER_SERVICE = "dragonfly2tpu.Scheduler"
TRAINER_SERVICE = "dragonfly2tpu.Trainer"

# gRPC status → wire-stable dfcode (utils/dferrors.Code), so client-side
# recovery branches (e.g. register_peer's NOT_FOUND re-announce) behave
# identically on both transports.
def _grpc_to_dfcode():
    from ..utils.dferrors import Code

    return {
        grpc.StatusCode.NOT_FOUND: int(Code.NOT_FOUND),
        grpc.StatusCode.INVALID_ARGUMENT: int(Code.INVALID_ARGUMENT),
        grpc.StatusCode.UNAVAILABLE: int(Code.UNAVAILABLE),
        grpc.StatusCode.RESOURCE_EXHAUSTED: int(Code.RESOURCE_EXHAUSTED),
        grpc.StatusCode.FAILED_PRECONDITION: int(Code.FAILED_PRECONDITION),
    }


_GRPC_TO_DFCODE = _grpc_to_dfcode()


# -- sharded-fleet steering parity (DESIGN.md §24/§25) -----------------------
#
# The HTTP wire answers steering as 421/503 bodies; the gRPC wire maps
# the SAME typed errors onto status codes + TRAILING METADATA so a
# daemon behind either transport raises the identical exception and the
# ShardRouter follows both without knowing which wire it rides:
#
#   WrongShardError     → FAILED_PRECONDITION, df-steering=wrong_shard,
#                         df-owner-id / df-owner-url / df-ring-version
#   ShardSaturatedError → RESOURCE_EXHAUSTED, df-steering=shard_saturated,
#                         retry-after (seconds) / df-reason
#
# (RESOURCE_EXHAUSTED is shared with the rate limiter; the df-steering
# key is what disambiguates — absence keeps the plain RPCError path.)

def _steering_trailers(exc) -> tuple:
    from ..scheduler.sharding import ShardSaturatedError, WrongShardError

    if isinstance(exc, WrongShardError):
        return (
            ("df-steering", "wrong_shard"),
            ("df-task-id", exc.task_id),
            ("df-owner-id", exc.owner_id),
            ("df-owner-url", exc.owner_url),
            ("df-ring-version", str(exc.ring_version)),
        )
    assert isinstance(exc, ShardSaturatedError)
    return (
        ("df-steering", "shard_saturated"),
        ("retry-after", f"{exc.retry_after_s:.3f}"),
        ("df-reason", exc.reason),
    )


def _steering_error_from_metadata(metadata):
    """Trailing metadata → the typed steering exception, or None."""
    md = {k: v for k, v in (metadata or ())}
    kind = md.get("df-steering")
    if kind == "wrong_shard":
        from ..scheduler.sharding import WrongShardError

        try:
            version = int(md.get("df-ring-version", 0) or 0)
        except ValueError:
            version = 0
        return WrongShardError(
            md.get("df-task-id", ""),
            owner_id=md.get("df-owner-id", ""),
            owner_url=md.get("df-owner-url", ""),
            ring_version=version,
        )
    if kind == "shard_saturated":
        from ..scheduler.sharding import ShardSaturatedError

        try:
            retry_after = float(md.get("retry-after", 1.0) or 1.0)
        except ValueError:
            retry_after = 1.0
        return ShardSaturatedError(
            retry_after_s=retry_after, reason=md.get("df-reason", "")
        )
    return None


def _steering_error_to_stream(exc) -> str:
    """Bidi-stream encoding: the response's ``error`` field carries the
    steering payload as ``<kind>:<json>`` (streams have no per-message
    trailers to ride)."""
    from ..scheduler.sharding import WrongShardError

    if isinstance(exc, WrongShardError):
        return "wrong_shard:" + json.dumps({
            "task_id": exc.task_id,
            "owner_id": exc.owner_id,
            "owner_url": exc.owner_url,
            "ring_version": exc.ring_version,
        })
    return "shard_saturated:" + json.dumps({
        "retry_after_s": exc.retry_after_s,
        "reason": exc.reason,
    })


def _steering_error_from_stream(error: str):
    """Stream ``error`` field → the typed steering exception, or None."""
    for kind in ("wrong_shard", "shard_saturated"):
        prefix = kind + ":"
        if not error.startswith(prefix):
            continue
        try:
            payload = json.loads(error[len(prefix):])
        except (ValueError, TypeError):
            return None
        if kind == "wrong_shard":
            from ..scheduler.sharding import WrongShardError

            return WrongShardError(
                str(payload.get("task_id", "")),
                owner_id=str(payload.get("owner_id", "")),
                owner_url=str(payload.get("owner_url", "")),
                ring_version=int(payload.get("ring_version", 0) or 0),
            )
        from ..scheduler.sharding import ShardSaturatedError

        return ShardSaturatedError(
            retry_after_s=float(payload.get("retry_after_s", 1.0) or 1.0),
            reason=str(payload.get("reason", "")),
        )
    return None


def _iter_until_closed(request_iterator):
    """Drain a server-side request stream, treating client cancel/close
    (grpc.RpcError mid-iteration) as normal end-of-stream."""
    while True:
        try:
            yield next(request_iterator)
        except StopIteration:
            return
        except grpc.RpcError:
            return

# method → (request message, response message); mirrors
# SchedulerRPCAdapter.METHODS exactly.
SCHEDULER_METHODS = {
    # announce_host/register_peer ride the tenant-extended messages
    # (protos/tenantext.py): same field numbers plus the §26 tenant
    # stamp the JSON dialect already carries.
    "announce_host": (pbx.AnnounceHostRequest, pb.AnnounceHostResponse),
    "register_peer": (pbx.RegisterPeerRequest, pb.RegisterPeerResponse),
    "set_task_info": (pb.SetTaskInfoRequest, pb.TaskInfoResponse),
    "report_piece_finished": (pb.ReportPieceFinishedRequest, pb.Empty),
    "report_pieces_finished": (ReportPiecesFinishedRequest, pb.Empty),
    "report_piece_failed": (pb.ReportPieceFailedRequest, pb.ScheduleResponse),
    "report_peer_finished": (pb.PeerRequest, pb.Empty),
    "report_peer_failed": (pb.PeerRequest, pb.Empty),
    "set_task_direct_piece": (pb.DirectPieceRequest, pb.Empty),
    "mark_back_to_source": (pb.PeerRequest, pb.Empty),
    "leave_peer": (pb.PeerRequest, pb.Empty),
    "sync_probes_start": (pb.HostRequest, pb.SyncProbesStartResponse),
    "sync_probes_finished": (pb.SyncProbesFinishedRequest, pb.Empty),
}

# proto3's JSON mapping renders int64 as decimal strings; the adapters
# expect Python ints for these keys (at any nesting level).
_INT64_KEYS = frozenset(
    {"content_length", "length", "cost_ns", "rtt_ns", "seq",
     "download_rows", "topology_rows"}
)


def _fix_int64(obj):
    if isinstance(obj, dict):
        return {
            k: int(v) if k in _INT64_KEYS and isinstance(v, str) else _fix_int64(v)
            for k, v in obj.items()
        }
    if isinstance(obj, list):
        return [_fix_int64(v) for v in obj]
    return obj


def proto_to_dict(msg) -> dict:
    # Defaults emitted: the adapters and RemoteScheduler index required
    # keys (resp["content_length"]) — the dict must match the HTTP wire
    # exactly, not protobuf's sparse JSON.
    return _fix_int64(
        MessageToDict(
            msg,
            preserving_proto_field_name=True,
            always_print_fields_with_no_presence=True,
        )
    )


def dict_to_proto(data: dict, msg_cls):
    return ParseDict(data, msg_cls(), ignore_unknown_fields=True)


def dict_to_proto_into(data: dict, msg) -> None:
    """Parse into an existing submessage (selects its oneof arm even when
    every field is default — SetInParent marks presence)."""
    msg.SetInParent()
    ParseDict(data, msg, ignore_unknown_fields=True)


def _to_wire_probe_results(req: dict) -> dict:
    """sync_probes_finished carries (dest, rtt) pairs in the dict schema;
    the proto uses ProbeResult messages."""
    out = dict(req)
    out["results"] = [
        {"dest": d, "rtt_ns": int(r)} for d, r in req.get("results", [])
    ]
    return out


def _from_wire_probe_results(req: dict) -> dict:
    out = dict(req)
    out["results"] = [
        (r.get("dest", ""), int(r.get("rtt_ns", 0)))
        for r in req.get("results", [])
    ]
    return out


class SchedulerGRPCServer:
    """Binds a SchedulerRPCAdapter onto a grpc server.

    Besides the unary methods, serves the bidi ``announce_peer`` stream
    (service_v2.go:89-207 AnnouncePeer analog): a PeerStreamHub is
    attached to the service so scheduling decisions made outside a peer's
    own request cycle (bad parents, parent death, stalls) are PUSHED to
    connected peers as seq=0 responses.
    """

    def __init__(
        self,
        service,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        max_workers: int = 16,
        server_credentials: Optional[grpc.ServerCredentials] = None,
        rate_limit=None,
    ) -> None:
        from ..scheduler.push import PeerStreamHub
        from .scheduler_server import SchedulerRPCAdapter

        self.adapter = SchedulerRPCAdapter(service)
        # This binding HAS the bidi push stream; advertise it.
        self.adapter.capabilities = self.adapter.capabilities + (
            "push-reschedule",
        )
        # Share the service's hub if the composition root made one;
        # otherwise create it (tests construct the server directly).
        if getattr(service, "hub", None) is None:
            service.hub = PeerStreamHub()
        self.hub = service.hub
        interceptors = ()
        if rate_limit is not None:
            from .ratelimit import RateLimitInterceptor

            interceptors = (RateLimitInterceptor(rate_limit),)
        self._server = grpc.server(
            ThreadPoolExecutor(max_workers=max_workers),
            interceptors=interceptors,
        )

        handlers = {}
        for method, (req_cls, resp_cls) in SCHEDULER_METHODS.items():
            handlers[method] = grpc.unary_unary_rpc_method_handler(
                self._behavior(method, resp_cls),
                request_deserializer=req_cls.FromString,
                response_serializer=lambda m: m.SerializeToString(),
            )
        handlers["announce_peer"] = grpc.stream_stream_rpc_method_handler(
            self._announce_peer,
            request_deserializer=pbx.AnnouncePeerRequest.FromString,
            response_serializer=lambda m: m.SerializeToString(),
        )
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SCHEDULER_SERVICE, handlers),)
        )
        addr = f"{host}:{port}"
        if server_credentials is not None:
            bound = self._server.add_secure_port(addr, server_credentials)
        else:
            bound = self._server.add_insecure_port(addr)
        self.address: Tuple[str, int] = (host, bound)

    # oneof payload field → (adapter method, response oneof field)
    _STREAM_DISPATCH = {
        "register": ("register_peer", "registration"),
        "task_info": ("set_task_info", "task_info"),
        "piece_finished": ("report_piece_finished", "ack"),
        "piece_failed": ("report_piece_failed", "schedule"),
        "peer_finished": ("report_peer_finished", "ack"),
        "peer_failed": ("report_peer_failed", "ack"),
        "back_to_source": ("mark_back_to_source", "ack"),
        "leave": ("leave_peer", "ack"),
        "direct_piece": ("set_task_direct_piece", "ack"),
    }

    def _announce_peer(self, request_iterator, context):
        """One generator per connected daemon: requests demux to the same
        adapter the unary wire uses; a writer queue serializes the
        request-paired responses with hub pushes."""
        import queue
        import threading

        from ..scheduler.sharding import ShardSaturatedError, WrongShardError
        from ..utils.tracing import TRACEPARENT_HEADER, default_tracer
        from .metrics import GRPC_REQUESTS_TOTAL
        from .scheduler_server import schedule_to_wire

        # The stream's traceparent arrives ONCE in the invocation
        # metadata (one bidi stream per daemon); every dispatched message
        # opens its handler span against it so the stream wire has the
        # same flight-recorder coverage as the unary wire (DF016).
        stream_traceparent = None
        for key, value in context.invocation_metadata():
            if key == TRACEPARENT_HEADER:
                stream_traceparent = value

        out: "queue.Queue" = queue.Queue()
        registered: dict = {}  # peer_id → THIS stream's push callback

        def make_push(peer_id: str):
            def push(result) -> None:
                msg = pb.AnnouncePeerResponse(seq=0, peer_id=peer_id)
                dict_to_proto_into(schedule_to_wire(result), msg.schedule)
                out.put(msg)
            return push

        def reader() -> None:
            try:
                it = _iter_until_closed(request_iterator)
                for req in it:
                    kind = req.WhichOneof("payload")
                    resp = pb.AnnouncePeerResponse(seq=req.seq)
                    if kind == "resume":
                        # Reconnect: re-attach the push channel for a peer
                        # registered on a PREVIOUS stream (whose teardown
                        # unregistered it) — no adapter dispatch, so no
                        # duplicate peer records (ADVICE r2 finding).
                        # Validated against the adapter's live-peer table:
                        # a bogus/stale id must not leak a hub channel
                        # (cross-peer trust stays at the transport's mTLS
                        # layer, as for every other peer_id-carrying
                        # message on this stream).
                        pid = req.resume.peer_id
                        known = True
                        if pid:
                            try:
                                self.adapter._peer(pid)
                            except KeyError:
                                known = False
                        if pid and not known:
                            from ..utils.dferrors import Code

                            resp.error = f"resume: unknown peer {pid}"
                            resp.code = int(Code.NOT_FOUND)
                        elif pid:
                            registered[pid] = make_push(pid)
                            self.hub.register(pid, registered[pid])
                        out.put(resp)
                        continue
                    entry = self._STREAM_DISPATCH.get(kind)
                    if entry is None:
                        resp.error, resp.code = f"unknown payload {kind}", 0
                        out.put(resp)
                        continue
                    method, body_field = entry
                    try:
                        with default_tracer.remote_span(
                            f"rpc/{method}", stream_traceparent,
                            transport="grpc-stream",
                        ):
                            body = self.adapter.dispatch(
                                method, proto_to_dict(getattr(req, kind))
                            )
                        dict_to_proto_into(body, getattr(resp, body_field))
                        GRPC_REQUESTS_TOTAL.inc(
                            service="scheduler", method=f"stream/{method}",
                            code="OK",
                        )
                        if method == "register_peer":
                            pid = body["peer_id"]
                            registered[pid] = make_push(pid)
                            self.hub.register(pid, registered[pid])
                        elif method == "leave_peer":
                            pid = proto_to_dict(getattr(req, kind)).get(
                                "peer_id", ""
                            )
                            own = registered.pop(pid, None)
                            self.hub.unregister(pid, own)
                    except KeyError as exc:
                        from ..utils.dferrors import Code

                        resp.error, resp.code = str(exc), int(Code.NOT_FOUND)
                        GRPC_REQUESTS_TOTAL.inc(
                            service="scheduler", method=f"stream/{method}",
                            code="NOT_FOUND",
                        )
                    except (WrongShardError, ShardSaturatedError) as exc:
                        # Steering parity on the bidi wire: the typed
                        # payload rides the response error field (streams
                        # have no per-message trailers) and the client
                        # re-raises the SAME exception the HTTP wire
                        # would (§24/§25).
                        from ..utils.dferrors import Code

                        resp.error = _steering_error_to_stream(exc)
                        resp.code = int(
                            Code.FAILED_PRECONDITION
                            if isinstance(exc, WrongShardError)
                            else Code.RESOURCE_EXHAUSTED
                        )
                        GRPC_REQUESTS_TOTAL.inc(
                            service="scheduler", method=f"stream/{method}",
                            code=(
                                "FAILED_PRECONDITION"
                                if isinstance(exc, WrongShardError)
                                else "RESOURCE_EXHAUSTED"
                            ),
                        )
                    except Exception as exc:  # noqa: BLE001 — wire boundary
                        resp.error, resp.code = str(exc), 0
                        GRPC_REQUESTS_TOTAL.inc(
                            service="scheduler", method=f"stream/{method}",
                            code="UNKNOWN",
                        )
                    out.put(resp)
            finally:
                # The reader is the SOLE owner of `registered` (the
                # response generator must not clean up concurrently — a
                # client cancel would race its iteration against our
                # adds and leak hub registrations bound to a dead queue).
                # Ownership-aware: only evict channels still bound to THIS
                # stream — a reconnected stream's resume may already have
                # replaced them, and this (late) teardown must not undo it.
                for pid, own in registered.items():
                    self.hub.unregister(pid, own)
                out.put(None)

        t = threading.Thread(target=reader, name="announce-reader", daemon=True)
        t.start()
        while True:
            # Bounded get + loop (DF008 timeout sweep): the None sentinel
            # still terminates; the timeout only guarantees this thread
            # is visible in watchdog dumps instead of parked forever.
            try:
                item = out.get(timeout=30.0)
            except queue.Empty:
                continue
            if item is None:
                return
            yield item

    def _behavior(self, method: str, resp_cls):
        from .metrics import GRPC_REQUESTS_TOTAL

        def handle(request, context):
            # Exactly ONE count per call, whatever the outcome — error
            # spikes must be visible in rpc_grpc_requests_total.
            counted = [False]

            def count(code: str) -> None:
                if not counted[0]:
                    counted[0] = True
                    GRPC_REQUESTS_TOTAL.inc(
                        service="scheduler", method=method, code=code
                    )

            try:
                from ..utils.tracing import TRACEPARENT_HEADER, default_tracer

                traceparent = None
                for key, value in context.invocation_metadata():
                    if key == TRACEPARENT_HEADER:
                        traceparent = value
                req = proto_to_dict(request)
                if method == "sync_probes_finished":
                    req = _from_wire_probe_results(req)
                from ..scheduler.sharding import (
                    ShardSaturatedError,
                    WrongShardError,
                )

                try:
                    # otelgrpc server-interceptor analog: handler span
                    # linked into the caller's trace.
                    with default_tracer.remote_span(
                        f"rpc/{method}", traceparent, transport="grpc"
                    ):
                        out = self.adapter.dispatch(method, req)
                except KeyError as exc:
                    count("NOT_FOUND")
                    context.abort(grpc.StatusCode.NOT_FOUND, str(exc))
                except WrongShardError as exc:
                    # Steering parity with the HTTP 421 answer (§24): a
                    # typed status + trailing metadata carrying the
                    # owner hint, so the client re-announces there.
                    count("FAILED_PRECONDITION")
                    context.set_trailing_metadata(_steering_trailers(exc))
                    context.abort(
                        grpc.StatusCode.FAILED_PRECONDITION, "wrong_shard"
                    )
                except ShardSaturatedError as exc:
                    # Load shed parity with HTTP 503 + Retry-After.
                    count("RESOURCE_EXHAUSTED")
                    context.set_trailing_metadata(_steering_trailers(exc))
                    context.abort(
                        grpc.StatusCode.RESOURCE_EXHAUSTED, "shard_saturated"
                    )
                except (ValueError, TypeError) as exc:
                    count("INVALID_ARGUMENT")
                    context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
                resp = dict_to_proto(out, resp_cls)
            except Exception:
                count("UNKNOWN")  # no-op on the already-counted abort paths
                raise
            count("OK")
            return resp

        return handle

    @property
    def target(self) -> str:
        return f"{self.address[0]}:{self.address[1]}"

    def serve(self) -> None:
        self._server.start()

    def stop(self, grace: float = 0.5) -> None:
        self._server.stop(grace)


class GRPCRemoteScheduler(RemoteScheduler):
    """RemoteScheduler over gRPC: same mirrors/retries/errors, binary
    transport.  ``target`` is host:port."""

    def __init__(
        self,
        target: str,
        *,
        timeout: float = 10.0,
        channel_credentials: Optional[grpc.ChannelCredentials] = None,
        protocol_version: Optional[int] = None,
    ) -> None:
        # base_url is only used by HTTP _call, which we override.
        super().__init__(
            f"grpc://{target}", timeout=timeout,
            protocol_version=protocol_version,
        )
        if channel_credentials is not None:
            self._channel = grpc.secure_channel(target, channel_credentials)
        else:
            self._channel = grpc.insecure_channel(target)
        self._stubs = {}
        for method, (req_cls, resp_cls) in SCHEDULER_METHODS.items():
            self._stubs[method] = self._channel.unary_unary(
                f"/{SCHEDULER_SERVICE}/{method}",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=resp_cls.FromString,
            )

    def _call(
        self, method: str, req: dict, *, deadline_s: Optional[float] = None
    ) -> dict:
        from .retry import retry_call

        req_cls, _ = SCHEDULER_METHODS[method]
        if method == "sync_probes_finished":
            req = _to_wire_probe_results(req)
        msg = dict_to_proto(req, req_cls)

        def once():
            from ..utils import faultinject
            from ..utils.tracing import default_tracer

            faultinject.fire(f"grpc.client.{method}")
            metadata = tuple(default_tracer.inject().items()) or None
            try:
                return self._stubs[method](
                    msg, timeout=self.timeout, metadata=metadata
                )
            except grpc.RpcError as exc:
                code = exc.code()
                # Steering answers surface as their typed exceptions on
                # BOTH transports (§24/§25): the ShardRouter acts on
                # them identically, never knowing which wire it rode.
                steering = _steering_error_from_metadata(
                    exc.trailing_metadata()
                    if hasattr(exc, "trailing_metadata") else None
                )
                if steering is not None:
                    raise steering from exc
                if code in (
                    grpc.StatusCode.UNAVAILABLE,
                    grpc.StatusCode.DEADLINE_EXCEEDED,
                ):
                    # Transient: same retry class as the HTTP transport's
                    # ConnectionError/TimeoutError set.
                    raise ConnectionError(
                        f"{method}: gRPC {code.name}: {exc.details()}"
                    ) from exc
                raise RPCError(
                    f"{method}: gRPC {code.name}: {exc.details()}",
                    code=_GRPC_TO_DFCODE.get(code, 0),
                ) from exc

        resp = retry_call(
            once,
            retry_on=(ConnectionError, TimeoutError, OSError),
            deadline_s=deadline_s,
        )
        return proto_to_dict(resp)

    def close(self) -> None:
        self._channel.close()


class GRPCStreamingScheduler(GRPCRemoteScheduler):
    """RemoteScheduler whose per-peer methods ride ONE bidi
    ``announce_peer`` stream instead of per-call unary RPCs — the v2 wire:
    piece results flow up the stream, and the scheduler can PUSH parent
    lists down mid-download (seq=0 responses), consumed by the conductor
    via ``take_pushed_schedule``.

    announce_host / sync_probes stay unary (they are host-scoped, not
    download-scoped — the reference keeps them on separate RPCs too).
    On any stream failure the affected call falls back to the unary stub,
    so a mid-download scheduler restart degrades to round-1 behavior
    instead of failing the download.
    """

    # adapter method → request oneof field
    _STREAM_FIELDS = {
        "register_peer": ("register", pbx.RegisterPeerRequest),
        "set_task_info": ("task_info", pb.SetTaskInfoRequest),
        "report_piece_finished": ("piece_finished", pb.ReportPieceFinishedRequest),
        "report_piece_failed": ("piece_failed", pb.ReportPieceFailedRequest),
        "report_peer_finished": ("peer_finished", pb.PeerRequest),
        "report_peer_failed": ("peer_failed", pb.PeerRequest),
        "mark_back_to_source": ("back_to_source", pb.PeerRequest),
        "leave_peer": ("leave", pb.PeerRequest),
        "set_task_direct_piece": ("direct_piece", pb.DirectPieceRequest),
    }
    _RESPONSE_BODY = {
        "registration": pb.RegisterPeerResponse,
        "schedule": pb.ScheduleResponse,
        "task_info": pb.TaskInfoResponse,
    }

    def __init__(self, target: str, **kwargs) -> None:
        super().__init__(target, **kwargs)
        import queue
        import threading

        self._stream_mu = threading.Lock()
        self._sendq: Optional["queue.Queue"] = None
        self._waiters: dict = {}          # seq → (Event, [resp])
        self._pushed: dict = {}           # peer_id → latest pushed dict
        self._active_peers: set = set()   # downloads whose pushes we want
        self._seq = 0
        self._stream_stub = self._channel.stream_stream(
            f"/{SCHEDULER_SERVICE}/announce_peer",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.AnnouncePeerResponse.FromString,
        )

    # -- stream lifecycle ---------------------------------------------------

    def _ensure_stream(self):
        import queue
        import threading

        with self._stream_mu:
            if self._sendq is not None:
                return
            self._sendq = queue.Queue()
            sendq = self._sendq

            def request_iter():
                while True:
                    # Bounded get + loop (DF008 timeout sweep); the None
                    # sentinel still shuts the stream down.
                    try:
                        item = sendq.get(timeout=30.0)
                    except queue.Empty:
                        continue
                    if item is None:
                        return
                    yield item

            # Stream-scoped traceparent: the download span active at
            # stream open rides the invocation metadata once; the server
            # links every per-message handler span to it (the unary wire
            # injects per call — a stream only gets this one chance).
            from ..utils.tracing import default_tracer

            call = self._stream_stub(
                request_iter(),
                metadata=tuple(default_tracer.inject().items()) or None,
            )

            def read_loop():
                try:
                    for resp in call:
                        if resp.seq == 0:
                            body = resp.WhichOneof("body")
                            if body == "schedule" and resp.peer_id:
                                with self._stream_mu:
                                    # Bounded: a push racing a download's
                                    # completion must not accumulate
                                    # forever (terminal calls also clear
                                    # their entry).
                                    while len(self._pushed) >= 512:
                                        self._pushed.pop(
                                            next(iter(self._pushed))
                                        )
                                    self._pushed[resp.peer_id] = proto_to_dict(
                                        resp.schedule
                                    )
                            continue
                        with self._stream_mu:
                            waiter = self._waiters.pop(resp.seq, None)
                        if waiter is not None:
                            waiter[1].append(resp)
                            waiter[0].set()
                except Exception as exc:  # noqa: BLE001 — stream died
                    logging.getLogger(__name__).debug(
                        "announce stream read loop died: %s", exc
                    )
                finally:
                    # Wake every in-flight caller so they fall back to unary
                    # instead of blocking out the timeout.  Only clear the
                    # queue if it is still OURS — a reconnect may have
                    # already installed a fresh one.
                    with self._stream_mu:
                        dead = list(self._waiters.values())
                        self._waiters.clear()
                        if self._sendq is sendq:
                            self._sendq = None
                    for ev, _slot in dead:
                        ev.set()

            threading.Thread(
                target=read_loop, name="announce-read", daemon=True
            ).start()

            # Reconnect: the old stream's server-side teardown unregistered
            # every push channel — re-attach them for in-flight downloads
            # (resume carries no adapter dispatch, so no duplicate peers).
            # Fire-and-forget: the acks correlate to seqs nobody waits on.
            for pid in self._active_peers:
                self._seq += 1
                msg = pbx.AnnouncePeerRequest(seq=self._seq)
                msg.resume.peer_id = pid
                sendq.put(msg)

    def _stream_call(self, method: str, req: dict) -> dict:
        import threading

        field, req_cls = self._STREAM_FIELDS[method]
        self._ensure_stream()
        with self._stream_mu:
            self._seq += 1
            seq = self._seq
            ev: threading.Event = threading.Event()
            slot: list = []
            self._waiters[seq] = (ev, slot)
            sendq = self._sendq
        msg = pbx.AnnouncePeerRequest(seq=seq)
        dict_to_proto_into(req, getattr(msg, field))
        try:
            if sendq is None:
                raise ConnectionError("announce stream closed")
            sendq.put(msg)
            if not ev.wait(self.timeout) or not slot:
                raise ConnectionError(f"{method}: announce stream no response")
        finally:
            with self._stream_mu:
                self._waiters.pop(seq, None)
        # A finished download stops consuming pushes — drop any stale one.
        if method in ("report_peer_finished", "report_peer_failed", "leave_peer"):
            with self._stream_mu:
                self._pushed.pop(req.get("peer_id", ""), None)
        resp = slot[0]
        if resp.error:
            steering = _steering_error_from_stream(resp.error)
            if steering is not None:
                raise steering
            raise RPCError(f"{method}: {resp.error}", code=resp.code)
        body = resp.WhichOneof("body")
        return proto_to_dict(getattr(resp, body)) if body else {}

    def _call(self, method: str, req: dict) -> dict:
        if method not in self._STREAM_FIELDS:
            return super()._call(method, req)
        try:
            out = self._stream_call(method, req)
        except ConnectionError:
            # Stream broken (scheduler restart, network blip): unary
            # fallback keeps the download alive; next call retries the
            # stream via _ensure_stream.
            out = super()._call(method, req)
        # Track in-flight downloads so a reconnected stream can resume
        # their push registrations (covers unary-registered peers too —
        # their pushes come alive when a stream next establishes).
        if method == "register_peer" and out.get("peer_id"):
            with self._stream_mu:
                self._active_peers.add(out["peer_id"])
        elif method in (
            "report_peer_finished", "report_peer_failed", "leave_peer"
        ):
            with self._stream_mu:
                self._active_peers.discard(req.get("peer_id", ""))
        return out

    # -- pushed reschedules (conductor seam) --------------------------------

    def take_pushed_schedule(self, peer) -> Optional["object"]:
        """Latest server-pushed schedule for this peer, as a
        ScheduleResult with mirrored parents — or None."""
        from ..scheduler.scheduling import ScheduleResult, ScheduleResultKind

        with self._stream_mu:
            resp = self._pushed.pop(peer.id, None)
        if resp is None:
            return None
        if resp.get("parents"):
            parents = [
                self._mirror_parent(peer.task, p) for p in resp["parents"]
            ]
            return ScheduleResult(
                kind=ScheduleResultKind.PARENTS, parents=parents
            )
        if resp.get("need_back_to_source"):
            return ScheduleResult(kind=ScheduleResultKind.NEED_BACK_TO_SOURCE)
        return None

    def close(self) -> None:
        with self._stream_mu:
            sendq = self._sendq
            self._sendq = None
        if sendq is not None:
            sendq.put(None)
        super().close()


# 128 MiB protocol chunk + proto/field overhead headroom.
_TRAIN_MSG_CAP = (128 << 20) + (1 << 20)


class TrainerGRPCServer:
    """Trainer.Train client-streaming ingest + run-status lookups."""

    def __init__(
        self,
        service,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        max_workers: int = 8,
    ) -> None:
        if service.data_dir is None:
            raise ValueError("remote ingest requires TrainerService(data_dir=...)")
        self.service = service
        # The Train protocol frames datasets in 128 MiB chunks
        # (announcer.go:39-41); gRPC's default 4 MiB message cap would
        # reject the FIRST real chunk (caught by tools/bench_wire_ingest
        # — the tests' tiny shards never hit it).
        self._server = grpc.server(
            ThreadPoolExecutor(max_workers=max_workers),
            options=[("grpc.max_receive_message_length", _TRAIN_MSG_CAP)],
        )
        handlers = {
            "Train": grpc.stream_unary_rpc_method_handler(
                self._train,
                request_deserializer=pb.TrainChunk.FromString,
                response_serializer=lambda m: m.SerializeToString(),
            ),
            "RunStatus": grpc.unary_unary_rpc_method_handler(
                self._run_status,
                request_deserializer=pb.RunStatusRequest.FromString,
                response_serializer=lambda m: m.SerializeToString(),
            ),
        }
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(TRAINER_SERVICE, handlers),)
        )
        bound = self._server.add_insecure_port(f"{host}:{port}")
        self.address: Tuple[str, int] = (host, bound)

    def _train(self, request_iterator, context):
        session = None
        for chunk in request_iterator:
            if session is None:
                # First message keys the per-host dataset files
                # (service_v1.go:85-88 HostIDV2 keying).
                session = self.service.open_train_stream(
                    ip=chunk.ip, hostname=chunk.hostname,
                    scheduler_id=chunk.scheduler_id,
                )
                if not chunk.data:
                    continue
            self.service.receive_shard_bytes(
                session, chunk.kind or "download", chunk.name or "shard",
                bytes(chunk.data), seq=int(chunk.seq),
            )
        if session is None:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "empty Train stream")
        # EOF → train (service_v1.go:153-158; async like the goroutine).
        key = session.close_and_train(synchronous=False)
        return pb.TrainReply(run=key)

    def _run_status(self, request, context):
        run = self.service.runs.get(request.key)
        if run is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"unknown run {request.key}")
        return pb.RunStatusReply(
            key=run.key,
            done=run.done.is_set(),
            error=run.error or "",
            download_rows=run.download_rows,
            topology_rows=run.topology_rows,
            models=list(run.models),
            metrics_json=json.dumps(
                {k: m.to_dict() for k, m in run.metrics.items()}
            ),
        )

    @property
    def target(self) -> str:
        return f"{self.address[0]}:{self.address[1]}"

    def serve(self) -> None:
        self._server.start()

    def stop(self, grace: float = 0.5) -> None:
        self._server.stop(grace)


MANAGER_SERVICE = "dragonfly2tpu.Manager"


class Role(enum.IntEnum):
    """The reference's ordered roles (``security/tokens.Role``): the tier
    each manager call would require once tokens are ported."""

    READONLY = 0
    PEER = 1       # daemons/schedulers: announce, register, report
    OPERATOR = 2   # model activation, preheat
    ADMIN = 3


def _model_to_proto(m) -> "pb.WireModel":
    return pb.WireModel(
        id=m.id, name=m.name, type=m.type, version=m.version,
        scheduler_id=m.scheduler_id, state=m.state.value,
        evaluation_json=json.dumps(m.evaluation),
    )


class ManagerGRPCServer:
    """Manager control plane over gRPC (manager/rpcserver v1/v2 analog):
    model registry RPCs incl. CreateModel, scheduler registration +
    keepalive, cluster search.

    The reference's ``token_verifier`` / ``users`` (bearer tokens at the
    REST surface's role tiers), ``ca`` (certificate issuance) and
    ``server_credentials`` (TLS) come with ROADMAP queue 1 item 14; until
    then each must be None and every call is authorized, as in the
    reference with no verifier."""

    def __init__(
        self,
        registry,
        clusters,
        searcher=None,
        scheduler_clusters=None,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        max_workers: int = 16,
        token_verifier=None,
        users=None,
        rate_limit=None,
        server_credentials: Optional[grpc.ServerCredentials] = None,
        ca=None,
    ) -> None:
        from ..manager.searcher import Searcher

        for name, value in (
            ("token_verifier", token_verifier), ("users", users), ("ca", ca),
            ("server_credentials", server_credentials),
        ):
            if value is not None:
                raise NotImplementedError(
                    f"ManagerGRPCServer({name}=...): the manager's RBAC, CA and "
                    "TLS are not ported yet (ROADMAP queue 1 item 14)"
                )
        self.registry = registry
        self.clusters = clusters
        self.searcher = searcher or Searcher()
        self.scheduler_clusters = scheduler_clusters or []
        # ONE bucket with the REST surface (cli/manager wires the same
        # instance): the configured qps bounds the SERVICE, not each
        # transport separately (scheduler CLI precedent).
        interceptors = ()
        if rate_limit is not None:
            from .ratelimit import RateLimitInterceptor

            interceptors = (RateLimitInterceptor(rate_limit),)
        self._server = grpc.server(
            ThreadPoolExecutor(max_workers=max_workers),
            interceptors=interceptors,
        )
        methods = {
            # name: (fn, req, resp, required role — None = open read)
            "create_model": (self._create_model, pb.CreateModelRequest, pb.WireModel, Role.PEER),
            "get_model": (self._get_model, pb.ModelIdRequest, pb.WireModel, None),
            "list_models": (self._list_models, pb.ListModelsRequest, pb.ListModelsReply, None),
            "active_model": (self._active_model, pb.ActiveModelRequest, pb.WireModel, None),
            "activate_model": (self._activate, pb.ModelIdRequest, pb.WireModel, Role.OPERATOR),
            "deactivate_model": (self._deactivate, pb.ModelIdRequest, pb.WireModel, Role.OPERATOR),
            "model_artifact": (self._artifact, pb.ModelIdRequest, pb.ArtifactReply, None),
            "register_scheduler": (self._register_scheduler, pb.RegisterSchedulerRequest, pb.Empty, Role.PEER),
            "keepalive": (self._keepalive, pb.KeepaliveRequest, pb.KeepaliveReply, Role.PEER),
            "list_schedulers": (self._list_schedulers, pb.Empty, pb.ListSchedulersReply, None),
            "search_clusters": (self._search, pb.ClusterSearchRequest, pb.ClusterSearchReply, None),
            "issue_certificate": (self._issue_certificate, pb.CertificateRequest, pb.CertificateReply, Role.PEER),
        }
        handlers = {}
        for name, (fn, req_cls, _resp_cls, role) in methods.items():
            handlers[name] = grpc.unary_unary_rpc_method_handler(
                self._wrap(fn, role),
                request_deserializer=req_cls.FromString,
                response_serializer=lambda m: m.SerializeToString(),
            )
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(MANAGER_SERVICE, handlers),)
        )
        bound = self._server.add_insecure_port(f"{host}:{port}")
        self.address: Tuple[str, int] = (host, bound)

    def _wrap(self, fn, required_role):
        # required_role is the reference's tier for the call; with no
        # verifier (the only configuration here) every call passes.
        def handle(request, context):
            try:
                return fn(request, context)
            except KeyError as exc:
                context.abort(grpc.StatusCode.NOT_FOUND, str(exc))
            except (ValueError, TypeError) as exc:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))

        return handle

    # -- model registry (manager_server_v1.go:802-901 + service/model.go) --

    def _create_model(self, req, context):
        m = self.registry.create_model(
            name=req.name, type=req.type, scheduler_id=req.scheduler_id,
            artifact=bytes(req.artifact),
            evaluation=json.loads(req.evaluation_json or "{}"),
        )
        return _model_to_proto(m)

    def _get_model(self, req, context):
        m = self.registry.get(req.id)
        if m is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"model {req.id}")
        return _model_to_proto(m)

    def _list_models(self, req, context):
        models = self.registry.list(
            scheduler_id=req.scheduler_id or None, name=req.name or None
        )
        return pb.ListModelsReply(models=[_model_to_proto(m) for m in models])

    def _active_model(self, req, context):
        m = self.registry.active_model(req.scheduler_id, req.name)
        if m is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "no active model")
        return _model_to_proto(m)

    def _activate(self, req, context):
        return _model_to_proto(self.registry.activate(req.id))

    def _deactivate(self, req, context):
        return _model_to_proto(self.registry.deactivate(req.id))

    def _artifact(self, req, context):
        m = self.registry.get(req.id)
        if m is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"model {req.id}")
        try:
            blob = self.registry.load_artifact(m)
        except (KeyError, OSError, ValueError) as exc:
            # Missing blob OR a failed digest check (ArtifactDigestError):
            # a clean NOT_FOUND — unverifiable bytes never leave the
            # registry on this wire either.
            context.abort(grpc.StatusCode.NOT_FOUND, f"artifact unavailable: {exc}")
        return pb.ArtifactReply(artifact=blob)

    # -- certificate issuance (pkg/issuer, security_server.go) --------------

    def _issue_certificate(self, req, context):
        # No cluster CA in this package (item 14): the reference's answer
        # with ca=None.
        context.abort(grpc.StatusCode.NOT_FOUND, "no cluster CA configured")

    # -- clusters (manager_server_v2.go keepalive, searcher) ----------------

    def _register_scheduler(self, req, context):
        from ..manager.cluster import SchedulerInstance

        self.clusters.register_scheduler(
            SchedulerInstance(
                id=req.id, cluster_id=req.cluster_id, ip=req.ip, port=req.port
            )
        )
        return pb.Empty()

    def _keepalive(self, req, context):
        return pb.KeepaliveReply(known=self.clusters.keepalive(req.instance_id))

    def _list_schedulers(self, req, context):
        return pb.ListSchedulersReply(
            schedulers=[
                pb.WireScheduler(
                    id=s.id, cluster_id=s.cluster_id, ip=s.ip, port=s.port,
                    state=s.state,
                )
                for s in self.clusters.active_schedulers()
            ]
        )

    def _search(self, req, context):
        try:
            ranked = self.searcher.find_scheduler_clusters(
                self.scheduler_clusters,
                ip=req.ip, hostname=req.hostname,
                conditions={"idc": req.idc, "location": req.location},
            )
        except LookupError as exc:
            context.abort(grpc.StatusCode.NOT_FOUND, str(exc))
        return pb.ClusterSearchReply(cluster_ids=[c.id for c in ranked])

    @property
    def target(self) -> str:
        return f"{self.address[0]}:{self.address[1]}"

    def serve(self) -> None:
        self._server.start()

    def stop(self, grace: float = 0.5) -> None:
        self._server.stop(grace)


class GRPCRemoteRegistry:
    """Drop-in for rpc.registry_client.RemoteRegistry over gRPC — the
    trainer publishes models and the scheduler fetches scorers through
    the same surface."""

    def __init__(
        self,
        target: str,
        *,
        timeout: float = 60.0,
        token: str = "",
        channel_credentials: Optional[grpc.ChannelCredentials] = None,
    ) -> None:
        if channel_credentials is not None:
            self._channel = grpc.secure_channel(target, channel_credentials)
        else:
            self._channel = grpc.insecure_channel(target)
        self.timeout = timeout
        self.token = token
        self._stubs = {}
        for name, (req_cls, resp_cls) in {
            "create_model": (pb.CreateModelRequest, pb.WireModel),
            "get_model": (pb.ModelIdRequest, pb.WireModel),
            "list_models": (pb.ListModelsRequest, pb.ListModelsReply),
            "active_model": (pb.ActiveModelRequest, pb.WireModel),
            "activate_model": (pb.ModelIdRequest, pb.WireModel),
            "deactivate_model": (pb.ModelIdRequest, pb.WireModel),
            "model_artifact": (pb.ModelIdRequest, pb.ArtifactReply),
            "register_scheduler": (pb.RegisterSchedulerRequest, pb.Empty),
            "keepalive": (pb.KeepaliveRequest, pb.KeepaliveReply),
            "list_schedulers": (pb.Empty, pb.ListSchedulersReply),
            "search_clusters": (pb.ClusterSearchRequest, pb.ClusterSearchReply),
            "issue_certificate": (pb.CertificateRequest, pb.CertificateReply),
        }.items():
            self._stubs[name] = self._channel.unary_unary(
                f"/{MANAGER_SERVICE}/{name}",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=resp_cls.FromString,
            )

    def _call(
        self, name, msg, *, not_found_none: bool = False,
        deadline_s: Optional[float] = None,
    ):
        """Same exception contract as RemoteRegistry._translate — callers
        written against the local ModelRegistry behave identically:
        NOT_FOUND → KeyError (or None), INVALID_ARGUMENT → ValueError,
        transient UNAVAILABLE/DEADLINE retried."""
        from .retry import retry_call

        metadata = (
            [("authorization", f"Bearer {self.token}")] if self.token else None
        )

        def once():
            from ..utils import faultinject

            faultinject.fire(f"grpc.manager.{name}")
            try:
                return self._stubs[name](
                    msg, timeout=self.timeout, metadata=metadata
                )
            except grpc.RpcError as exc:
                code = exc.code()
                if code is grpc.StatusCode.NOT_FOUND:
                    if not_found_none:
                        return None
                    raise KeyError(exc.details()) from exc
                if code is grpc.StatusCode.INVALID_ARGUMENT:
                    raise ValueError(exc.details()) from exc
                if code in (
                    grpc.StatusCode.UNAVAILABLE,
                    grpc.StatusCode.DEADLINE_EXCEEDED,
                ):
                    raise ConnectionError(
                        f"{name}: gRPC {code.name}: {exc.details()}"
                    ) from exc
                raise RPCError(
                    f"{name}: gRPC {code.name}: {exc.details()}",
                    code=_GRPC_TO_DFCODE.get(code, 0),
                ) from exc

        return retry_call(
            once,
            retry_on=(ConnectionError, TimeoutError, OSError),
            deadline_s=deadline_s,
        )

    @staticmethod
    def _model(m):
        from ..manager.registry import Model, ModelState

        return Model(
            id=m.id, name=m.name, type=m.type, version=m.version,
            scheduler_id=m.scheduler_id, state=ModelState(m.state),
            evaluation=json.loads(m.evaluation_json or "{}"),
        )

    def create_model(self, *, name, type, scheduler_id, artifact=b"",
                     evaluation=None):
        reply = self._call("create_model", pb.CreateModelRequest(
            name=name, type=type, scheduler_id=scheduler_id,
            artifact=artifact, evaluation_json=json.dumps(evaluation or {}),
        ))
        return self._model(reply)

    def get(self, model_id):
        reply = self._call(
            "get_model", pb.ModelIdRequest(id=model_id), not_found_none=True
        )
        return None if reply is None else self._model(reply)

    def list(self, scheduler_id=None, name=None):
        reply = self._call("list_models", pb.ListModelsRequest(
            scheduler_id=scheduler_id or "", name=name or ""
        ))
        return [self._model(m) for m in reply.models]

    def active_model(self, scheduler_id, name):
        reply = self._call("active_model", pb.ActiveModelRequest(
            scheduler_id=scheduler_id, name=name
        ), not_found_none=True)
        return None if reply is None else self._model(reply)

    def activate(self, model_id):
        return self._model(
            self._call("activate_model", pb.ModelIdRequest(id=model_id))
        )

    def deactivate(self, model_id):
        return self._model(
            self._call("deactivate_model", pb.ModelIdRequest(id=model_id))
        )

    def load_artifact(self, model):
        # WireModel carries no artifact_digest, so client-side digest
        # verification rides the REST registry path (registry_client.py);
        # the manager itself still verifies before serving either wire.
        reply = self._call("model_artifact", pb.ModelIdRequest(id=model.id))
        return bytes(reply.artifact)

    def register_scheduler(self, *, id, cluster_id, ip, port):
        self._call("register_scheduler", pb.RegisterSchedulerRequest(
            id=id, cluster_id=cluster_id, ip=ip, port=port
        ))

    def keepalive(self, instance_id):
        return self._call(
            "keepalive", pb.KeepaliveRequest(instance_id=instance_id)
        ).known

    def issue_certificate(self, csr_pem: bytes, *, ttl_hours: int = 0):
        """CSR → (cert_pem, ca_pem) signed by the manager's cluster CA."""
        reply = self._call("issue_certificate", pb.CertificateRequest(
            csr_pem=csr_pem, ttl_hours=ttl_hours
        ))
        return bytes(reply.cert_pem), bytes(reply.ca_pem)

    def list_schedulers(self):
        reply = self._call("list_schedulers", pb.Empty())
        return [
            {"id": s.id, "cluster_id": s.cluster_id, "ip": s.ip,
             "port": s.port, "state": s.state}
            for s in reply.schedulers
        ]

    def search_clusters(self, *, ip="", hostname="", idc="", location=""):
        reply = self._call("search_clusters", pb.ClusterSearchRequest(
            ip=ip, hostname=hostname, idc=idc, location=location
        ))
        return list(reply.cluster_ids)

    def close(self):
        self._channel.close()


class GRPCTrainerClient:
    """Scheduler-side Train stream (announcer.go's uploader over gRPC)."""

    # The HTTP transport keeps the announcer's 128 MiB framing
    # (announcer.go:39-41); grpc-python's per-message copy cost grows
    # with message size, so THIS client streams 4 MiB chunks — measured
    # 490 vs 131 MB/s against 128 MiB messages (tools/bench_wire_ingest
    # sweep, BENCHMARKS.md).  The server accepts either (seq-ordered
    # appends; receive cap still fits a 128 MiB-chunk sender).
    CHUNK_BYTES = 4 << 20

    def __init__(self, target: str, *, timeout: float = 600.0) -> None:
        self._channel = grpc.insecure_channel(
            target,
            options=[("grpc.max_send_message_length", _TRAIN_MSG_CAP)],
        )
        self.timeout = timeout
        self._train = self._channel.stream_unary(
            f"/{TRAINER_SERVICE}/Train",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.TrainReply.FromString,
        )
        self._status = self._channel.unary_unary(
            f"/{TRAINER_SERVICE}/RunStatus",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.RunStatusReply.FromString,
        )

    def train(
        self,
        *,
        ip: str,
        hostname: str,
        scheduler_id: str,
        download_shards=(),
        topology_shards=(),
    ) -> str:
        """Stream both dataset files in ``CHUNK_BYTES`` chunks over ONE
        stream (announcer.go:144-171 flow), returning the run key."""

        def chunks():
            yield pb.TrainChunk(ip=ip, hostname=hostname, scheduler_id=scheduler_id)
            for kind, paths in (
                ("download", download_shards),
                ("networktopology", topology_shards),
            ):
                for path in paths:
                    name = path.rsplit("/", 1)[-1]
                    seq = 0
                    with open(path, "rb") as f:
                        while True:
                            data = f.read(self.CHUNK_BYTES)
                            if not data:
                                break
                            yield pb.TrainChunk(
                                kind=kind, name=name, seq=seq, data=data
                            )
                            seq += 1

        try:
            reply = self._train(chunks(), timeout=self.timeout)
        except grpc.RpcError as exc:
            raise RPCError(
                f"Train: gRPC {exc.code().name}: {exc.details()}"
            ) from exc
        return reply.run

    def run_status(self, key: str) -> dict:
        try:
            r = self._status(pb.RunStatusRequest(key=key), timeout=30.0)
        except grpc.RpcError as exc:
            raise RPCError(
                f"RunStatus: gRPC {exc.code().name}: {exc.details()}"
            ) from exc
        return {
            "key": r.key,
            "done": r.done,
            "error": r.error,
            "download_rows": r.download_rows,
            "topology_rows": r.topology_rows,
            "models": list(r.models),
            "metrics": json.loads(r.metrics_json or "{}"),
        }

    def close(self) -> None:
        self._channel.close()
