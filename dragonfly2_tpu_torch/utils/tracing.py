"""Tracing (reference: OpenTelemetry throughout — otelgrpc handlers on
every server/client, explicit spans around task/piece lifecycles,
SURVEY §5.1).

A minimal otel-shaped tracer: named spans with attributes, parent/child
nesting via a context stack, exporters (in-memory for tests, JSONL for
ops).  Services instrument the same seams the reference does: download
task, piece fetch, schedule round, train run.

Cross-process propagation uses the W3C ``traceparent`` header format
(``00-<trace_id>-<span_id>-01``) the reference's otelgrpc interceptors
speak (cmd/dependency/dependency.go:263-297): clients ``inject()`` the
current context into request headers/metadata, servers open their
handler span with ``remote_span()`` so one trace id follows a download
through daemon → scheduler → trainer hops.

Port of ``dragonfly2_tpu/utils/tracing.py``, with the logic verbatim.
One difference: the OTLP scope name is this module's own name.  The wire formats (the ``traceparent`` header,
OTLP/JSON, the DFTL1 frames of the durable log) are the reference's, so
either package reads the other's logs and links the other's spans.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import uuid
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start_ns: int
    end_ns: int = 0
    attributes: Dict[str, Any] = field(default_factory=dict)
    status: str = "ok"

    @property
    def duration_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def traceparent(self) -> str:
        """W3C trace-context header value for this span."""
        return f"00-{self.trace_id}-{self.span_id}-01"

    def set(self, **attrs: Any) -> None:
        self.attributes.update(attrs)


TRACEPARENT_HEADER = "traceparent"


def _raw_lock():
    """Exporter bookkeeping locks, built from the REAL lock factory
    (the dfcrash precedent): spans may close while a caller holds a
    project lock, and a witnessed exporter lock would put
    caller-lock → exporter-lock edges into the runtime lock graph that
    the static analyzer — which does not traverse generator
    contextmanagers — can never corroborate.  Diagnostics must not
    instrument diagnostics."""
    try:
        from .dflock import _REAL_LOCK

        return _REAL_LOCK()
    except ImportError:  # pragma: no cover — dflock always ships
        return threading.Lock()

# Process-wide tracing toggle (config `tracing.enable`, DESIGN.md §21).
# Disabled, span() hands out a shared no-op span: no ids are drawn, no
# stack is kept, nothing exports — the operator's off switch is also the
# bench's tracing-off arm (tools/bench_sched.py overhead rounds).
_ENABLED = True


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def enabled() -> bool:
    return _ENABLED


class _NoopSpan:
    """Stand-in yielded while tracing is disabled: accepts the same
    writes a real Span does and drops them."""

    __slots__ = ("status",)

    name = ""
    trace_id = ""
    span_id = ""
    parent_id = None
    start_ns = 0
    end_ns = 0
    attributes: Dict[str, Any] = {}
    traceparent = ""

    def set(self, **attrs: Any) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


def trace_sampled(trace_id: str, rate: float) -> bool:
    """Head-sampling decision BY TRACE ID: deterministic across processes
    (crc32 of the id), so every plane keeps or drops the SAME traces and
    a sampled trace assembles end-to-end instead of arriving with random
    per-process holes."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return (zlib.crc32(trace_id.encode()) & 0xFFFFFFFF) / 2**32 < rate


def parse_traceparent(value: Optional[str]):
    """→ (trace_id, span_id) or None for absent/malformed headers."""
    if not value:
        return None
    parts = value.split("-")
    if len(parts) < 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    try:
        int(parts[1], 16), int(parts[2], 16)
    except ValueError:
        return None
    return parts[1], parts[2]


class Tracer:
    def __init__(self, service: str = "dragonfly", exporter: Optional["SpanExporter"] = None):
        self.service = service
        self.exporter = exporter or InMemoryExporter()
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        *,
        _trace_id: Optional[str] = None,
        _parent_id: Optional[str] = None,
        **attributes: Any,
    ) -> Iterator[Span]:
        """One span lifecycle.  ``_trace_id``/``_parent_id`` seed a REMOTE
        parent context (remote_span uses them); normally the local stack
        provides the parentage."""
        if not _ENABLED:
            yield _NOOP_SPAN  # type: ignore[misc]
            return
        stack = self._stack()
        parent = stack[-1] if stack else None
        span = Span(
            name=name,
            trace_id=_trace_id or (parent.trace_id if parent else uuid.uuid4().hex),
            span_id=uuid.uuid4().hex[:16],
            parent_id=_parent_id or (parent.span_id if parent else None),
            start_ns=time.time_ns(),
            attributes=dict(attributes),
        )
        stack.append(span)
        try:
            yield span
        except BaseException as exc:
            span.status = f"error: {type(exc).__name__}"
            raise
        finally:
            span.end_ns = time.time_ns()
            stack.pop()
            self.exporter.export(span)

    def current_trace_id(self) -> Optional[str]:
        """Trace id of the innermost active span on THIS thread, or None.
        Cheap enough for metric hot paths (one thread-local read) — the
        histogram exemplar hook joins a slow bucket to its trace here."""
        stack = getattr(self._local, "stack", None)
        if not stack:
            return None
        return stack[-1].trace_id

    # -- cross-process propagation (otelgrpc-interceptor analog) -------------

    def inject(self) -> Dict[str, str]:
        """Headers/metadata for an outgoing request: the current span's
        context, or empty when no span is active (callers just merge)."""
        stack = self._stack()
        if not stack:
            return {}
        return {TRACEPARENT_HEADER: stack[-1].traceparent}

    @contextlib.contextmanager
    def remote_span(
        self, name: str, traceparent: Optional[str], **attributes: Any
    ) -> Iterator[Span]:
        """Server-side handler span linked to the CALLER's context: same
        trace id, parent = the caller's span id.  Falls back to a local
        root span when the header is absent/malformed."""
        parsed = parse_traceparent(traceparent)
        trace_id, parent_span_id = parsed if parsed else (None, None)
        with self.span(
            name, _trace_id=trace_id, _parent_id=parent_span_id, **attributes
        ) as span:
            yield span


class SpanExporter:
    def export(self, span: Span) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class InMemoryExporter(SpanExporter):
    """Bounded ring of recent spans.  This is the process DEFAULT
    exporter and every RPC handler/download/piece worker exports through
    it — unbounded growth would leak a long-running daemon to OOM."""

    def __init__(self, max_spans: int = 4096) -> None:
        import collections

        self._mu = _raw_lock()
        self.spans = collections.deque(maxlen=max_spans)

    def export(self, span: Span) -> None:
        with self._mu:
            self.spans.append(span)

    def find(self, name: str) -> List[Span]:
        with self._mu:
            return [s for s in self.spans if s.name == name]


class JSONLExporter(SpanExporter):
    def __init__(self, path: str) -> None:
        self.path = path
        self._mu = _raw_lock()

    def export(self, span: Span) -> None:
        record = {
            "name": span.name,
            "trace_id": span.trace_id,
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            "start_ns": span.start_ns,
            "duration_ms": span.duration_ms,
            "status": span.status,
            "attributes": span.attributes,
        }
        with self._mu:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")


def otlp_trace_schema() -> Dict[str, Any]:
    """The vendored JSON Schema for ``ExportTraceServiceRequest``
    (utils/otlp_trace_schema.json — a transcription of
    opentelemetry-proto's trace/common/resource v1 protos under the
    proto3 JSON mapping, strict additionalProperties).  Every request
    this module emits validates against it (tests/test_utils.py); no
    OTLP-ingesting binary exists in the sandbox, so the schema stands
    in for the collector the reference proved its wiring with
    (cmd/dependency/dependency.go:263-297 ran Jaeger)."""
    import os

    path = os.path.join(os.path.dirname(__file__), "otlp_trace_schema.json")
    with open(path) as f:
        return json.load(f)


def _otlp_value(v: Any) -> Dict[str, Any]:
    """Python attribute → OTLP AnyValue (proto3-JSON encoding rules:
    int64 rides as a string, doubles as numbers)."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def span_to_otlp(span: Span) -> Dict[str, Any]:
    """One Span → the OTLP/JSON span object (trace/span ids are HEX in
    the OTLP/JSON encoding, unlike generic proto3-JSON's base64 —
    opentelemetry-proto's documented deviation)."""
    out: Dict[str, Any] = {
        "traceId": span.trace_id,
        "spanId": span.span_id,
        "name": span.name,
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(span.start_ns),
        "endTimeUnixNano": str(span.end_ns),
        "attributes": [
            {"key": k, "value": _otlp_value(v)}
            for k, v in span.attributes.items()
        ],
        "status": (
            {"code": 1}
            if span.status == "ok"
            else {"code": 2, "message": span.status}
        ),
    }
    if span.parent_id:
        out["parentSpanId"] = span.parent_id
    return out


class OTLPJSONExporter(SpanExporter):
    """OTLP/JSON exporter — the reference exports to Jaeger via OTel
    (cmd/dependency/dependency.go:263-297); this emits the standard
    ``ExportTraceServiceRequest`` JSON any OTLP collector (Jaeger ≥1.35
    at ``:4318/v1/traces``, otel-collector, Tempo) ingests.

    ``target`` starting with ``http://``/``https://`` POSTs batches to
    that endpoint; anything else is a file path appended one request
    per line (replayable with curl).  Spans buffer up to ``batch_size``
    then flush; a long-running service's tail flushes on close()/atexit.
    Export failures are counted, never raised, and HTTP posts happen on
    a background sender thread behind a bounded queue — a slow/down
    collector must not stall the span-producing data-plane threads
    (span end runs inside piece workers and RPC handlers).
    """

    def __init__(
        self,
        target: str,
        *,
        service: str = "dragonfly",
        batch_size: int = 64,
        queue_batches: int = 16,
    ) -> None:
        import atexit
        import queue as _queue

        self.target = target
        self.service = service
        self.batch_size = batch_size
        self.dropped = 0
        self._mu = _raw_lock()
        self._buf: List[Span] = []
        self._http = target.startswith(("http://", "https://"))
        if self._http:
            self._q: "_queue.Queue" = _queue.Queue(maxsize=queue_batches)
            self._worker = threading.Thread(
                target=self._drain, name="otlp-export", daemon=True
            )
            self._worker.start()
        atexit.register(self.close)

    def export(self, span: Span) -> None:
        with self._mu:
            self._buf.append(span)
            if len(self._buf) < self.batch_size:
                return
            batch, self._buf = self._buf, []
        self._dispatch(batch)

    def flush(self) -> None:
        with self._mu:
            batch, self._buf = self._buf, []
        if batch:
            self._dispatch(batch)
        if self._http:
            # Bounded drain-wait (DF008 timeout sweep): Queue.join() has
            # no timeout parameter, and a wedged exporter must not hang
            # flush() forever — wait on the queue's own all_tasks_done
            # condition with a deadline instead.
            deadline = time.monotonic() + 30.0
            with self._q.all_tasks_done:
                while self._q.unfinished_tasks and time.monotonic() < deadline:
                    self._q.all_tasks_done.wait(1.0)

    def close(self) -> None:
        self.flush()

    def _dispatch(self, batch: List[Span]) -> None:
        if not self._http:
            self._send(batch)
            return
        import queue as _queue

        try:
            self._q.put_nowait(batch)
        except _queue.Full:
            # Collector can't keep up: shed THIS batch, never block the
            # producing thread.
            with self._mu:
                self.dropped += len(batch)

    def _drain(self) -> None:
        import queue as _queue

        while True:
            # Bounded get + loop (DF008 timeout sweep): periodic wake-ups
            # keep this exporter visible to watchdog stack dumps.
            try:
                batch = self._q.get(timeout=30.0)
            except _queue.Empty:
                continue
            try:
                self._send(batch)
            finally:
                self._q.task_done()

    def _request(self, batch: List[Span]) -> Dict[str, Any]:
        return build_export_request(self.service, batch)

    def _send(self, batch: List[Span]) -> None:
        payload = json.dumps(self._request(batch))
        try:
            if self._http:
                import urllib.request

                req = urllib.request.Request(
                    self.target,
                    data=payload.encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST",
                )
                urllib.request.urlopen(req, timeout=10).close()
            else:
                # Under the lock: concurrent flushes interleaving their
                # multi-KB appends would corrupt the JSONL stream.
                with self._mu:
                    with open(self.target, "a") as f:
                        f.write(payload + "\n")
        except Exception:  # noqa: BLE001 — observability must not crash the plane
            with self._mu:
                self.dropped += len(batch)


def build_export_request(service: str, batch: List[Span]) -> Dict[str, Any]:
    """A batch of spans → one ``ExportTraceServiceRequest`` (OTLP/JSON),
    the unit every exporter emits and the vendored schema validates."""
    return {
        "resourceSpans": [
            {
                "resource": {
                    "attributes": [
                        {
                            "key": "service.name",
                            "value": {"stringValue": service},
                        }
                    ]
                },
                "scopeSpans": [
                    {
                        "scope": {"name": __name__},
                        "spans": [span_to_otlp(s) for s in batch],
                    }
                ],
            }
        ]
    }


# ---------------------------------------------------------------------------
# Flight recorder: crash-safe durable trace log (DESIGN.md §21)
# ---------------------------------------------------------------------------

# One frame per ExportTraceServiceRequest:
#   b"DFTL1 <payload_len> <crc32 payload, 8 hex>\n" + payload + b"\n"
# The header carries the exact byte length (a reader never trusts the
# payload to self-terminate) and the digest (a half-written or bit-rotted
# frame is NEVER admitted on replay).  A SIGKILL mid-append leaves at
# most one torn frame at the TAIL, which replay tolerates by stopping.
FRAME_MAGIC = b"DFTL1 "


class DurableSpanExporter(SpanExporter):
    """Per-process append-only OTLP/JSON-lines trace log.

    Crash-safe by construction: each frame is one ``os.write`` on an
    O_APPEND fd (the kernel serializes appends), written at export time —
    by default every finished span becomes durable IMMEDIATELY
    (``batch_size=1``), so a SIGKILLed daemon's log still holds every
    span that ended before the kill and ``bench/trace_assemble.py`` can
    stitch the surviving per-process logs into the end-to-end trace.

    ``sample_rate`` head-samples BY TRACE ID (``trace_sampled``):
    deterministic across processes, so a kept trace is kept on every
    plane.  Export failures are counted in ``dropped``, never raised —
    observability must not crash the plane.
    """

    def __init__(
        self,
        path: str,
        *,
        service: str = "dragonfly",
        sample_rate: float = 1.0,
        batch_size: int = 1,
        fsync: bool = False,
    ) -> None:
        import atexit

        self.path = path
        self.service = service
        self.sample_rate = sample_rate
        self.batch_size = max(1, batch_size)
        self.fsync = fsync
        self.exported = 0
        self.sampled_out = 0
        self.dropped = 0
        self._mu = _raw_lock()
        self._buf: List[Span] = []
        self._fd: Optional[int] = None
        atexit.register(self.close)

    def export(self, span: Span) -> None:
        if not trace_sampled(span.trace_id, self.sample_rate):
            with self._mu:
                self.sampled_out += 1
            return
        with self._mu:
            self._buf.append(span)
            if len(self._buf) < self.batch_size:
                return
            batch, self._buf = self._buf, []
        self._write(batch)

    def flush(self) -> None:
        with self._mu:
            batch, self._buf = self._buf, []
        if batch:
            self._write(batch)

    def close(self) -> None:
        self.flush()
        with self._mu:
            fd, self._fd = self._fd, None
        if fd is not None:
            try:
                os.close(fd)
            except OSError:
                pass

    def _write(self, batch: List[Span]) -> None:
        # sort_keys pins canonical frame bytes (DF019): equal batches
        # must serialize identically regardless of dict hash order.
        payload = json.dumps(
            build_export_request(self.service, batch), sort_keys=True
        ).encode()
        frame = (
            FRAME_MAGIC
            + f"{len(payload)} {zlib.crc32(payload) & 0xFFFFFFFF:08x}\n".encode()
            + payload
            + b"\n"
        )
        with self._mu:
            try:
                if self._fd is None:
                    self._fd = os.open(
                        self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
                    )
                os.write(self._fd, frame)
                if self.fsync:
                    os.fsync(self._fd)
                self.exported += len(batch)
            except OSError:
                self.dropped += len(batch)


class CompositeExporter(SpanExporter):
    """Fan one span out to several exporters — the standard wiring keeps
    the in-memory ring (``/debug/spans``) alongside the durable log."""

    def __init__(self, exporters: List[SpanExporter]) -> None:
        self.exporters = list(exporters)

    def export(self, span: Span) -> None:
        for e in self.exporters:
            e.export(span)

    def flush(self) -> None:
        for e in self.exporters:
            if hasattr(e, "flush"):
                e.flush()

    def close(self) -> None:
        for e in self.exporters:
            if hasattr(e, "close"):
                e.close()

    def find(self, cls) -> Optional[SpanExporter]:
        for e in self.exporters:
            if isinstance(e, cls):
                return e
        return None


def replay_trace_log(path: str) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """Replay a durable trace log → (requests, stats).

    Stats: ``frames`` admitted, ``corrupt`` frames rejected by digest or
    JSON decode (NEVER admitted), ``torn_tail`` True when the file ends
    inside a frame (the expected SIGKILL signature — tolerated, not an
    error)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return [], {"frames": 0, "corrupt": 0, "torn_tail": False}
    requests: List[Dict[str, Any]] = []
    corrupt = 0
    torn = False
    pos = 0
    while True:
        idx = data.find(FRAME_MAGIC, pos)
        if idx < 0:
            break
        nl = data.find(b"\n", idx)
        if nl < 0:
            torn = True  # header itself torn at the tail
            break
        header = data[idx + len(FRAME_MAGIC) : nl]
        try:
            len_s, crc_s = header.split()
            length, crc = int(len_s), int(crc_s, 16)
        except ValueError:
            corrupt += 1
            pos = idx + 1  # garbage where a header should be: resync
            continue
        payload = data[nl + 1 : nl + 1 + length]
        if len(payload) < length:
            # Frame cut mid-payload.  At EOF that's the torn tail a
            # SIGKILL leaves (tolerated); mid-file (another frame starts
            # later) it's a corrupt frame — reject and resync.
            nxt = data.find(FRAME_MAGIC, idx + 1)
            if nxt < 0:
                torn = True
                break
            corrupt += 1
            pos = nxt
            continue
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            corrupt += 1
            pos = idx + 1  # digest mismatch: frame not admitted; resync
            continue
        try:
            requests.append(json.loads(payload))
        except ValueError:
            corrupt += 1
            pos = idx + 1
            continue
        pos = nl + 1 + length
    return requests, {"frames": len(requests), "corrupt": corrupt, "torn_tail": torn}


def log_spans(requests: List[Dict[str, Any]]) -> Iterator[Dict[str, Any]]:
    """Flatten replayed requests → span dicts, each annotated with the
    emitting process's ``service`` (resource attr ``service.name``)."""
    for req in requests:
        for rs in req.get("resourceSpans", []):
            service = ""
            for attr in (rs.get("resource") or {}).get("attributes", []):
                if attr.get("key") == "service.name":
                    service = attr.get("value", {}).get("stringValue", "")
            for ss in rs.get("scopeSpans", []):
                for span in ss.get("spans", []):
                    out = dict(span)
                    out["service"] = service
                    yield out


def recent_spans_otlp(tracer: Optional[Tracer] = None) -> Dict[str, Any]:
    """The in-memory ring as ONE OTLP/JSON request — the ``/debug/spans``
    payload on every plane.  Works with the ring installed directly or
    inside a CompositeExporter; empty request otherwise."""
    t = tracer or default_tracer
    exporter = t.exporter
    ring: Optional[InMemoryExporter] = None
    if isinstance(exporter, InMemoryExporter):
        ring = exporter
    elif isinstance(exporter, CompositeExporter):
        found = exporter.find(InMemoryExporter)
        ring = found if isinstance(found, InMemoryExporter) else None
    if ring is None:
        return build_export_request(t.service, [])
    with ring._mu:
        spans = list(ring.spans)
    return build_export_request(t.service, spans)


# Process-default tracer (services may construct scoped ones).
default_tracer = Tracer()


def current_trace_id() -> Optional[str]:
    """Active trace id on this thread (default tracer), or None."""
    return default_tracer.current_trace_id()
