"""HTTP piece data plane (reference: client/daemon/upload's HTTP piece
server + the daemon's piece-download HTTP client).

Server: GET /pieces/<task_id>/<number> → piece bytes (whole-piece), plus
GET /tasks/<task_id> with a Range header → assembled byte range
(upload_manager.go range semantics).  503 when the upload concurrency cap
is hit, 404 for missing pieces — the conductor treats both as piece
failures and reschedules.  Speaks HTTP/1.1 with keep-alive, and streams
piece/range bodies kernel→socket via ``os.sendfile`` from the storage
engine's data file when the deployment allows it (plain TCP, plain-file
engine; TLS and torn-body chaos scenarios ride the buffered path —
byte-identical by test, DESIGN.md §22).

Piece-metadata SUBSCRIPTION (peertask_piecetask_synchronizer.go):
GET /tasks/<task_id>/pieces?have=N&wait_ms=M long-polls — the response
is deferred until the parent holds MORE than N pieces (a mid-download
parent commits new data) or M milliseconds pass, so children learn a
downloading parent's new pieces as they land instead of one-shot
snapshots.

Client: HTTPPieceFetcher resolves a parent host id to its announced
(ip, download_port) — carried in the scheduler's parent responses — and
GETs pieces over a per-parent KEEP-ALIVE connection pool
(``PieceConnectionPool``) with retry/backoff: one dial amortizes over a
whole task instead of a fresh TCP (+TLS) handshake per 4 MiB piece.
Bodies land in a reusable per-thread buffer via ``readinto`` (no
per-chunk allocate-and-join).  The pool invalidates on breaker-open and
on parent re-resolve (a restarted parent announces a new port).

Port of ``dragonfly2_tpu/rpc/piece_transport.py`` with the Python server
only: the reference's ``NativePieceServer`` (its C++ engine's in-engine
server) and ``HTTPPieceFetcher.native_endpoint`` (its native fetch loop's
dial) are ROADMAP queue 1 item 14, so ``make_piece_server`` always builds
a ``PieceHTTPServer`` and raises when asked for the native one.  The wire
is the reference's, so either package's fetcher reads the other's server.
"""

from __future__ import annotations

import http.client
import logging
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Callable, Dict, List, Optional, Tuple

from ..daemon.upload import UploadBusy, UploadManager
from ..utils.metrics import default_registry as _mreg
from ._server import ThreadedHTTPService
from .retry import retry_call

logger = logging.getLogger(__name__)

# Long-poll wait clamp for /tasks/<id>/pieces: the reference reads it
# from its ABI registry (kLongPollMaxMs, shared with its native server);
# the port carries the literal, held equal to the reference's by test.
LONG_POLL_MAX_MS = 30000

# Fleet telemetry sketch (DESIGN.md §23): the transport-level fetch wall
# (dial + request + body, retries included) — the layer below the
# conductor's hedge-plan samples, so a slow wire is distinguishable from
# a slow schedule in the fleet view.
PIECE_TRANSPORT_SECONDS = _mreg.sketch(
    "rpc_piece_fetch_seconds",
    "HTTPPieceFetcher.fetch wall latency (retries included)",
)


class PieceHTTPServer:
    def __init__(
        self,
        upload: UploadManager,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        ssl_context=None,
        use_sendfile: bool = True,
    ):
        self.upload = upload
        upload_ref = upload
        # sendfile writes the raw fd — with TLS the bytes must pass the
        # SSL layer, so TLS deployments keep the buffered path.
        sendfile_ok = (
            use_sendfile and ssl_context is None and hasattr(os, "sendfile")
        )
        self.sendfile_enabled = sendfile_ok
        stats_mu = threading.Lock()
        stats = {"connections": 0, "sendfile_serves": 0}
        self._stats_mu = stats_mu
        self._stats = stats

        class Handler(BaseHTTPRequestHandler):
            # Keep-alive: the fetcher's connection pool reuses one TCP
            # connection across a task's pieces; HTTP/1.0 would close per
            # request and re-pay the handshake every 4 MiB.
            protocol_version = "HTTP/1.1"

            def setup(self):
                super().setup()
                with stats_mu:
                    stats["connections"] += 1

            def log_message(self, *args):
                pass

            def _send(self, code: int, body: bytes, ctype: str = "application/octet-stream"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_span(self, code: int, span: Tuple[str, int, int]) -> None:
                """Zero-copy body: headers through the normal writer, then
                the span kernel→socket via os.sendfile.  Headers are out
                by the time the stream starts — a mid-stream failure tears
                the connection (client length-checks catch it), exactly
                like a dying parent."""
                path, offset, length = span
                with open(path, "rb") as src:
                    self.send_response(code)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Content-Length", str(length))
                    self.end_headers()
                    self.wfile.flush()
                    # socket.sendfile drives os.sendfile with proper
                    # handling of the handler socket's timeout mode (a
                    # raw os.sendfile on a timeout-mode fd EAGAINs once
                    # the send buffer fills).
                    sent = self.connection.sendfile(src, offset, length)
                    if sent != length:
                        raise BrokenPipeError(
                            f"sendfile sent {sent} of {length} bytes"
                        )
                with stats_mu:
                    stats["sendfile_serves"] += 1

            def do_GET(self):
                import time as _time
                import urllib.parse as _parse

                split = _parse.urlsplit(self.path)
                parts = split.path.strip("/").split("/")
                streaming = False
                # Requester-pays accounting (§26/§28): the fetching peer
                # stamps its tenant on the wire; the upload gate charges
                # THAT tenant's byte bucket, not the task owner's.
                req_tenant = self.headers.get("X-Dragonfly-Tenant") or None
                try:
                    if len(parts) == 3 and parts[0] == "pieces":
                        from ..utils import faultinject

                        task_id, number = parts[1], int(parts[2])
                        if sendfile_ok:
                            span = upload_ref.piece_sendfile_span(task_id, number)
                            if span is not None:
                                upload_ref.begin_upload(task_id, req_tenant)
                                ok = False
                                try:
                                    streaming = True
                                    self._send_span(200, span)
                                    ok = True
                                finally:
                                    upload_ref.end_upload(
                                        ok, span[2] if ok else 0, task_id,
                                        req_tenant,
                                    )
                                return
                        data = upload_ref.serve_piece(task_id, number,
                                                      req_tenant)
                        # Torn-body seam: a truncate fault serves a SHORT
                        # 200 — the client's length check must catch it.
                        data = faultinject.fire("piece.server.body", data)
                        self._send(200, data)
                        return
                    if len(parts) == 3 and parts[0] == "tasks" and parts[2] == "pieces":
                        # Piece-metadata sync (reference: SyncPieceTasks —
                        # peers learn which pieces a parent holds before
                        # fetching).  Body: the piece bitmap, one byte per
                        # piece.  With ?have=N&wait_ms=M this LONG-POLLS:
                        # the reply defers until the parent holds more
                        # than N pieces (synchronizer subscription).
                        task_id = parts[1]
                        q = dict(_parse.parse_qsl(split.query))
                        try:
                            have = int(q.get("have", -1))
                            wait_ms = min(
                                int(q.get("wait_ms", 0)), LONG_POLL_MAX_MS
                            )
                        except ValueError:
                            self.send_error(400)
                            return
                        deadline = _time.monotonic() + wait_ms / 1000.0
                        while True:
                            n_pieces = upload_ref.storage.n_pieces(task_id)
                            if (
                                n_pieces > 0
                                and upload_ref.storage.held_pieces(task_id) > have
                            ):
                                break
                            if _time.monotonic() >= deadline:
                                break
                            _time.sleep(0.02)
                        if n_pieces <= 0:
                            self.send_error(404)
                            return
                        bm = upload_ref.storage.piece_bitmap(task_id, n_pieces)
                        self._send(200, bytes(bm))
                        return
                    if len(parts) == 2 and parts[0] == "tasks":
                        from ..utils.httprange import (
                            RangeNotSatisfiable,
                            parse_range,
                        )

                        task_id = parts[1]
                        total = upload_ref.storage.engine.content_length(task_id)
                        # Shared RFC-7233 parser (utils/httprange) keeps
                        # this endpoint byte-identical with the proxy and
                        # the gateway; a task endpoint without a servable
                        # range has nothing to answer → 416 (its read IS
                        # the range read).
                        try:
                            span_rng = parse_range(
                                self.headers.get("Range", ""), total
                            )
                        except RangeNotSatisfiable:
                            span_rng = None
                        if span_rng is None:
                            self.send_error(416)
                            return
                        start, end = span_rng
                        if sendfile_ok:
                            span = upload_ref.range_sendfile_span(
                                task_id, start, end - start + 1
                            )
                            if span is not None:
                                upload_ref.begin_upload(task_id, req_tenant)
                                ok = False
                                try:
                                    streaming = True
                                    self._send_span(206, span)
                                    ok = True
                                finally:
                                    upload_ref.end_upload(
                                        ok, span[2] if ok else 0, task_id,
                                        req_tenant,
                                    )
                                return
                        piece_size = upload_ref.storage.engine.piece_size(task_id)
                        data = upload_ref.serve_range(
                            task_id, start, end - start + 1, piece_size,
                            req_tenant,
                        )
                        self._send(206, data)
                        return
                    self.send_error(404)
                except UploadBusy:
                    self.send_error(503)
                except KeyError:
                    self.send_error(404)
                except Exception:  # noqa: BLE001 — wire boundary
                    if streaming:
                        # Headers (and possibly a partial body) are out:
                        # the only honest signal left is a torn stream.
                        self.close_connection = True
                        return
                    self.send_error(500)

        self._svc = ThreadedHTTPService(Handler, host, port, "piece-http", ssl_context)
        self.address: Tuple[str, int] = self._svc.address

    @property
    def port(self) -> int:
        return self._svc.port

    @property
    def connections_accepted(self) -> int:
        """TCP connections this server has accepted — the pool-reuse
        tests' server-side evidence (pieces served ≫ connections)."""
        with self._stats_mu:
            return self._stats["connections"]

    @property
    def sendfile_serves(self) -> int:
        with self._stats_mu:
            return self._stats["sendfile_serves"]

    def serve(self) -> None:
        self._svc.serve()

    def stop(self) -> None:
        self._svc.stop()


def make_piece_server(
    upload: UploadManager,
    host: str = "127.0.0.1",
    port: int = 0,
    *,
    ssl_context=None,
    prefer_native: bool = False,
):
    """The piece server: the Python ThreadingHTTPServer.  The reference
    picks its C++ in-engine server when the store runs its native engine;
    ``prefer_native=True`` asks for that server, which is not ported
    (ROADMAP queue 1 item 14), and raises."""
    if prefer_native:
        raise NotImplementedError(
            "make_piece_server(prefer_native=True): the native piece server "
            "is not ported yet (ROADMAP queue 1 item 14)"
        )
    return PieceHTTPServer(upload, host, port, ssl_context=ssl_context)


class PieceConnectionPool:
    """Per-parent keep-alive HTTP connections to piece servers.

    Invalidation rules (DESIGN.md §22):

    - a connection that errored mid-roundtrip is DISCARDED, never pooled
      (the retry re-dials);
    - a parent whose resolved ``(ip, port)`` changed (restart → new
      announce) drops every pooled connection to the old address;
    - ``invalidate(parent)`` drains the parent outright — the fetcher
      calls it when that parent's circuit breaker lands OPEN, so a dead
      parent's sockets don't linger for the breaker's reset window.

    The pool lock guards only the idle lists; dialing and every byte of
    I/O happen OUTSIDE it (DF008).
    """

    def __init__(
        self,
        *,
        timeout: float = 30.0,
        ssl_context=None,
        max_idle_per_parent: int = 4,
    ) -> None:
        self.timeout = timeout
        self.ssl_context = ssl_context
        self.max_idle_per_parent = max_idle_per_parent
        self._mu = threading.Lock()
        self._idle: Dict[str, List[http.client.HTTPConnection]] = {}
        self._addr: Dict[str, Tuple[str, int]] = {}
        self.dials = 0
        self.reuses = 0

    def _dial(self, ip: str, port: int) -> http.client.HTTPConnection:
        from ..utils import faultinject

        faultinject.fire("piece.pool.connect")
        if self.ssl_context is not None:
            conn: http.client.HTTPConnection = http.client.HTTPSConnection(
                ip, port, timeout=self.timeout, context=self.ssl_context
            )
        else:
            conn = http.client.HTTPConnection(ip, port, timeout=self.timeout)
        conn.connect()
        with self._mu:
            self.dials += 1
        return conn

    def acquire(
        self, parent_id: str, ip: str, port: int
    ) -> http.client.HTTPConnection:
        """An idle connection to the parent's CURRENT address, else a
        fresh dial.  A changed address invalidates the stale pool first."""
        stale: List[http.client.HTTPConnection] = []
        conn = None
        with self._mu:
            if self._addr.get(parent_id) != (ip, port):
                stale = self._idle.pop(parent_id, [])
                self._addr[parent_id] = (ip, port)
            else:
                idle = self._idle.get(parent_id)
                if idle:
                    conn = idle.pop()
                    self.reuses += 1
        for s in stale:
            s.close()
        if conn is not None:
            return conn
        return self._dial(ip, port)

    def release(
        self, parent_id: str, conn: http.client.HTTPConnection, *, reusable: bool
    ) -> None:
        if reusable:
            with self._mu:
                # Address changed while this roundtrip was in flight →
                # the connection points at the OLD parent incarnation.
                addr_current = self._addr.get(parent_id) == (
                    conn.host, conn.port
                )
                idle = self._idle.setdefault(parent_id, [])
                if addr_current and len(idle) < self.max_idle_per_parent:
                    idle.append(conn)
                    return
        conn.close()

    def invalidate(self, parent_id: str) -> None:
        with self._mu:
            drained = self._idle.pop(parent_id, [])
        for conn in drained:
            conn.close()

    def idle_count(self, parent_id: str) -> int:
        with self._mu:
            return len(self._idle.get(parent_id, []))

    def close(self) -> None:
        with self._mu:
            drained = [c for conns in self._idle.values() for c in conns]
            self._idle.clear()
        for conn in drained:
            conn.close()


class _PieceUnavailable(Exception):
    """Permanent-for-this-parent HTTP status (404/410/...): fail without
    retry so the conductor reschedules immediately."""


class HTTPPieceFetcher:
    """Conductor's PieceFetcher over HTTP.

    ``resolve(host_id) → (ip, port)``: in the wire flow the scheduler's
    parent entries carry the announced address (scheduler_client mirrors
    them into Host objects); an explicit table also works for tests.

    ``pooled=True`` (default) rides the keep-alive connection pool;
    ``pooled=False`` keeps the pre-pool one-urlopen-per-piece path — the
    benchmark's reference arm and an operational escape hatch.
    """

    def __init__(
        self,
        resolve: Callable[[str], Tuple[str, int]],
        *,
        timeout: float = 30.0,
        metadata_timeout: float = 2.0,
        ssl_context=None,
        breaker_threshold: int = 6,
        breaker_reset_s: float = 2.0,
        pooled: bool = True,
        tenant: str = "",
    ):
        self._resolve = resolve
        self.timeout = timeout
        # Requester-pays QoS (§26/§28): this daemon's tenant rides every
        # piece GET as X-Dragonfly-Tenant so the serving peer charges the
        # REQUESTER's upload bucket, not the task owner's.
        self.tenant = tenant or ""
        # Per-parent circuit breakers: a dead parent's piece port fails
        # fast after `breaker_threshold` consecutive connect failures
        # instead of burning a connect timeout per piece — the conductor
        # sees the fast ConnectionError and reschedules immediately.
        # breaker_threshold=0 disables.
        from .retry import CircuitBreaker

        self._breaker_mu = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._breaker_threshold = breaker_threshold
        self._breaker_reset_s = breaker_reset_s
        self._breaker_cls = CircuitBreaker
        # Bitmap queries are a pre-fetch optimization — a blackholed parent
        # must not stall the download for the full piece timeout.
        self.metadata_timeout = metadata_timeout
        # mTLS: present this daemon's CA-issued identity to parents running
        # TLS piece servers (security.tls.client_context).
        self.ssl_context = ssl_context
        self._scheme = "https" if ssl_context is not None else "http"
        self.pooled = pooled
        self.pool = PieceConnectionPool(
            timeout=timeout, ssl_context=ssl_context
        )
        # Reusable per-thread body buffer: responses land via readinto
        # instead of a fresh allocate-and-join per piece.
        self._tls_buf = threading.local()

    def _breaker(self, parent_host_id: str):
        if not self._breaker_threshold:
            return None
        with self._breaker_mu:
            b = self._breakers.get(parent_host_id)
            if b is None:
                b = self._breaker_cls(
                    failure_threshold=self._breaker_threshold,
                    reset_timeout_s=self._breaker_reset_s,
                )
                self._breakers[parent_host_id] = b
            return b

    # -- body read into the reusable buffer ----------------------------------

    def _read_body(self, resp: http.client.HTTPResponse) -> bytes:
        length = resp.length
        if length is None:
            return resp.read()
        buf = getattr(self._tls_buf, "buf", None)
        if buf is None or len(buf) < length:
            buf = bytearray(max(length, 1 << 16))
            self._tls_buf.buf = buf
        view = memoryview(buf)
        got = 0
        while got < length:
            n = resp.readinto(view[got:length])
            if not n:
                break
            got += n
        if got < length:
            raise ConnectionError(
                f"short body: {got} of {length} bytes"
            )
        return bytes(view[:length])

    # -- piece fetch ---------------------------------------------------------

    # dflint: hotpath
    def fetch(
        self,
        parent_host_id: str,
        task_id: str,
        number: int,
        *,
        deadline_s: Optional[float] = None,
    ) -> bytes:
        ip, port = self._resolve(parent_host_id)
        path = f"/pieces/{task_id}/{number}"
        once = (
            self._make_pooled_once(parent_host_id, ip, port, path)
            if self.pooled
            else self._make_urlopen_once(ip, port, path)
        )
        breaker = self._breaker(parent_host_id)
        t0 = time.monotonic()
        try:
            body = retry_call(
                once, attempts=2, retry_on=(ConnectionError, TimeoutError),
                breaker=breaker,
                deadline_s=deadline_s,
            )
            PIECE_TRANSPORT_SECONDS.observe(time.monotonic() - t0)
            return body
        except Exception:
            # Breaker landed OPEN (this failure tripped it, or it was
            # already open): drain the parent's pooled sockets — they
            # point at a dependency now considered down.
            if breaker is not None and breaker.state == "open":
                self.pool.invalidate(parent_host_id)
            raise

    def _make_pooled_once(
        self, parent_host_id: str, ip: str, port: int, path: str
    ):
        def once() -> bytes:
            from ..utils import faultinject

            faultinject.fire("piece.fetch")
            conn = self.pool.acquire(parent_host_id, ip, port)
            reusable = False
            try:
                try:
                    conn.request("GET", path, headers=(
                        {"X-Dragonfly-Tenant": self.tenant}
                        if self.tenant else {}
                    ))
                    resp = conn.getresponse()
                    body = self._read_body(resp)
                except (http.client.HTTPException, OSError) as exc:
                    if isinstance(exc, (ConnectionError, TimeoutError)):
                        # Includes RemoteDisconnected: a server-closed
                        # keep-alive socket — the retry re-dials.
                        raise
                    raise ConnectionError(f"piece GET {path}: {exc}") from exc
                reusable = not resp.will_close
                if resp.status == 503:
                    raise ConnectionError("parent busy")  # retried
                if resp.status != 200:
                    # 404 etc.: permanent for this parent — fail at once
                    # so the conductor reschedules.
                    raise _PieceUnavailable(
                        f"HTTP {resp.status} from {ip}:{port}{path}"
                    )
                return faultinject.fire("piece.fetch.body", body)
            finally:
                self.pool.release(parent_host_id, conn, reusable=reusable)

        return once

    def _make_urlopen_once(self, ip: str, port: int, path: str):
        url = f"{self._scheme}://{ip}:{port}{path}"

        def once() -> bytes:
            from ..utils import faultinject

            faultinject.fire("piece.fetch")
            req = urllib.request.Request(url, headers=(
                {"X-Dragonfly-Tenant": self.tenant} if self.tenant else {}
            ))
            try:
                with urllib.request.urlopen(
                    req, timeout=self.timeout, context=self.ssl_context
                ) as resp:
                    return faultinject.fire("piece.fetch.body", resp.read())
            except urllib.error.HTTPError as exc:
                if exc.code == 503:
                    raise ConnectionError("parent busy") from exc  # retried
                # 404 etc.: permanent for this parent — fail immediately so
                # the conductor reschedules (HTTPError is an OSError
                # subclass, which retry_call's default would retry).
                raise _PieceUnavailable(f"HTTP {exc.code} from {url}") from exc

        return once

    def close(self) -> None:
        self.pool.close()

    def piece_bitmap(self, parent_host_id: str, task_id: str):
        """Which pieces the parent holds (None when unknown/unreachable)."""
        return self._bitmap_get(parent_host_id, f"/tasks/{task_id}/pieces",
                                self.metadata_timeout)

    def wait_piece_bitmap(
        self, parent_host_id: str, task_id: str, have: int, wait_s: float
    ):
        """Long-poll subscription: returns once the parent holds more than
        ``have`` pieces or the window closes (synchronizer semantics)."""
        wait_ms = max(int(wait_s * 1000), 0)
        return self._bitmap_get(
            parent_host_id,
            f"/tasks/{task_id}/pieces?have={have}&wait_ms={wait_ms}",
            wait_s + self.metadata_timeout,
        )

    def _bitmap_get(self, parent_host_id: str, path: str, timeout: float):
        from ..utils import faultinject

        try:
            ip, port = self._resolve(parent_host_id)
        except KeyError:
            return None
        url = f"{self._scheme}://{ip}:{port}{path}"
        try:
            faultinject.fire("piece.bitmap")
            with urllib.request.urlopen(
                url, timeout=timeout, context=self.ssl_context
            ) as resp:
                # Truncate seam: a torn bitmap body must be survivable
                # (the conductor treats a short bitmap as fewer pieces).
                return faultinject.fire("piece.bitmap.body", resp.read())
        except (urllib.error.URLError, OSError):
            return None


def resolver_from_hosts(hosts: Dict[str, "object"]) -> Callable[[str], Tuple[str, int]]:
    """Resolve from a host-id → Host mapping (the client's mirror table)."""

    def resolve(host_id: str) -> Tuple[str, int]:
        host = hosts[host_id]
        return host.ip, host.download_port

    return resolve
