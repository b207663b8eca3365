"""HTTP forward proxy diverting matched requests into P2P.

Reference: client/daemon/proxy — regex rules route GETs into the P2P
download path (proxy.go:275-310), registry-mirror rewriting, pass-through
for everything else; transport.go's round-tripper is the divert seam.

Here: a stdlib HTTP proxy server whose rule set maps URL regexes →
P2P download via the daemon's conductor; unmatched GETs are fetched
directly (urllib); CONNECT requests are tunneled as raw byte relays
(HTTPS pass-through — proxy.go's tunnel path; SNI-hijack into P2P is a
round-2 target).

Pass-through serving (DESIGN.md §25): diverted GETs STREAM the task via
``open_stream`` — the response body is fed from the commit tee while
the swarm download runs (zero disk reads on the fast path) — and honor
single-range ``Range:`` headers (RFC 7233 via utils/httprange) as 206
responses over the IN-FLIGHT task: only the overlapping piece window is
scheduled first, the client never waits for full completion.

Port of ``dragonfly2_tpu/daemon/proxy.py``, verbatim.
"""

from __future__ import annotations

import re
import socket
import threading
import urllib.request
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Pattern, Tuple

from ..utils.httprange import (
    RangeNotSatisfiable,
    content_range,
    parse_range,
    unsatisfiable_content_range,
)
from .relay import fetch_via_p2p, relay_bytes


@dataclass
class ProxyRule:
    """proxy.go's Proxy rules: regex + use-p2p flag (+ optional rewrite)."""

    pattern: Pattern
    use_p2p: bool = True
    redirect: str = ""  # registry-mirror style prefix rewrite

    @classmethod
    def compile(cls, regex: str, *, use_p2p: bool = True, redirect: str = "") -> "ProxyRule":
        return cls(pattern=re.compile(regex), use_p2p=use_p2p, redirect=redirect)


class ProxyRouter:
    """Rule matching + divert decision (transport.go shouldUseDragonfly)."""

    def __init__(self, rules: Optional[List[ProxyRule]] = None):
        self.rules = rules or []

    def route(self, url: str) -> Tuple[bool, str]:
        """→ (use_p2p, effective_url)."""
        for rule in self.rules:
            if rule.pattern.search(url):
                effective = url
                if rule.redirect:
                    effective = rule.pattern.sub(rule.redirect, url, count=1)
                return rule.use_p2p, effective
        return False, url


class P2PProxy:
    def __init__(
        self,
        daemon,
        router: ProxyRouter,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        piece_size: int = 4 << 20,
        direct_timeout: float = 30.0,
        tunnel_idle_timeout: float = 300.0,
    ):
        self.daemon = daemon
        self.router = router
        self.piece_size = piece_size
        self.direct_timeout = direct_timeout
        self.tunnel_idle_timeout = tunnel_idle_timeout
        self.stats = {"p2p": 0, "direct": 0, "tunnel": 0}
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send_416(self, total: int) -> None:
                self.send_response(416)
                self.send_header(
                    "Content-Range", unsatisfiable_content_range(total)
                )
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_GET(self):
                # Absolute-form (true forward-proxy clients send
                # `GET http://host/path`) or path-embedded
                # (`GET /http://host/path`, gateway-style callers — any
                # scheme the rule set routes, incl. dfstore://).
                url = self.path
                if re.match(r"^/[a-z][a-z0-9+.-]*://", url):
                    url = url[1:]
                use_p2p, effective = proxy.router.route(url)
                rng_header = self.headers.get("Range")
                if use_p2p:
                    # STREAM the P2P task (StartStreamTask consumer): the
                    # response body flows from the commit tee as the
                    # download commits — a client starts receiving long
                    # before the task finishes, with no disk round-trip.
                    # A Range request maps onto the overlapping piece
                    # window of the IN-FLIGHT task (206 over a task that
                    # may still be mid-swarm).
                    try:
                        handle, rng = proxy._open_p2p_stream(
                            effective, rng_header
                        )
                    except RangeNotSatisfiable as exc:
                        self._send_416(exc.total)
                        return
                    except Exception:  # noqa: BLE001 — proxy boundary
                        self.send_error(502)
                        return
                    proxy.stats["p2p"] += 1
                    total = max(handle.content_length, 0)
                    if rng is not None:
                        start, end = rng
                        self.send_response(206)
                        self.send_header(
                            "Content-Range", content_range(start, end, total)
                        )
                        self.send_header(
                            "Content-Length", str(end - start + 1)
                        )
                    else:
                        self.send_response(200)
                        self.send_header("Content-Length", str(total))
                    self.send_header("Accept-Ranges", "bytes")
                    self.end_headers()
                    try:
                        for chunk in handle.chunks():
                            self.wfile.write(chunk)
                    except (IOError, OSError):
                        # Mid-stream failure: the status is already on
                        # the wire — dropping the connection is the only
                        # honest signal (short body ≠ success).
                        handle.close()
                        self.close_connection = True
                    return
                try:
                    body = proxy._fetch_direct(effective)
                    proxy.stats["direct"] += 1
                except Exception:  # noqa: BLE001 — proxy boundary
                    self.send_error(502)
                    return
                # Direct fetches honor the same Range shapes so a rule
                # flip (p2p ↔ direct) never changes range semantics.
                try:
                    rng = parse_range(rng_header, len(body))
                except RangeNotSatisfiable:
                    self._send_416(len(body))
                    return
                if rng is not None:
                    start, end = rng
                    self.send_response(206)
                    self.send_header(
                        "Content-Range", content_range(start, end, len(body))
                    )
                    body = body[start : end + 1]
                else:
                    self.send_response(200)
                self.send_header("Accept-Ranges", "bytes")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_CONNECT(self):
                # HTTPS pass-through: relay raw bytes between the client
                # and the target (the handler thread owns the tunnel).
                try:
                    host_part, _, port_part = self.path.rpartition(":")
                    upstream = socket.create_connection(
                        (host_part, int(port_part)), timeout=10
                    )
                except (OSError, ValueError):
                    self.send_error(502)
                    return
                self.send_response(200, "Connection Established")
                self.end_headers()
                proxy.stats["tunnel"] += 1
                client = self.connection
                try:
                    from ..utils import faultinject

                    faultinject.fire("proxy.tunnel")
                    # Bytes the client pipelined behind the CONNECT headers
                    # (e.g. a TLS ClientHello racing the 200) are sitting in
                    # rfile's buffer, NOT the socket — forward them first or
                    # the handshake stalls.
                    try:
                        buffered = self.rfile.read1(65536) if self.rfile.peek(1) else b""
                    except (OSError, ValueError):
                        buffered = b""
                    if buffered:
                        upstream.sendall(buffered)
                    relay_bytes(client, upstream, proxy.tunnel_idle_timeout)
                finally:
                    upstream.close()
                self.close_connection = True

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.address = self._httpd.server_address
        self._thread: Optional[threading.Thread] = None

    def _fetch_p2p(self, url: str) -> bytes:
        return fetch_via_p2p(self.daemon, url, self.piece_size)

    def _open_p2p_stream(self, url: str, rng_header: Optional[str] = None):
        """Divert seam, streaming face: sizing now, bytes as pieces land
        (conductor.open_stream) → ``(handle, (start, end) | None)``.

        When the origin answers a length probe, the Range header parses
        BEFORE the stream opens (an unsatisfiable range never touches
        the swarm, and the piece pull gets the priority hint up front);
        otherwise the stream's own sizing provides the total and the
        window narrows late (best-effort priority).
        """
        total = self.daemon.conductor.probe_content_length(url)
        rng = None
        if total is not None and total >= 0:
            rng = parse_range(rng_header, total)  # may raise 416
            start, length = (rng[0], rng[1] - rng[0] + 1) if rng else (0, None)
            handle = self.daemon.open_stream(
                url, piece_size=self.piece_size, content_length=total,
                start=start, length=length,
            )
            return handle, rng
        handle = self.daemon.open_stream(url, piece_size=self.piece_size)
        try:
            rng = parse_range(rng_header, handle.content_length)
        except RangeNotSatisfiable:
            handle.close()
            raise
        if rng is not None:
            handle.narrow(rng[0], rng[1] + 1)
        return handle, rng

    def _fetch_direct(self, url: str) -> bytes:
        from ..utils import faultinject

        faultinject.fire("proxy.direct")
        with urllib.request.urlopen(url, timeout=self.direct_timeout) as resp:
            return faultinject.fire("proxy.direct.body", resp.read())

    @property
    def port(self) -> int:
        return self.address[1]

    def serve(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="p2p-proxy", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
