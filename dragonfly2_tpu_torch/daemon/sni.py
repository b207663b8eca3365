"""SNI-hijack proxy: TLS interception on the HTTPS port.

Reference: client/daemon/proxy's SNI path — the daemon listens on TLS
ports, reads the ClientHello's server_name extension WITHOUT terminating
the handshake, and either (a) hijacks matched hosts: completes the TLS
handshake itself with a CA-minted leaf certificate for that hostname and
serves the inner HTTP request from P2P, or (b) relays unmatched
connections byte-for-byte to the real origin (the peeked bytes were
never consumed, so the upstream sees a pristine ClientHello).

The ClientHello parser is hand-rolled over the public TLS 1.2/1.3 wire
layout (RFC 8446 §4.1.2): record header → handshake header → skip
random/session/ciphers/compression → walk extensions to server_name (0).

Port of ``dragonfly2_tpu/daemon/sni.py``, verbatim but for two repairs:
``SNIProxy.stop`` shuts the listener down before closing it and joins
the accept thread, which the reference's close leaves blocked in
``accept()``; and a hijacked body is sent under ``idle_timeout``, where
the reference's ``handshake_timeout`` (10 s) bounds the whole
``sendall`` and cuts any body a client drains for longer.
"""

from __future__ import annotations

import re
import shutil
import socket
import ssl
import struct
import tempfile
import threading
import time
from typing import Dict, List, Optional, Pattern

from ..security.ca import CertificateAuthority, PeerIdentity
from .relay import fetch_via_p2p, relay_bytes

MAX_HELLO = 16 * 1024


def parse_client_hello_sni(data: bytes) -> Optional[str]:
    """Extract the SNI hostname from raw ClientHello bytes, else None."""
    try:
        if len(data) < 5 or data[0] != 0x16:  # handshake record
            return None
        record_len = struct.unpack(">H", data[3:5])[0]
        body = data[5 : 5 + record_len]
        if len(body) < 4 or body[0] != 0x01:  # ClientHello
            return None
        hello_len = int.from_bytes(body[1:4], "big")
        hello = body[4 : 4 + hello_len]
        pos = 2 + 32  # legacy_version + random
        sid_len = hello[pos]
        pos += 1 + sid_len
        cipher_len = struct.unpack(">H", hello[pos : pos + 2])[0]
        pos += 2 + cipher_len
        comp_len = hello[pos]
        pos += 1 + comp_len
        if pos + 2 > len(hello):
            return None  # no extensions
        ext_total = struct.unpack(">H", hello[pos : pos + 2])[0]
        pos += 2
        end = min(pos + ext_total, len(hello))
        while pos + 4 <= end:
            ext_type, ext_len = struct.unpack(">HH", hello[pos : pos + 4])
            pos += 4
            if ext_type == 0:  # server_name
                # list length (2) + entry type (1) + name length (2)
                name_len = struct.unpack(">H", hello[pos + 3 : pos + 5])[0]
                return hello[pos + 5 : pos + 5 + name_len].decode("idna")
            pos += ext_len
        return None
    except (IndexError, struct.error, UnicodeError):
        return None


def _peek_client_hello(conn: socket.socket, timeout: float) -> bytes:
    """MSG_PEEK until the full first record is visible (bytes stay queued
    in the kernel, so a relayed upstream still receives them).

    MSG_PEEK on a partial record returns the same bytes instantly — the
    socket timeout never fires while data is queued — so progress is
    tracked explicitly: no growth → short sleep, hard deadline overall
    (otherwise one stalled client pins a core)."""
    from ..utils import faultinject

    conn.settimeout(timeout)
    deadline = time.monotonic() + timeout
    prev = -1
    data = b""
    while True:
        faultinject.fire("sni.peek")
        data = conn.recv(MAX_HELLO, socket.MSG_PEEK)
        if not data:
            return b""
        if len(data) >= 5:
            need = 5 + struct.unpack(">H", data[3:5])[0]
            if len(data) >= need or len(data) >= MAX_HELLO:
                return data
        if time.monotonic() >= deadline:
            return data
        if len(data) == prev:
            time.sleep(0.02)
        prev = len(data)


class _HostCerts:
    """Per-SNI-host leaf certificates minted from the daemon CA, cached
    as ready ssl server contexts (proxy.go's cert cache).

    Entries re-mint at half the leaf TTL: a long-running daemon must
    never serve an expired certificate from the cache."""

    def __init__(self, ca: CertificateAuthority) -> None:
        self.ca = ca
        self._mu = threading.Lock()
        self._contexts: Dict[str, tuple] = {}  # host → (ctx, refresh_at)
        from ..security.ca import DEFAULT_CERT_TTL

        self._refresh_s = DEFAULT_CERT_TTL.total_seconds() / 2

    def context_for(self, host: str) -> ssl.SSLContext:
        now = time.monotonic()
        with self._mu:
            hit = self._contexts.get(host)
        if hit is not None and now < hit[1]:
            return hit[0]
        identity = PeerIdentity.issue(self.ca, common_name=host, hostnames=[host])
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        # Browsers have no client certs: server-auth only, unlike the
        # service-mesh contexts in security.tls.
        directory = tempfile.mkdtemp(prefix="df-sni-")
        try:
            paths = identity.write(directory)
            ctx.load_cert_chain(paths["cert"], paths["key"])
        finally:
            shutil.rmtree(directory, ignore_errors=True)
        with self._mu:
            self._contexts[host] = (ctx, now + self._refresh_s)
        return ctx


class SNIProxy:
    """TLS listener: hijack matched SNI hosts into P2P, relay the rest."""

    def __init__(
        self,
        daemon,
        *,
        ca: CertificateAuthority,
        hijack: List[Pattern],
        router=None,
        host: str = "127.0.0.1",
        port: int = 0,
        relay_port: int = 443,
        upstream_resolver=None,
        piece_size: int = 4 << 20,
        handshake_timeout: float = 10.0,
        idle_timeout: float = 300.0,
    ) -> None:
        self.daemon = daemon
        self.hijack = [re.compile(p) if isinstance(p, str) else p for p in hijack]
        self.router = router
        self.relay_port = relay_port
        # Interception deployments point hijacked DNS names at THIS
        # listener; relaying an unmatched name through normal resolution
        # would then dial ourselves in a loop.  The resolver hook maps
        # SNI → real upstream address; without one, self-connects are
        # detected and refused.
        self.upstream_resolver = upstream_resolver
        self.piece_size = piece_size
        self.handshake_timeout = handshake_timeout
        self.idle_timeout = idle_timeout
        self.certs = _HostCerts(ca)
        self.stats = {"hijacked": 0, "relayed": 0, "rejected": 0}
        self._listener = socket.create_server((host, port))
        self.address = self._listener.getsockname()
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()

    @property
    def port(self) -> int:
        return self.address[1]

    def serve(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._accept_loop, name="sni-proxy", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stopping.set()
        # close() alone leaves a thread blocked in accept() asleep for the
        # life of the process; shutdown() wakes it with an error.
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=10)

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(
                target=self._handle, args=(conn,), daemon=True
            ).start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            hello = _peek_client_hello(conn, self.handshake_timeout)
            sni = parse_client_hello_sni(hello)
            if sni is not None and any(p.search(sni) for p in self.hijack):
                self._hijack(conn, sni)
            elif sni is not None:
                self._relay(conn, sni)
            else:
                self.stats["rejected"] += 1
                conn.close()
        except Exception:  # noqa: BLE001 — connection boundary
            self.stats["rejected"] += 1
            try:
                conn.close()
            except OSError:
                pass

    # -- hijack: terminate TLS, serve the inner request from P2P ------------

    def _hijack(self, conn: socket.socket, sni: str) -> None:
        from ..utils import faultinject

        faultinject.fire("sni.hijack")
        ctx = self.certs.context_for(sni)
        with ctx.wrap_socket(conn, server_side=True) as tls:
            tls.settimeout(self.handshake_timeout)
            request = b""
            while b"\r\n\r\n" not in request and len(request) < MAX_HELLO:
                chunk = tls.recv(4096)
                if not chunk:
                    break
                request += chunk
            line = request.split(b"\r\n", 1)[0].decode("latin-1", "replace")
            parts = line.split(" ")
            if len(parts) < 2 or parts[0] != "GET":
                tls.sendall(b"HTTP/1.1 405 Method Not Allowed\r\n\r\n")
                return
            url = f"https://{sni}{parts[1]}"
            # The request is in: what follows (the P2P fetch, then the
            # body) is bounded by the idle timeout.  sendall's timeout is a
            # total, so the handshake's would cut a body that takes longer
            # to drain than it.
            tls.settimeout(self.idle_timeout)
            use_p2p, effective = (True, url)
            if self.router is not None:
                use_p2p, effective = self.router.route(url)
            try:
                if use_p2p:
                    body = self._fetch_p2p(effective)
                else:
                    import urllib.request

                    with urllib.request.urlopen(effective, timeout=30) as resp:
                        body = resp.read()
            except Exception:  # noqa: BLE001
                tls.sendall(b"HTTP/1.1 502 Bad Gateway\r\n\r\n")
                return
            self.stats["hijacked"] += 1
            tls.sendall(
                b"HTTP/1.1 200 OK\r\nContent-Length: "
                + str(len(body)).encode()
                + b"\r\nConnection: close\r\n\r\n"
                + body
            )

    def _fetch_p2p(self, url: str) -> bytes:
        return fetch_via_p2p(self.daemon, url, self.piece_size)

    # -- relay: the peeked bytes are still in the kernel queue --------------

    def _relay(self, conn: socket.socket, sni: str) -> None:
        target = (sni, self.relay_port)
        if self.upstream_resolver is not None:
            target = self.upstream_resolver(sni)
        try:
            if self.upstream_resolver is None:
                resolved = socket.getaddrinfo(
                    target[0], target[1], proto=socket.IPPROTO_TCP
                )
                own_ip, own_port = self.address[0], self.address[1]
                for *_, addr in resolved:
                    if addr[1] == own_port and (
                        addr[0] == own_ip
                        or (own_ip == "0.0.0.0" and addr[0].startswith("127."))
                    ):
                        self.stats["rejected"] += 1
                        conn.close()
                        return
            upstream = socket.create_connection(target, timeout=10)
        except OSError:
            conn.close()
            return
        self.stats["relayed"] += 1
        conn.settimeout(None)
        try:
            relay_bytes(conn, upstream, self.idle_timeout)
        finally:
            upstream.close()
            conn.close()
