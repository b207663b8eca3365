"""AF_VSOCK transport (reference: pkg/rpc/vsock.go — the dialer/listener
dfdaemon exposes to VM guests, ``vsock://<cid>:<port>`` addresses).

VM guests reach the host daemon without a network stack: the control
surface binds a vsock listener alongside its TCP one, and guest-side
clients dial ``vsock://2:port`` (CID 2 = the host).  Python's stdlib
http.server runs unchanged over the family — only the bind differs.

Port of ``dragonfly2_tpu/rpc/vsock.py``, verbatim.
"""

from __future__ import annotations

import http.client
import socket
import threading
import urllib.parse
from http.server import ThreadingHTTPServer
from typing import Optional, Tuple

# Linux well-known CIDs (linux/vm_sockets.h).
VMADDR_CID_ANY = 0xFFFFFFFF
VMADDR_CID_LOCAL = 1   # loopback (vsock_loopback module)
VMADDR_CID_HOST = 2    # the hypervisor host, from a guest
# vsock's "ephemeral port" sentinel is -1U, NOT the TCP-style 0 (binding
# literal port 0 binds port 0).
VMADDR_PORT_ANY = 0xFFFFFFFF


def vsock_available() -> bool:
    if not hasattr(socket, "AF_VSOCK"):
        return False
    try:
        s = socket.socket(socket.AF_VSOCK, socket.SOCK_STREAM)
        s.close()
        return True
    except OSError:
        return False


def parse_vsock_addr(address: str) -> Tuple[int, int]:
    """``vsock://<cid>:<port>`` → (cid, port) (vsock.go VsockDialer's
    URL shape).  Parsed by hand: vsock ports are u32, and urlsplit's
    ``.port`` enforces the TCP 0-65535 range."""
    u = urllib.parse.urlsplit(address)
    cid_s, sep, port_s = u.netloc.partition(":")
    if u.scheme != "vsock" or not sep or not cid_s.isdigit() or not port_s.isdigit():
        raise ValueError(f"not a vsock address: {address!r}")
    cid, port = int(cid_s), int(port_s)
    if cid > 0xFFFFFFFF or port > 0xFFFFFFFF:
        raise ValueError(f"not a vsock address: {address!r}")
    return cid, port


def vsock_connect(cid: int, port: int, *, timeout: float = 10.0) -> socket.socket:
    s = socket.socket(socket.AF_VSOCK, socket.SOCK_STREAM)
    s.settimeout(timeout)
    s.connect((cid, port))
    return s


class VsockHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer over an AF_VSOCK listener: the SAME handler
    classes the TCP services use, bound on (cid, port)."""

    address_family = socket.AF_VSOCK
    daemon_threads = True
    allow_reuse_address = False  # SO_REUSEADDR is TCP-only

    def server_bind(self):  # no getfqdn over vsock addresses
        self.socket.bind(self.server_address)
        self.server_address = self.socket.getsockname()
        self.server_name = f"vsock:{self.server_address[0]}"
        self.server_port = self.server_address[1]


class VsockService:
    """Serve an existing BaseHTTPRequestHandler over vsock."""

    def __init__(self, handler_cls, port: int, *, cid: int = VMADDR_CID_ANY):
        # TCP idiom compatibility: port 0 = "pick one" → vsock's -1U.
        self._httpd = VsockHTTPServer(
            (cid, VMADDR_PORT_ANY if port == 0 else port), handler_cls
        )
        self.address: Tuple[int, int] = self._httpd.server_address
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.address[1]

    def serve(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="vsock-http", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


class VsockHTTPConnection(http.client.HTTPConnection):
    """http.client.HTTPConnection whose transport is a vsock stream —
    the stdlib owns ALL request/response framing (chunked transfer
    included; the control handler's /obtain_seeds streams chunked);
    only the dial differs."""

    def __init__(self, cid: int, port: int, *, timeout: float = 10.0):
        super().__init__(f"vsock-{cid}", timeout=timeout)
        self.cid = cid
        self.vsock_port = port

    def connect(self) -> None:
        self.sock = vsock_connect(self.cid, self.vsock_port, timeout=self.timeout)

    def call(
        self, method: str, path: str, body: bytes = b"",
        headers: Optional[dict] = None,
    ) -> Tuple[int, bytes]:
        """One-shot convenience: → (status, decoded body bytes)."""
        self.request(method, path, body=body, headers=headers or {})
        resp = self.getresponse()
        try:
            return resp.status, resp.read()
        finally:
            self.close()
