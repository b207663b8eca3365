"""Shared HTTP server scaffold for the rpc package's services."""

from __future__ import annotations

import logging
import ssl
import threading
from http.server import ThreadingHTTPServer
from typing import Optional, Tuple, Type


class ThreadedHTTPService:
    """Owns a ThreadingHTTPServer + its serve thread (one lifecycle impl
    for the scheduler RPC, piece, and REST servers).

    ``ssl_context`` wraps the listening socket — with a mutual-TLS context
    (security.tls.server_context) every connecting client must present a
    CA-issued certificate."""

    def __init__(
        self, handler_cls: Type, host: str, port: int, name: str, ssl_context=None
    ):
        # A per-SERVICE subclass (never mutate the caller's class — that
        # would leak a timeout into every other user of it): adds the
        # per-connection read timeout so a stalled client can't pin a
        # handler thread, and swallows TLS handshake failures quietly (the
        # deferred handshake surfaces SSLError on first read; an anonymous
        # client or port scanner is routine, not a traceback).
        class _Handler(handler_cls):  # type: ignore[misc,valid-type]
            timeout = 60

            def handle(self):
                from ..utils import faultinject

                try:
                    # Server-side chaos seam: a drop/dferror here kills
                    # the connection before any request is served — the
                    # client sees a reset, exactly like a dying server.
                    faultinject.fire(f"rpc.server.{name}")
                except Exception as exc:  # noqa: BLE001 — injected
                    logging.getLogger(__name__).debug(
                        "injected fault at rpc.server.%s: %s", name, exc
                    )
                    self.close_connection = True
                    return
                try:
                    super().handle()
                except (ssl.SSLError, ConnectionError, TimeoutError):
                    self.close_connection = True

        _Handler.__name__ = f"{handler_cls.__name__}@{name}"
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._tls = ssl_context is not None
        if ssl_context is not None:
            # Handshake deferred to first read, which happens in the
            # per-connection HANDLER thread — with the default
            # do_handshake_on_connect=True the handshake runs inside
            # accept() on the single serve thread, so one stalled client
            # would block every other connection.
            self._httpd.socket = ssl_context.wrap_socket(
                self._httpd.socket, server_side=True,
                do_handshake_on_connect=False,
            )
        self.address: Tuple[str, int] = self._httpd.server_address
        self._name = name
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.address[1]

    @property
    def url(self) -> str:
        scheme = "https" if self._tls else "http"
        return f"{scheme}://{self.address[0]}:{self.address[1]}"

    def serve(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name=self._name, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
