"""Uniform diagnostics endpoint: ``/metrics`` + ``/debug/spans`` on
every plane (DESIGN.md §21).

The manager serves these routes on its REST surface; the scheduler and
daemon — whose primary listeners speak the RPC/piece wire — get the same
surface from this loopback sidecar (reference: every binary runs a
metrics listener, scheduler/metrics/metrics.go:44-180 + the
grpc_prometheus handler):

  GET /metrics          — Prometheus text exposition (default registry)
  GET /debug/spans      — recent-span ring as ONE OTLP/JSON
                          ExportTraceServiceRequest (the same shape the
                          durable trace log frames carry, so operator
                          tooling parses both identically)
  GET /debug/exemplars  — histogram exemplars: last trace id per bucket,
                          joining a slow-bucket latency to its trace in
                          the flight recorder
  GET /debug/slo        — the SLO engine's last evaluation (burn rates,
                          breach verdicts per declared SLO; DESIGN.md
                          §23) — the machine-readable overload signal
                          the SLO autopilot consumes

Gated behind config (``metrics.enable``); binds loopback by default —
the exposition includes label values operators may consider internal.

Port of ``dragonfly2_tpu/utils/diagnostics.py``, verbatim but for
``stop``, which the port may call twice (the serve handle and the end
of a binary's ``run``).
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler
from typing import Tuple

from ..rpc._server import ThreadedHTTPService


class DiagnosticsServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _body(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                from .metrics import default_registry

                if self.path == "/metrics":
                    self._body(
                        200,
                        default_registry.expose_text().encode(),
                        "text/plain; version=0.0.4",
                    )
                elif self.path == "/debug/spans":
                    from .tracing import recent_spans_otlp

                    self._body(
                        200,
                        json.dumps(recent_spans_otlp()).encode(),
                        "application/json",
                    )
                elif self.path == "/debug/exemplars":
                    self._body(
                        200,
                        json.dumps(default_registry.exemplars()).encode(),
                        "application/json",
                    )
                elif self.path == "/debug/slo":
                    from .slo import debug_state

                    self._body(
                        200,
                        json.dumps(debug_state()).encode(),
                        "application/json",
                    )
                else:
                    self._body(404, b"not found\n", "text/plain")

        self._svc = ThreadedHTTPService(Handler, host, port, "diagnostics")
        self.address: Tuple[str, int] = self._svc.address
        self._stopped = False

    @property
    def url(self) -> str:
        return self._svc.url

    def serve(self) -> None:
        self._svc.serve()

    def stop(self) -> None:
        if not self._stopped:
            self._stopped = True
            self._svc.stop()
