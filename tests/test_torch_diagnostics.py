"""The diagnostics plane at the reference's defaults, in the port.

Port counterparts of ``tests/test_observability.py``'s
``TestDiagnosticsServer`` and ``TestManagerDiagnosticsRoutes``, then:
both packages' ``/debug/spans`` body validated against
``utils/otlp_trace_schema.json``; a port scheduler started through
``run`` at its defaults (``metrics.port`` 0) answering ``/metrics`` at the
URL its boot line prints; a second ``run`` while a socket holds its port,
which only warns and keeps serving; and the port stopping its sidecar
with the serve handle.  No test here asserts who holds port 8000.
"""

from __future__ import annotations

import json
import os
import re
import select
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import jsonschema
import pytest

from dragonfly2_tpu_torch.utils import tracing
from dragonfly2_tpu_torch.utils.diagnostics import DiagnosticsServer
from dragonfly2_tpu_torch.utils.metrics import default_registry

REPO = Path(__file__).resolve().parents[1]


def _get(url: str):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.status, resp.headers.get("Content-Type", ""), resp.read()


@pytest.fixture()
def server():
    srv = DiagnosticsServer(port=0)
    srv.serve()
    yield srv
    srv.stop()


@pytest.fixture()
def ring_exporter():
    """Route the port's tracer through an in-memory ring as well, and put
    the exporter back after the test."""
    prev = tracing.default_tracer.exporter
    tracing.default_tracer.exporter = tracing.CompositeExporter(
        [tracing.InMemoryExporter(max_spans=16), prev])
    yield
    tracing.default_tracer.exporter = prev


class TestDiagnosticsServer:
    def test_metrics_endpoint_serves_default_registry(self, server):
        default_registry.counter("diag_probe_total", "probe").inc()
        status, ctype, body = _get(server.url + "/metrics")
        assert status == 200 and "text/plain" in ctype
        assert b"diag_probe_total" in body
        assert b"# HELP" in body and b"# TYPE" in body

    def test_debug_spans_returns_otlp_request(self, server, ring_exporter):
        with tracing.default_tracer.span("diag-probe"):
            pass
        status, ctype, body = _get(server.url + "/debug/spans")
        assert status == 200 and "json" in ctype
        req = json.loads(body)
        jsonschema.Draft202012Validator(tracing.otlp_trace_schema()).validate(req)
        assert "diag-probe" in [s["name"] for s in tracing.log_spans([req])]

    def test_debug_exemplars_json(self, server):
        h = default_registry.histogram("diag_lat_seconds", "lat")
        with tracing.default_tracer.span("diag-exemplar") as s:
            h.observe(0.02)
        status, _ctype, body = _get(server.url + "/debug/exemplars")
        assert status == 200
        payload = json.loads(body)
        assert any(s.trace_id in per_bucket.values()
                   for metric in payload.values() for per_bucket in metric.values())

    def test_debug_slo_json(self, server):
        from dragonfly2_tpu_torch.utils.slo import debug_state

        status, ctype, body = _get(server.url + "/debug/slo")
        assert status == 200 and "json" in ctype
        assert json.loads(body) == json.loads(json.dumps(debug_state()))

    def test_unknown_route_404(self, server):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server.url + "/nope")
        assert e.value.code == 404

    def test_stop_twice_closes_the_port(self):
        srv = DiagnosticsServer(port=0)
        srv.serve()
        url = srv.url
        srv.stop()
        srv.stop()
        with pytest.raises(OSError):
            _get(url + "/metrics")


class TestManagerDiagnosticsRoutes:
    """The manager serves the same surface on its REST port, with no
    backing object: 200, not 404."""

    def test_metrics_and_debug_spans(self):
        from dragonfly2_tpu_torch.manager.cluster import ClusterManager
        from dragonfly2_tpu_torch.manager.registry import ModelRegistry
        from dragonfly2_tpu_torch.manager.rest import ManagerRESTServer

        server = ManagerRESTServer(ModelRegistry(), ClusterManager())
        server.serve()
        try:
            status, ctype, body = _get(server.url + "/metrics")
            assert status == 200 and "text/plain" in ctype and b"# TYPE" in body
            status, _, body = _get(server.url + "/debug/spans")
            assert status == 200
            json.loads(body)["resourceSpans"]
            status, _, body = _get(server.url + "/debug/exemplars")
            assert status == 200
            json.loads(body)
            status, _, body = _get(server.url + "/debug/slo")
            assert status == 200
            json.loads(body)
        finally:
            server.stop()


@pytest.mark.parametrize("package", ["port", "jax"])
def test_debug_spans_body_validates_against_the_otlp_schema(package, ring_exporter):
    if package == "port":
        diag, tr = DiagnosticsServer, tracing
    else:
        import dragonfly2_tpu.utils.tracing as tr
        from dragonfly2_tpu.utils.diagnostics import DiagnosticsServer as diag
    prev = tr.default_tracer.exporter
    if tr is not tracing:
        tr.default_tracer.exporter = tr.CompositeExporter([tr.InMemoryExporter(max_spans=16), prev])
    srv = diag(port=0)
    srv.serve()
    try:
        with tr.default_tracer.span(f"diag-schema-{package}", attr="x"):
            pass
        _status, _ctype, body = _get(srv.url + "/debug/spans")
    finally:
        srv.stop()
        tr.default_tracer.exporter = prev
    schema = json.loads((REPO / "dragonfly2_tpu_torch/utils/otlp_trace_schema.json").read_text())
    assert schema == json.loads((REPO / "dragonfly2_tpu/utils/otlp_trace_schema.json").read_text())
    req = json.loads(body)
    jsonschema.Draft202012Validator(schema).validate(req)
    assert f"diag-schema-{package}" in [s["name"] for s in tracing.log_spans([req])]


# -- the scheduler binary's sidecar --------------------------------------------


def _start_scheduler(tmp_path, metrics_port: int, tag: str):
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "DRAGONFLY_SCHEDULER_STORAGE_DIR": str(tmp_path / f"records-{tag}"),
           "DRAGONFLY_SCHEDULER_SERVER_PORT": "0",
           "DRAGONFLY_SCHEDULER_SERVER_HOST": "127.0.0.1",
           "DRAGONFLY_SCHEDULER_METRICS_PORT": str(metrics_port)}
    return subprocess.Popen(
        [sys.executable, "-m", "dragonfly2_tpu_torch.cli.scheduler", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(tmp_path))


def _lines_until(proc, marker: str, limit_s: float = 60.0):
    out = []
    deadline = time.time() + limit_s
    while time.time() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], max(deadline - time.time(), 0.1))
        if not ready:
            break
        line = proc.stdout.readline()
        if not line:
            break
        out.append(line)
        if marker in line:
            break
    return out


def _stop(proc) -> int:
    # The boot line comes just before run() installs its signal handlers.
    time.sleep(0.5)
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()


def test_scheduler_run_serves_metrics_at_its_boot_line(tmp_path):
    proc = _start_scheduler(tmp_path, 0, "a")
    try:
        lines = _lines_until(proc, "scheduler: serving rpc on")
        text = "".join(lines)
        m = re.search(r"scheduler: diagnostics on (http://127\.0\.0\.1:\d+)/metrics", text)
        assert m and "serving rpc on" in text, text
        status, ctype, body = _get(m.group(1) + "/metrics")
        assert status == 200 and "text/plain" in ctype
        assert b"scheduler_" in body and b"# TYPE" in body
        status, _, body = _get(m.group(1) + "/debug/spans")
        assert status == 200 and "resourceSpans" in json.loads(body)
    finally:
        assert _stop(proc) == 0
    with pytest.raises(OSError):
        _get(m.group(1) + "/metrics")


def test_a_second_run_on_a_held_port_only_warns_and_serves(tmp_path):
    holder = socket.socket()
    holder.bind(("127.0.0.1", 0))
    holder.listen(1)
    port = holder.getsockname()[1]
    proc = _start_scheduler(tmp_path, port, "b")
    try:
        lines = _lines_until(proc, "scheduler: serving rpc on")
        text = "".join(lines)
        assert "diagnostics endpoint not started" in text, text
        assert "scheduler: diagnostics on" not in text
        from dragonfly2_tpu_torch.rpc import RemoteScheduler
        from dragonfly2_tpu_torch.scheduler.resource import Host

        url = re.search(r"serving rpc on (http://\S+)", text).group(1)
        RemoteScheduler(url).announce_host(
            Host(id="held-h", hostname="held-h", ip="127.0.0.1", download_port=1))
        assert proc.poll() is None
    finally:
        assert _stop(proc) == 0
        holder.close()


def test_serve_handle_stops_the_sidecar_run_handed_it(tmp_path, monkeypatch):
    from dragonfly2_tpu_torch.cli import scheduler as scheduler_cli
    from dragonfly2_tpu_torch.cli.common import init_diagnostics
    from dragonfly2_tpu_torch.config import SchedulerConfigFile

    cfg = SchedulerConfigFile()
    assert (cfg.metrics.enable, cfg.metrics.port) == (True, 8000)
    cfg.metrics.port = 0
    cfg.server.host, cfg.server.port = "127.0.0.1", 0
    cfg.storage.dir = str(tmp_path / "records")
    serving = scheduler_cli.serve(cfg, device="cpu", seed_trigger=False)
    serving.diagnostics = init_diagnostics(cfg.metrics, "scheduler")
    url = serving.diagnostics.url
    assert _get(url + "/metrics")[0] == 200
    serving.stop()
    with pytest.raises(OSError):
        _get(url + "/metrics")
    cfg.metrics.enable = False
    assert init_diagnostics(cfg.metrics, "scheduler") is None
