"""Port parity: the flight recorder, ``dragonfly2_tpu_torch/utils/tracing.py``
against ``dragonfly2_tpu/utils/tracing.py`` (the counterpart of
``tests/test_tracing.py``).

- The same spans give equal OTLP/JSON requests; spans opened through
  each package's ``Tracer`` give requests equal up to ids and times.  The
  one difference on purpose is the OTLP scope name (each module's own).
  The port's requests validate against its vendored OTLP schema.
- ``trace_sampled`` decides identically over 10,000 seeded trace ids.
- ``parse_traceparent`` and ``remote_span`` agree on the reference's
  hostile headers and on seeded random ones.
- Each package's ``replay_trace_log`` reads the other's durable log,
  with a torn tail and with a digest-bad frame.
- The tracing toggle and the composite exporter behave alike.
- ``traceparent`` links the client's span to the server's handler span
  over the HTTP wire, both ways across the packages.

Every test restores both packages' default tracers.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import dragonfly2_tpu.rpc as jrpc
import dragonfly2_tpu.utils.tracing as jtr
from dragonfly2_tpu.records.storage import Storage as JStorage
from dragonfly2_tpu.scheduler import Evaluator as JEvaluator
from dragonfly2_tpu.scheduler import Resource as JResource
from dragonfly2_tpu.scheduler import SchedulerService as JSchedulerService
from dragonfly2_tpu.scheduler import Scheduling as JScheduling
from dragonfly2_tpu.scheduler import SchedulingConfig as JSchedulingConfig
from dragonfly2_tpu.scheduler.resource import Host as JHost
from dragonfly2_tpu_torch import rpc as trpc
from dragonfly2_tpu_torch.records.storage import Storage
from dragonfly2_tpu_torch.scheduler import (
    Evaluator,
    Resource,
    SchedulerService,
    Scheduling,
    SchedulingConfig,
)
from dragonfly2_tpu_torch.scheduler.resource import Host
from dragonfly2_tpu_torch.utils import tracing as ttr
from test_tracing import HOSTILE_TRACEPARENTS

PKGS = {"jax": jtr, "torch": ttr}


@pytest.fixture()
def rings():
    """A fresh in-memory ring on both packages' default tracers, tracing
    on; the exporters and the toggles are restored after."""
    saved = [(m, m.default_tracer.exporter, m.enabled()) for m in PKGS.values()]
    out = {}
    for name, m in PKGS.items():
        out[name] = m.default_tracer.exporter = m.InMemoryExporter()
        m.set_enabled(True)
    yield out
    for m, exporter, enabled in saved:
        m.default_tracer.exporter = exporter
        m.set_enabled(enabled)


def _fixed_spans(mod):
    """Spans with fixed ids, times and every attribute type OTLP maps."""
    return [
        mod.Span("root", "a" * 32, "b" * 16, None, 1_000, 5_000,
                 {"n": 3, "x": 0.5, "ok": True, "s": "str", "none": None}),
        mod.Span("child", "a" * 32, "c" * 16, "b" * 16, 2_000, 3_000,
                 {"rows": 128}, status="error: ValueError"),
    ]


def _normalized(request):
    """An OTLP request with ids, times and the scope name blanked."""
    req = json.loads(json.dumps(request))
    for rs in req["resourceSpans"]:
        for ss in rs["scopeSpans"]:
            ss["scope"]["name"] = ""
            for span in ss["spans"]:
                for key in ("traceId", "spanId", "parentSpanId",
                            "startTimeUnixNano", "endTimeUnixNano"):
                    if key in span:
                        span[key] = "x"
    return req


def test_otlp_requests_equal_for_the_same_spans():
    j = jtr.build_export_request("svc", _fixed_spans(jtr))
    t = ttr.build_export_request("svc", _fixed_spans(ttr))
    assert t["resourceSpans"][0]["scopeSpans"][0]["scope"]["name"] == ttr.__name__
    j["resourceSpans"][0]["scopeSpans"][0]["scope"]["name"] = ttr.__name__
    assert t == j
    import jsonschema

    jsonschema.Draft202012Validator(ttr.otlp_trace_schema()).validate(t)
    assert ttr.otlp_trace_schema() == jtr.otlp_trace_schema()


def test_traced_spans_give_equal_requests_up_to_ids_and_times():
    def drive(mod):
        ring = mod.InMemoryExporter()
        t = mod.Tracer("svc", ring)
        with t.span("outer", batch=4, rows=37, jit_compiles=0):
            with t.span("inner", kind="x"):
                pass
            with pytest.raises(RuntimeError):
                with t.span("failing", step=2):
                    raise RuntimeError("boom")
        spans = list(ring.spans)
        assert spans[0].parent_id == spans[2].span_id == spans[1].parent_id
        assert len({s.trace_id for s in spans}) == 1
        return mod.build_export_request("svc", spans)

    assert _normalized(drive(ttr)) == _normalized(drive(jtr))


def test_trace_sampled_decides_identically_over_seeded_ids():
    rng = np.random.default_rng(0)
    ids = ["%032x" % int(v) for v in rng.integers(0, 2**63, 10_000, dtype=np.int64)]
    for rate in (0.0, 0.001, 0.1, 0.5, 0.9, 1.0):
        j = [jtr.trace_sampled(i, rate) for i in ids]
        t = [ttr.trace_sampled(i, rate) for i in ids]
        assert t == j
        if 0.0 < rate < 1.0:
            assert abs(sum(t) / len(t) - rate) < 0.02


def _random_headers(n=500):
    rng = np.random.default_rng(1)
    hexchars = "0123456789abcdefABCDEFxyz-"
    out = []
    for _ in range(n):
        parts = ["".join(rng.choice(list(hexchars), size=int(k)))
                 for k in rng.choice([0, 2, 16, 31, 32, 33], size=int(rng.integers(1, 6)))]
        out.append("-".join(parts))
    out += ["00-%032x-%016x-01" % (int(rng.integers(0, 2**62)), int(rng.integers(0, 2**62)))
            for _ in range(50)]
    return out


def _remote_spans_agree(value):
    assert ttr.parse_traceparent(value) == jtr.parse_traceparent(value)
    parsed = ttr.parse_traceparent(value)
    for mod in PKGS.values():
        t = mod.Tracer("t", mod.InMemoryExporter())
        with t.remote_span("handler", value) as span:
            if parsed is None:
                assert span.parent_id is None and len(span.trace_id) == 32
            else:
                assert (span.trace_id, span.parent_id) == parsed


@pytest.mark.parametrize("value", HOSTILE_TRACEPARENTS)
def test_parse_traceparent_and_remote_span_agree_on_hostile_headers(value):
    _remote_spans_agree(value)


def test_parse_traceparent_and_remote_span_agree_on_seeded_headers():
    values = _random_headers()
    assert sum(ttr.parse_traceparent(v) is not None for v in values) >= 50
    for value in values:
        _remote_spans_agree(value)


def _write_log(mod, path, n, service="svc"):
    exporter = mod.DurableSpanExporter(str(path), service=service)
    t = mod.Tracer(service, exporter)
    for i in range(n):
        with t.span("work", i=i):
            pass
    exporter.close()
    return exporter


@pytest.mark.parametrize("writer", sorted(PKGS))
def test_each_package_replays_the_others_durable_log(tmp_path, writer):
    path = tmp_path / "proc.dftrace"
    exporter = _write_log(PKGS[writer], path, 6)
    assert exporter.exported == 6
    data = path.read_bytes()
    results = {}
    for name, mod in PKGS.items():
        reqs, stats = mod.replay_trace_log(str(path))
        assert stats == {"frames": 6, "corrupt": 0, "torn_tail": False}
        results[name] = [s["attributes"] for s in mod.log_spans(reqs)]
    assert results["jax"] == results["torch"]
    # A SIGKILL's torn tail: the last frame cut mid-payload.
    path.write_bytes(data[:-7])
    for mod in PKGS.values():
        reqs, stats = mod.replay_trace_log(str(path))
        assert stats == {"frames": 5, "corrupt": 0, "torn_tail": True}
    # A digest-bad frame in the middle is never admitted; the rest are.
    second = data.index(b"DFTL1 ", 1)
    bad = bytearray(data)
    bad[data.index(b"\n", second) + 5] ^= 0x01
    path.write_bytes(bytes(bad))
    for mod in PKGS.values():
        reqs, stats = mod.replay_trace_log(str(path))
        assert stats == {"frames": 5, "corrupt": 1, "torn_tail": False}


def test_durable_frames_equal_but_the_scope_name(tmp_path):
    frames = {}
    for name, mod in PKGS.items():
        exporter = mod.DurableSpanExporter(str(tmp_path / name), service="svc")
        exporter._write(_fixed_spans(mod))
        exporter.close()
        data = (tmp_path / name).read_bytes()
        header, payload = data.split(b"\n", 1)
        frames[name] = json.loads(payload)
        assert header.startswith(b"DFTL1 ")
    frames["jax"]["resourceSpans"][0]["scopeSpans"][0]["scope"]["name"] = ttr.__name__
    assert frames["torch"] == frames["jax"]


def test_sampling_keeps_whole_traces_alike(tmp_path):
    kept = {}
    for name, mod in PKGS.items():
        exporter = mod.DurableSpanExporter(str(tmp_path / name), service="s", sample_rate=0.3)
        t = mod.Tracer("s", exporter)
        for i in range(200):
            with t.span("root", i=i):
                with t.span("leaf", i=i):
                    pass
        exporter.close()
        reqs, _ = mod.replay_trace_log(str(tmp_path / name))
        spans = list(mod.log_spans(reqs))
        by_trace = {}
        for s in spans:
            by_trace.setdefault(s["traceId"], set()).add(s["name"])
        assert all(v == {"root", "leaf"} for v in by_trace.values())
        assert exporter.sampled_out + exporter.exported == 400
        kept[name] = all(mod.trace_sampled(tid, 0.3) for tid in by_trace)
    assert kept == {"jax": True, "torch": True}


def test_toggle_and_composite_exporter_alike(tmp_path, rings):
    for name, mod in PKGS.items():
        ring = mod.InMemoryExporter(max_spans=4)
        durable = mod.DurableSpanExporter(str(tmp_path / name), service="s")
        t = mod.Tracer("s", mod.CompositeExporter([ring, durable]))
        mod.set_enabled(False)
        with t.span("off", x=1) as span:
            span.set(y=2)
            assert span.traceparent == ""
        mod.set_enabled(True)
        for i in range(6):
            with t.span("on", i=i):
                pass
        durable.close()
        assert [s.attributes["i"] for s in ring.spans] == [2, 3, 4, 5]
        assert mod.replay_trace_log(str(tmp_path / name))[1]["frames"] == 6
        mod.default_tracer.exporter = t.exporter
        dump = mod.recent_spans_otlp()
        assert len(dump["resourceSpans"][0]["scopeSpans"][0]["spans"]) == 4


def _server(pkg, tmp_path):
    if pkg == "jax":
        resource = JResource()
        service = JSchedulerService(
            resource, JScheduling(JEvaluator(), JSchedulingConfig(retry_interval=0)),
            JStorage(str(tmp_path / "jax_records")))
        return jrpc.SchedulerHTTPServer(service)
    resource = Resource()
    service = SchedulerService(
        resource, Scheduling(Evaluator(), SchedulingConfig(retry_interval=0)),
        Storage(str(tmp_path / "port_records")))
    return trpc.SchedulerHTTPServer(service)


@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("torch", "jax"), ("jax", "torch"), ("torch", "torch")])
def test_traceparent_links_client_and_server_spans(tmp_path, rings, client_pkg, server_pkg):
    server = _server(server_pkg, tmp_path)
    server.serve()
    try:
        client_mod = PKGS[client_pkg]
        client = (jrpc if client_pkg == "jax" else trpc).RemoteScheduler(server.url, timeout=30)
        host_cls = JHost if client_pkg == "jax" else Host
        host = host_cls(id="h-trace", hostname="h", ip="10.0.0.1", port=8002,
                        download_port=8001)
        with client_mod.default_tracer.span("client/announce") as root:
            client.announce_host(host)
        # Outside a span the client sends no header: the handler's span
        # is a local root.
        client.announce_host(host)
    finally:
        server.stop()
    handled = rings[server_pkg].find("rpc/announce_host")
    assert len(handled) == 2
    linked, local = handled
    assert (linked.trace_id, linked.parent_id) == (root.trace_id, root.span_id)
    assert linked.attributes == {"transport": "http"}
    assert local.parent_id is None and local.trace_id != root.trace_id
