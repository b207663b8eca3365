"""The port's flight-recorder reader, ``bench/trace_assemble.py``, held to
the reference's ``tools/trace_assemble.py`` on the same logs.

Each package's ``DurableSpanExporter`` writes one set of logs: a daemon's
and a scheduler's, one download trace across both (with a gap, an error
span and an orphan whose parent was never exported) and a second trace
in the scheduler alone; the daemon's log ends in a torn frame and the
scheduler's holds one digest-bad frame (a valid frame whose payload was
altered after its CRC was taken).  Both readers read both sets: equal
``build_report`` dicts, equal ``render_report`` text, byte-equal ``main
--json`` (and ``--json --validate``) output, and ``--markdown --update``
of one finds the other's block current.  ``--validate`` with
``jsonschema`` unimportable exits 2 naming it.  Planted fault: a replay
that admits the digest-bad frame must change the report.
"""

from __future__ import annotations

import json
import sys
import time
import zlib

import pytest

from dragonfly2_tpu_torch.bench import trace_assemble as port_ta
from dragonfly2_tpu_torch.utils import tracing as port_tracing


def _jax_modules():
    from dragonfly2_tpu.utils import tracing as jax_tracing
    from tools import trace_assemble as jax_ta

    return jax_tracing, jax_ta


def write_logs(tracing, directory):
    """Two processes' logs of one download trace (and one more trace),
    each flawed as the module docstring says → (daemon log, scheduler
    log, the download's trace id)."""
    dlog = str(directory / "daemon.dftrace")
    slog = str(directory / "sched.dftrace")
    d_exp = tracing.DurableSpanExporter(dlog, service="dfdaemon")
    s_exp = tracing.DurableSpanExporter(slog, service="scheduler")
    daemon = tracing.Tracer("dfdaemon", d_exp)
    sched = tracing.Tracer("scheduler", s_exp)
    with daemon.span("daemon/download", task_id="t1") as root:
        tp = root.traceparent
        with sched.remote_span("rpc/register_peer", tp):
            pass
        for n in range(3):
            with daemon.span("daemon/piece", number=n) as ps:
                ps.set(bytes=4096, parent="p0", retries=0)
                with sched.remote_span("rpc/report_piece_finished",
                                       daemon.inject()["traceparent"]):
                    pass
        time.sleep(0.06)  # no leaf span running: a gap
        with daemon.remote_span("daemon/report.flush", tp, reports=3):
            with sched.remote_span("rpc/report_pieces_finished",
                                   daemon.inject()["traceparent"]):
                pass
        # The parent span id names a span no process exported.
        with sched.remote_span("scheduler/eval.flush", f"00-{root.trace_id}-{'ab' * 8}-01",
                               rows=4):
            pass
        try:
            with sched.remote_span("rpc/report_piece_failed", tp):
                raise RuntimeError("piece 3 failed")
        except RuntimeError:
            pass
    with sched.span("scheduler/gc"):
        pass
    d_exp.close()
    s_exp.close()
    # A valid frame whose payload changed after its CRC was taken.
    payload = json.dumps(tracing.build_export_request("scheduler", []), sort_keys=True)
    forged = payload.replace("[]", '[{"name": "forged", "spanId": "ff", "traceId": "ff"}]')
    assert forged != payload
    with open(slog, "ab") as f:
        f.write(b"DFTL1 " + f"{len(forged)} {zlib.crc32(payload.encode()):08x}\n".encode()
                + forged.encode() + b"\n")
    with open(dlog, "ab") as f:
        f.write(b"DFTL1 4096 0badf00d\n{\"resourceSp")
    return dlog, slog, root.trace_id


@pytest.fixture(params=["port", "jax"])
def logs(request, tmp_path):
    jax_tracing, _ = _jax_modules()
    tracing = port_tracing if request.param == "port" else jax_tracing
    return write_logs(tracing, tmp_path)


def test_the_logs_carry_every_flaw(logs):
    dlog, slog, trace_id = logs
    report = port_ta.build_report([dlog, slog])
    by_path = {log["path"]: log for log in report["logs"]}
    assert by_path[dlog]["torn_tail"] and by_path[dlog]["corrupt"] == 0
    assert by_path[slog]["corrupt"] == 1 and not by_path[slog]["torn_tail"]
    assert report["traces"] == 2
    trace = report["trace"]
    assert trace["trace_id"] == trace_id
    assert trace["services"] == ["dfdaemon", "scheduler"]
    assert trace["critical_path"][0]["name"] == "daemon/download"
    assert any("orphan span scheduler/eval.flush" in a for a in trace["anomalies"])
    assert any("error span rpc/report_piece_failed" in a for a in trace["anomalies"])
    assert trace["gaps"] and trace["gaps"][0]["duration_ms"] >= 50.0
    assert "forged" not in json.dumps(report)


@pytest.mark.parametrize("gap_ms", [50.0, 5.0])
def test_report_and_render_equal_the_references(logs, gap_ms):
    _, jax_ta = _jax_modules()
    dlog, slog, trace_id = logs
    for kwargs in ({}, {"trace_id": trace_id}, {"validate": True}):
        want = jax_ta.build_report([dlog, slog], gap_ms=gap_ms, **kwargs)
        got = port_ta.build_report([dlog, slog], gap_ms=gap_ms, **kwargs)
        assert got == want
        assert port_ta.render_report(got) == jax_ta.render_report(want)
    for log in (dlog, slog):
        assert port_ta.build_report([log]) == jax_ta.build_report([log])


@pytest.mark.parametrize("extra", [[], ["--validate"], ["--gap-ms", "5"]])
def test_main_json_is_byte_equal(logs, capsys, extra):
    _, jax_ta = _jax_modules()
    dlog, slog, _ = logs
    assert jax_ta.main([dlog, slog, "--json", *extra]) == 0
    want = capsys.readouterr().out
    assert port_ta.main([dlog, slog, "--json", *extra]) == 0
    got = capsys.readouterr().out
    assert got == want and json.loads(got)["traces"] == 2


def test_markdown_update_finds_the_others_block_current(logs, tmp_path, capsys):
    _, jax_ta = _jax_modules()
    dlog, slog, _ = logs
    doc = tmp_path / "OBS.md"
    doc.write_text(f"# head\n{port_ta.ASSEMBLY_BEGIN}\nstale\n{port_ta.ASSEMBLY_END}\ntail\n")
    assert port_ta.main([dlog, slog, "--markdown", str(doc), "--update"]) == 0
    assert capsys.readouterr().out == f"{doc}: trace assembly updated\n"
    text = doc.read_text()
    assert "stale" not in text and text.startswith("# head\n") and text.endswith("tail\n")
    assert "Critical path:" in text
    assert jax_ta.main([dlog, slog, "--markdown", str(doc), "--update"]) == 0
    assert capsys.readouterr().out == f"{doc}: trace assembly already current\n"
    assert port_ta.main([dlog, slog, "--markdown", str(doc), "--update"]) == 0
    assert capsys.readouterr().out == f"{doc}: trace assembly already current\n"
    assert doc.read_text() == text


def test_validate_without_jsonschema_exits_2_naming_it(logs, monkeypatch, capsys):
    dlog, slog, _ = logs
    monkeypatch.setitem(sys.modules, "jsonschema", None)
    assert port_ta.main([dlog, slog, "--json", "--validate"]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "jsonschema" in captured.err
    # Without --validate the reader needs no jsonschema.
    assert port_ta.main([dlog, slog, "--json"]) == 0


def _admit_every_frame(path):
    """Planted fault: ``replay_trace_log`` that skips the digest check."""
    with open(path, "rb") as f:
        data = f.read()
    requests, torn, pos = [], False, 0
    while True:
        idx = data.find(port_tracing.FRAME_MAGIC, pos)
        if idx < 0:
            break
        nl = data.find(b"\n", idx)
        length = int(data[idx + len(port_tracing.FRAME_MAGIC):nl].split()[0])
        payload = data[nl + 1:nl + 1 + length]
        if len(payload) < length:
            torn = True
            break
        requests.append(json.loads(payload))
        pos = nl + 1 + length
    return requests, {"frames": len(requests), "corrupt": 0, "torn_tail": torn}


def test_admitting_the_digest_bad_frame_is_caught(logs, monkeypatch):
    _, jax_ta = _jax_modules()
    dlog, slog, _ = logs
    want = jax_ta.build_report([dlog, slog])
    monkeypatch.setattr(port_tracing, "replay_trace_log", _admit_every_frame)
    got = port_ta.build_report([dlog, slog])
    assert got != want
    assert got["total_spans"] == want["total_spans"] + 1 and got["traces"] == 3
