"""Port parity: the binaries' tracing and telemetry wiring,
``dragonfly2_tpu_torch/cli/{common,scheduler,trainer}.py`` against
``dragonfly2_tpu/cli/common.py`` and the ``tracing`` / ``telemetry``
config sections.

- Both binaries accept ``--trace-file``, ``--otlp``, ``--trace-log`` and
  ``--metric-journal`` and a config file with ``tracing`` and
  ``telemetry`` sections (and ``scheduling.qos_autopilot``): the
  sections load equal to the reference's, the process tracer gets the
  reference's exporters, the journal writes its final frame at exit and
  the SLO engine is installed while the binary runs and stopped after.
- ``init_flight_recorder`` and ``init_telemetry`` wire what the
  reference's wire for the same arguments.
- The serve mode's ``.stop()`` stops the journal and the engine.
- ``DF_FAULTINJECT`` in the environment is installed by both binaries: a
  ``crash`` at ``metrics.journal.write`` SIGKILLs the process.

Every test restores the port's default tracer, toggle and SLO install.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

import dragonfly2_tpu.cli.common as jcommon
import dragonfly2_tpu.config.schema as jschema
import dragonfly2_tpu.utils.slo as jslo
import dragonfly2_tpu.utils.tracing as jtr
import dragonfly2_tpu_torch.cli.common as tcommon
import dragonfly2_tpu_torch.config.schema as tschema
from dragonfly2_tpu_torch.cli import scheduler as scheduler_cli
from dragonfly2_tpu_torch.cli import trainer as trainer_cli
from dragonfly2_tpu_torch.utils import metric_journal as tmj
from dragonfly2_tpu_torch.utils import slo as tslo
from dragonfly2_tpu_torch.utils import tracing as ttr

REPO = Path(__file__).resolve().parents[1]

SLOS = [{"name": "flush", "objective": "latency", "metric": "scheduler_eval_flush_seconds",
         "threshold_ms": 50.0, "target": 0.99}]


@pytest.fixture(autouse=True)
def _restore():
    saved = [(m, m.default_tracer.exporter, m.default_tracer.service, m.enabled())
             for m in (jtr, ttr)]
    engines = (jslo.current_engine(), tslo.current_engine())
    yield
    for m, exporter, service, enabled in saved:
        m.default_tracer.exporter = exporter
        m.default_tracer.service = service
        m.set_enabled(enabled)
    jslo.install_engine(engines[0])
    tslo.install_engine(engines[1])


def _config(tmp_path, kind):
    path = tmp_path / f"{kind}.yaml"
    lines = [
        f"tracing: {{log_path: {tmp_path / 'cfg.dftrace'}, sample_rate: 1.0, ring_spans: 64}}",
        f"telemetry: {{journal_path: {tmp_path / 'cfg.dfmj'}, journal_interval_s: 30.0, "
        f"slo_interval_s: 30.0, slos: {json.dumps(SLOS)}}}",
    ]
    if kind == "scheduler":
        lines.append("scheduling: {qos_autopilot: false}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_sections_load_equal_to_the_references(tmp_path):
    for kind, cls in (("scheduler", "SchedulerConfigFile"), ("trainer", "TrainerConfigFile")):
        path = _config(tmp_path, kind)
        j = jschema.load_config(getattr(jschema, cls), path, env=False)
        t = tschema.load_config(getattr(tschema, cls), path, env=False)
        for section in ("tracing", "telemetry"):
            assert dataclasses.asdict(getattr(t, section)) == dataclasses.asdict(
                getattr(j, section))
        if kind == "scheduler":
            assert t.scheduling.qos_autopilot is j.scheduling.qos_autopilot is False
    # Keys whose reader is still missing keep exiting through ConfigError.
    bad = tmp_path / "sharded.yaml"
    bad.write_text("scheduling: {shard_max_inflight: 8}\n")
    with pytest.raises(tschema.ConfigError, match="item 14"):
        tschema.load_config(tschema.SchedulerConfigFile, str(bad), env=False)


def _exporters(mod):
    exporter = mod.default_tracer.exporter
    return exporter.exporters if isinstance(exporter, mod.CompositeExporter) else [exporter]


def _wiring(mod, common, schema, tmp_path, flags):
    args = argparse.Namespace(**{"otlp": None, "trace_file": None, "trace_log": None,
                                 "metric_journal": None, "_prog": "scheduler", **flags})
    mod.default_tracer.exporter = mod.InMemoryExporter()
    common.init_tracing(args)
    tracing_cfg = schema.TracingSection(log_path=str(tmp_path / "cfg.dftrace"),
                                         sample_rate=0.25, ring_spans=32)
    durable = common.init_flight_recorder(args, tracing_cfg, "scheduler")
    telemetry_cfg = schema.TelemetrySection(journal_path=str(tmp_path / "cfg.dfmj"),
                                             journal_interval_s=60.0, slos=SLOS)
    journal, engine = common.init_telemetry(args, telemetry_cfg, "scheduler")
    out = {
        "exporters": [(type(e).__name__, getattr(e, "path", getattr(e, "target", None)),
                       getattr(e, "sample_rate", None)) for e in _exporters(mod)],
        "durable": durable.path,
        "service": mod.default_tracer.service,
        "journal": (journal.path, journal.service, journal.interval_s),
        "engine": [s.name for s in engine.slos],
    }
    engine.close()
    journal.close()
    if durable is not None:
        durable.close()
    return out


@pytest.mark.parametrize("flags", [
    {},
    {"trace_log": "flag.dftrace", "metric_journal": "flag.dfmj"},
    {"otlp": "spans.otlp"},
    {"trace_file": "spans.jsonl"},
    {"otlp": "spans.otlp", "trace_file": "spans.jsonl", "trace_log": "flag.dftrace"},
])
def test_init_functions_wire_what_the_references_wire(tmp_path, flags):
    flags = {k: str(tmp_path / v) for k, v in flags.items()}
    got = {}
    for name, mod, common, schema in (("jax", jtr, jcommon, jschema),
                                      ("torch", ttr, tcommon, tschema)):
        got[name] = _wiring(mod, common, schema, tmp_path, flags)
    assert got["torch"] == got["jax"]


def _run_binary(cli, argv, tmp_path, monkeypatch):
    monkeypatch.setenv("DRAGONFLY_SCHEDULER_STORAGE_DIR", str(tmp_path / "records"))
    seen = {}
    real = tcommon.init_telemetry

    def spy(*args, **kwargs):
        seen["journal"], seen["engine"] = out = real(*args, **kwargs)
        seen["installed"] = tslo.current_engine() is out[1]
        return out

    monkeypatch.setattr(cli, "init_telemetry", spy)
    rc = cli.run(argv)
    return rc, seen


@pytest.mark.parametrize("kind", ["scheduler", "trainer"])
def test_binaries_take_the_flags_and_sections(tmp_path, monkeypatch, capsys, kind):
    cli = scheduler_cli if kind == "scheduler" else trainer_cli
    mode = (["--simulate", "8"] if kind == "scheduler"
            else ["--train-once", str(tmp_path / "empty")])
    argv = mode + ["--device", "cpu", "--config", _config(tmp_path, kind),
                   "--trace-log", str(tmp_path / "flag.dftrace"),
                   "--metric-journal", str(tmp_path / "flag.dfmj"),
                   "--otlp", str(tmp_path / "spans.otlp")]
    rc, seen = _run_binary(cli, argv, tmp_path, monkeypatch)
    assert rc == (0 if kind == "scheduler" else 1), capsys.readouterr()
    # The flags win over the config's paths; the config's sample rate rides.
    kinds = {type(e).__name__: e for e in _exporters(ttr)}
    assert set(kinds) == {"InMemoryExporter", "OTLPJSONExporter", "DurableSpanExporter"}
    assert kinds["DurableSpanExporter"].path == str(tmp_path / "flag.dftrace")
    assert kinds["DurableSpanExporter"].sample_rate == 1.0
    assert kinds["InMemoryExporter"].spans.maxlen == 64
    assert ttr.default_tracer.service == kind
    # The journal wrote its final frame at exit; the engine ran and was
    # stopped and uninstalled.
    assert seen["installed"] and tslo.current_engine() is None
    assert not (seen["engine"]._thread and seen["engine"]._thread.is_alive())
    assert not (seen["journal"]._thread and seen["journal"]._thread.is_alive())
    snaps, stats = tmj.replay_metric_journal(str(tmp_path / "flag.dfmj"))
    assert stats["frames"] >= 1 and snaps[-1]["service"] == kind
    assert not (tmp_path / "cfg.dfmj").exists()
    kinds["DurableSpanExporter"].close()


def test_scheduler_serve_stop_stops_journal_and_engine(tmp_path):
    cfg = tschema.SchedulerConfigFile()
    cfg.storage.dir = str(tmp_path / "records")
    cfg.network_topology.enable = False
    cfg.server.port = 0
    cfg.telemetry.journal_path = str(tmp_path / "serve.dfmj")
    cfg.telemetry.journal_interval_s = 0.05
    cfg.telemetry.slo_interval_s = 0.05
    cfg.telemetry.slos = SLOS
    args = argparse.Namespace(metric_journal=None, _prog="scheduler")
    journal, engine = tcommon.init_telemetry(args, cfg.telemetry, "scheduler")
    serving = scheduler_cli.serve(cfg, device="cpu")
    serving.journal, serving.slo_engine = journal, engine
    serving.stop()
    assert not journal._thread.is_alive() and not engine._thread.is_alive()
    assert tslo.current_engine() is None
    assert tmj.replay_metric_journal(cfg.telemetry.journal_path)[1]["frames"] >= 1


@pytest.mark.parametrize("kind", ["scheduler", "trainer"])
def test_binaries_install_df_faultinject_from_the_environment(tmp_path, kind):
    mode = (["--simulate", "4"] if kind == "scheduler"
            else ["--train-once", str(tmp_path / "empty")])
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["DRAGONFLY_SCHEDULER_STORAGE_DIR"] = str(tmp_path / "records")
    env["DF_FAULTINJECT"] = json.dumps(
        {"seed": 0, "faults": [{"site": "metrics.journal.write", "kind": "crash", "at": [0]}]})
    proc = subprocess.run(
        [sys.executable, "-m", f"dragonfly2_tpu_torch.cli.{kind}", *mode, "--device", "cpu",
         "--metric-journal", str(tmp_path / "j.dfmj")],
        env=env, capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    # The journal's one write (the final snapshot at exit) hits the crash.
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert tmj.replay_metric_journal(str(tmp_path / "j.dfmj"))[1]["frames"] == 0
