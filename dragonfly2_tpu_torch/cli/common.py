"""Shared CLI plumbing (reference: cmd/dependency/dependency.go:59-120).

Port of ``base_parser`` (with the tracing and telemetry flags
``--trace-file``, ``--otlp``, ``--trace-log`` and ``--metric-journal``),
``init_tracing``, ``init_flight_recorder``, ``init_telemetry``,
``init_logging`` (which installs a ``DF_FAULTINJECT`` scenario from the
environment) and ``init_debug`` of ``dragonfly2_tpu/cli/common.py``.
New here: ``stop_telemetry``, which both binaries call on shutdown, and
``SignalWait``, the serve modes' wait, and ``report_launches``, the
serve modes' last line.  ``init_diagnostics`` starts
the ``/metrics`` sidecar (``utils/diagnostics.DiagnosticsServer``) the
scheduler's and the daemon's ``run`` start at the reference's defaults;
the port also stops it on shutdown, where the reference leaves it to the
process's exit.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
from typing import Optional

from .. import __version__
from ..utils import dflog


def base_parser(prog: str, description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description=description)
    p.set_defaults(_prog=prog)  # OTLP resource service.name
    p.add_argument("--config", default=None, help="YAML config file path")
    p.add_argument("--verbose", action="store_true", help="debug logging")
    p.add_argument("--console", action="store_true", help="log to stdout")
    p.add_argument("--log-dir", default=None, help="rotating log file directory")
    p.add_argument(
        "--debug-port", type=int, default=None, metavar="PORT",
        help="loopback debug endpoint: /debug/stacks, /debug/stats, "
             "/debug/profile (cmd/dependency --pprof-port analog; 0 = "
             "ephemeral)",
    )
    p.add_argument(
        "--trace-file", default=None, metavar="PATH",
        help="append spans as JSON lines (the --jaeger export analog, "
             "cmd/dependency/dependency.go:263-297); cross-process trace "
             "ids from the traceparent wire header land here",
    )
    p.add_argument(
        "--otlp", default=None, metavar="TARGET",
        help="export spans as OTLP/JSON: an http(s) collector endpoint "
             "(Jaeger/otel-collector at :4318/v1/traces) or a file path "
             "appended one ExportTraceServiceRequest per line — the "
             "reference's --jaeger flag analog "
             "(cmd/dependency/dependency.go:263-297)",
    )
    p.add_argument(
        "--trace-log", default=None, metavar="PATH",
        help="flight recorder: append-only crash-safe trace log "
             "(length-prefixed, digest-checked OTLP/JSON frames; "
             "head-sampled by trace id per config tracing.sample_rate) — "
             "feed per-process logs to "
             "python -m dragonfly2_tpu_torch.bench.trace_assemble; "
             "overrides config tracing.log_path",
    )
    p.add_argument(
        "--metric-journal", default=None, metavar="PATH",
        help="fleet telemetry: append-only crash-safe metric journal "
             "(length-prefixed, digest-checked DFMJ1 frames of periodic "
             "counter/gauge/sketch snapshots + run identity) — feed "
             "per-process journals to "
             "python -m dragonfly2_tpu_torch.bench.fleet_assemble; overrides "
             "config telemetry.journal_path",
    )
    p.add_argument(
        "--version", action="version", version=f"%(prog)s {__version__}"
    )
    return p


def init_tracing(args) -> None:
    """Point the process-default tracer at the configured exporter
    (every binary, like the reference's otel wiring in cmd/dependency):
    --otlp for standard-collector export, --trace-file for raw JSONL."""
    if getattr(args, "otlp", None):
        from ..utils.tracing import OTLPJSONExporter, default_tracer

        default_tracer.exporter = OTLPJSONExporter(
            args.otlp, service=getattr(args, "_prog", None) or "dragonfly"
        )
        return
    if not getattr(args, "trace_file", None):
        return
    from ..utils.tracing import JSONLExporter, default_tracer

    default_tracer.exporter = JSONLExporter(args.trace_file)


def init_flight_recorder(args, tracing_cfg, service: Optional[str] = None):
    """Config-driven tracer wiring, called AFTER load_config in every
    binary (init_tracing handled the pre-config CLI flags): applies the
    tracing.enable toggle, sizes the /debug/spans recent ring, keeps any
    --otlp/--trace-file exporter, and attaches the durable flight
    recorder when --trace-log or tracing.log_path names one.  Returns
    the DurableSpanExporter (or None) so callers can flush on shutdown.
    """
    from ..utils import tracing as tr

    service = service or getattr(args, "_prog", None) or "dragonfly"
    tr.default_tracer.service = service
    if tracing_cfg is not None:
        tr.set_enabled(tracing_cfg.enable)
    path = getattr(args, "trace_log", None) or (
        tracing_cfg.log_path if tracing_cfg is not None else ""
    )
    ring_spans = tracing_cfg.ring_spans if tracing_cfg is not None else 4096
    rate = tracing_cfg.sample_rate if tracing_cfg is not None else 1.0
    exporters = [tr.InMemoryExporter(max_spans=ring_spans)]
    current = tr.default_tracer.exporter
    if not isinstance(current, (tr.InMemoryExporter, tr.CompositeExporter)):
        exporters.append(current)  # the --otlp/--trace-file choice rides along
    durable = None
    if path:
        durable = tr.DurableSpanExporter(path, service=service, sample_rate=rate)
        exporters.append(durable)
    tr.default_tracer.exporter = (
        exporters[0] if len(exporters) == 1 else tr.CompositeExporter(exporters)
    )
    return durable


def init_telemetry(args, telemetry_cfg, service: Optional[str] = None):
    """Config-driven metric journal + SLO engine, called AFTER
    load_config in every binary next to ``init_flight_recorder``
    (DESIGN.md §23): attaches the crash-safe metric journal when
    ``--metric-journal`` or ``telemetry.journal_path`` names one, and —
    when ``telemetry.slos`` declares objectives — starts the burn-rate
    engine and installs it for the ``/debug/slo`` endpoints.  Returns
    ``(journal, engine)`` (either may be None) so callers can flush and
    stop on shutdown."""
    service = service or getattr(args, "_prog", None) or "dragonfly"
    path = getattr(args, "metric_journal", None) or (
        telemetry_cfg.journal_path if telemetry_cfg is not None else ""
    )
    journal = None
    if path:
        from ..utils.metric_journal import MetricJournal

        journal = MetricJournal(
            path,
            service=service,
            interval_s=(
                telemetry_cfg.journal_interval_s
                if telemetry_cfg is not None else 10.0
            ),
        ).start()
    engine = None
    if telemetry_cfg is not None and telemetry_cfg.slos:
        from ..utils import slo as slo_mod

        engine = slo_mod.SLOEngine(telemetry_cfg.slos)
        engine.start(telemetry_cfg.slo_interval_s)
        slo_mod.install_engine(engine)
    return journal, engine


def stop_telemetry(journal=None, engine=None) -> None:
    """Stop what ``init_telemetry`` started: the SLO engine's thread (and
    its install), then the journal, which writes its final snapshot.
    The reference leaves both to exit hooks; a serve mode that stops
    inside a longer-lived process stops them here."""
    if engine is not None:
        from ..utils import slo as slo_mod

        engine.close()
        if slo_mod.current_engine() is engine:
            slo_mod.install_engine(None)
    if journal is not None:
        journal.close()


def init_diagnostics(cfg_metrics, service: str):
    """The uniform /metrics + /debug/spans + /debug/exemplars sidecar on
    the scheduler and daemon (the manager serves the same routes on its
    REST port).  Gated behind config ``metrics.enable``; port conflicts
    degrade to a warning — diagnostics must never keep a plane down.
    → the server (its ``stop()`` ends it) or None."""
    if cfg_metrics is None or not cfg_metrics.enable:
        return None
    try:
        from ..utils.diagnostics import DiagnosticsServer

        srv = DiagnosticsServer(port=cfg_metrics.port)
        srv.serve()
        print(
            f"{service}: diagnostics on {srv.url}/metrics "
            f"(+ /debug/spans, /debug/exemplars)", flush=True,
        )
        return srv
    except OSError as exc:
        import logging

        logging.getLogger(__name__).warning(
            "%s: diagnostics endpoint not started (%s)", service, exc
        )
        return None


def grpc_transport(what: str):
    """→ the ``rpc.grpc_transport`` module, imported only when a binary's
    configuration asks for gRPC (``what`` names that setting).  On a
    machine without ``grpc`` or ``protobuf`` raises ``ConfigError``
    naming the missing package, which the binaries turn into exit 2."""
    try:
        from ..rpc import grpc_transport as mod
    except ImportError as exc:
        from ..config import ConfigError

        raise ConfigError(
            f"{what} needs the gRPC transport, and its package "
            f"{exc.name or 'grpc'!r} is not installed ({exc})"
        ) from exc
    return mod


def init_debug(args):
    """Start the debug endpoint when --debug-port is given (every binary,
    like the reference's pprof wiring in cmd/dependency); → the server
    or None."""
    if getattr(args, "debug_port", None) is None:
        return None
    from ..utils.debug import DebugServer

    srv = DebugServer(port=args.debug_port)
    srv.serve()
    print(f"debug endpoint on {srv.url}/debug/stacks", flush=True)
    return srv


def init_logging(args, service: str) -> None:
    dflog.setup(
        level="debug" if args.verbose else "info",
        log_dir=args.log_dir,
        console=args.console or not args.log_dir,
        service=service,
    )
    # Chaos drills hand a fault scenario to service binaries via
    # DF_FAULTINJECT (utils/faultinject.py) — a child process then
    # drops/delays/SIGKILLs itself at deterministic call indices, with
    # no racy external kill timing.  No-op without the env var.
    from ..utils import faultinject

    faultinject.install_from_env()


class SignalWait:
    """SIGINT and SIGTERM caught from construction on: a serve mode builds
    one before it prints its ready line, so a supervisor may signal as soon
    as it reads the line (the reference waits for KeyboardInterrupt only; a
    supervisor's SIGTERM stops the port's binaries as cleanly).  ``wait()``
    blocks until one arrives, → its number; ``close()`` puts the previous
    handlers back.  Use from the main thread."""

    def __init__(self) -> None:
        self._got: list = []
        self._done = threading.Event()
        self._previous = {
            s: signal.signal(s, self._on_signal) for s in (signal.SIGINT, signal.SIGTERM)
        }

    def _on_signal(self, signum, frame) -> None:
        self._got.append(signum)
        self._done.set()

    def wait(self) -> int:
        while not self._done.wait(1.0):
            pass
        return self._got[0]

    def close(self) -> None:
        for s, handler in self._previous.items():
            signal.signal(s, handler)
        self._previous = {}


def report_launches(binary: str) -> None:
    """Print ``BINARY: kernel launches {...}``: the launches of every
    kernel wrapper in this process since it started (``ops.launch_counts``),
    so that a supervisor reads what the binary ran on its device.  A
    process that never imported the wrappers launched none and prints
    ``{}``.  Each serve mode prints it once it has stopped."""
    ops = sys.modules.get(__name__.rsplit(".", 2)[0] + ".ops")
    counts = ops.launch_counts() if ops is not None else {}
    print(f"{binary}: kernel launches {json.dumps(counts, sort_keys=True)}", flush=True)
