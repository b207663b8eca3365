"""Shared CLI plumbing (reference: cmd/dependency/dependency.go:59-120).

Port of ``base_parser``, ``init_logging`` and ``init_debug`` of
``dragonfly2_tpu/cli/common.py``, and ``wait_for_signal``, the serve
modes' wait.  The reference's tracing and telemetry
flags (``--trace-file``, ``--otlp``, ``--trace-log``,
``--metric-journal``) are not offered, so argparse refuses them: the span
exporters, the flight recorder and the metric journal wait for the
port's telemetry slice (ROADMAP queue 1 item 10), and so does the
``DF_FAULTINJECT`` install that the reference's ``init_logging`` makes.
"""

from __future__ import annotations

import argparse
import signal
import threading

from .. import __version__
from ..utils import dflog


def base_parser(prog: str, description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description=description)
    p.set_defaults(_prog=prog)
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
        "--version", action="version", version=f"%(prog)s {__version__}"
    )
    return p


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


def wait_for_signal() -> int:
    """Block until SIGINT or SIGTERM; → the signal's number.  The serve
    modes' wait (the reference waits for KeyboardInterrupt only; a
    supervisor's SIGTERM stops the port's binaries as cleanly).  Call
    from the main thread."""
    got = []
    done = threading.Event()

    def on_signal(signum, frame):
        got.append(signum)
        done.set()

    previous = {
        s: signal.signal(s, on_signal) for s in (signal.SIGINT, signal.SIGTERM)
    }
    try:
        while not done.wait(1.0):
            pass
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)
    return got[0]
