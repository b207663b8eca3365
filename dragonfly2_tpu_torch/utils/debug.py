"""Debug endpoint (reference: cmd/dependency --pprof-port starting
net/http/pprof on every binary).

Python analog over loopback HTTP:

  GET /debug/stacks   — current stack of every thread (goroutine dump)
  GET /debug/stats    — gc counters, thread/fd counts, rss
  GET /debug/profile?seconds=N — cProfile the process for N seconds,
                                 returns pstats text sorted by cumtime
"""

from __future__ import annotations

import gc
import io
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler
from typing import Tuple
from urllib.parse import parse_qsl, urlsplit

from ..rpc._server import ThreadedHTTPService


def thread_stacks() -> str:
    out = io.StringIO()
    frames = sys._current_frames()
    for thread in threading.enumerate():
        frame = frames.get(thread.ident)
        out.write(
            f"\n--- {thread.name} (daemon={thread.daemon}, "
            f"ident={thread.ident}) ---\n"
        )
        if frame is not None:
            traceback.print_stack(frame, file=out)
    return out.getvalue()


def process_stats() -> dict:
    stats = {
        "threads": threading.active_count(),
        "gc_counts": gc.get_count(),
        "gc_collections": [g["collections"] for g in gc.get_stats()],
    }
    try:
        import resource

        stats["max_rss_kb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    except ImportError:
        pass
    try:
        import os

        stats["open_fds"] = len(os.listdir("/proc/self/fd"))
    except OSError:
        pass
    return stats


def profile_seconds(seconds: float, hz: float = 100.0) -> str:
    """Sampling profiler across ALL threads (pprof's CPU profile shape):
    sample sys._current_frames() at ``hz`` for ``seconds``, aggregate
    leaf frames and full stacks by count.  cProfile would only see the
    calling thread (i.e. this handler's own sleep) — useless for the
    worker threads an operator actually wants to see."""
    import time
    from collections import Counter

    seconds = min(max(seconds, 0.1), 60.0)
    interval = 1.0 / max(hz, 1.0)
    own = threading.get_ident()
    leaves: Counter = Counter()
    stacks: Counter = Counter()
    samples = 0
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        for ident, frame in sys._current_frames().items():
            if ident == own:
                continue
            samples += 1
            leaf = f"{frame.f_code.co_filename.rsplit('/', 1)[-1]}:" \
                   f"{frame.f_lineno} {frame.f_code.co_name}"
            leaves[leaf] += 1
            stack = []
            f = frame
            while f is not None and len(stack) < 30:
                stack.append(f.f_code.co_name)
                f = f.f_back
            stacks[" <- ".join(stack)] += 1
        time.sleep(interval)
    out = io.StringIO()
    out.write(f"sampled {samples} frames over {seconds:.1f}s at {hz:.0f} Hz\n")
    out.write("\n== hottest leaf frames (cumulative samples) ==\n")
    for leaf, n in leaves.most_common(25):
        out.write(f"{n:8d}  {leaf}\n")
    out.write("\n== hottest stacks ==\n")
    for stack, n in stacks.most_common(10):
        out.write(f"{n:8d}  {stack}\n")
    return out.getvalue()


class DebugServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _text(self, code: int, body: str) -> None:
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", "text/plain; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                parsed = urlsplit(self.path)
                if parsed.path == "/debug/stacks":
                    self._text(200, thread_stacks())
                elif parsed.path == "/debug/stats":
                    import json

                    self._text(200, json.dumps(process_stats(), indent=2))
                elif parsed.path == "/debug/profile":
                    q = dict(parse_qsl(parsed.query))
                    self._text(200, profile_seconds(float(q.get("seconds", 2))))
                else:
                    self._text(404, "not found\n")

        self._svc = ThreadedHTTPService(Handler, host, port, "debug")
        self.address: Tuple[int, int] = self._svc.address

    @property
    def url(self) -> str:
        return self._svc.url

    def serve(self) -> None:
        self._svc.serve()

    def stop(self) -> None:
        self._svc.stop()
