"""Daemon local control API + the dfget→daemon contract.

Reference: client/daemon/rpcserver serves a Download RPC on a local unix
socket and dfget spawns the daemon when absent
(cmd/dfget/cmd/root.go:234-260 checkAndSpawnDaemon).  This package's shape:
a loopback HTTP control endpoint —

  GET  /healthy                    liveness {ok, pid}
  POST /download  {url, output?, piece_size?} → download result

— plus a state file (daemon.json under the daemon's storage dir, or
$DF_DAEMON_STATE) advertising the control URL so dfget can find a
running daemon or know to spawn one.

Port of ``dragonfly2_tpu/rpc/daemon_control.py``: the same routes, JSON
bodies and state file.  ``ensure_daemon`` spawns the port's own
``dragonfly2_tpu_torch.cli.dfdaemon``.  ``serve_vsock`` binds the
guest-safe surface on an AF_VSOCK listener (``rpc/vsock.py``), as the
reference's does.  The state file's default path is the reference's,
so a deployment running both packages sets ``$DF_DAEMON_STATE`` apart.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Optional, Tuple

from ._server import ThreadedHTTPService

STATE_ENV = "DF_DAEMON_STATE"


def state_path() -> str:
    """ONE discovery path shared by writer (dfdaemon) and readers (dfget,
    ensure_daemon): $DF_DAEMON_STATE, else a user-scoped default.  Both
    sides MUST use this function — a storage-dir-relative location would
    desynchronize discovery for custom configs."""
    return os.environ.get(
        STATE_ENV, os.path.expanduser("~/.dragonfly2-tpu/daemon.json")
    )


def write_state(url: str, path: Optional[str] = None) -> str:
    path = path or state_path()
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    # Atomic publish: a concurrent reader must never see a half-written
    # file (JSONDecodeError → spurious re-spawn).
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump({"url": url, "pid": os.getpid()}, f)
    os.replace(tmp, path)
    return path


def read_state(path: Optional[str] = None) -> Optional[dict]:
    try:
        with open(path or state_path()) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


class DaemonControlServer:
    """Control surface over the daemon composition: loopback by default
    (/download writes local files); configs may bind a trusted pod/compose
    network instead (DaemonConfig.control_host) — the caller owns that
    trust boundary."""

    def __init__(
        self,
        conductor,
        *,
        piece_size: int = 4 << 20,
        host: str = "127.0.0.1",
        port: int = 0,
        seeder=None,
        public: bool = False,
    ) -> None:
        """``seeder`` (daemon/seeder.Seeder) enables POST /obtain_seeds —
        the scheduler-triggered prioritized seed download with a chunked
        JSON-line event stream (seeder.go:41-151 ObtainSeeds analog).

        ``public=True`` exposes ONLY /healthy and /obtain_seeds: the full
        control surface (/download writes arbitrary local files) is a
        same-machine contract unless the deployment's own trust boundary
        (pod/compose network, DaemonConfig.control_host) widens it —
        seed daemons run one loopback control server AND one public
        seed-endpoint server.
        """
        outer_piece_size = piece_size

        class Handler(BaseHTTPRequestHandler):
            # Chunked transfer (the /obtain_seeds event stream) requires 1.1;
            # plain responses still carry explicit Content-Length.
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _json(self, code: int, payload) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthy":
                    self._json(200, {"ok": True, "pid": os.getpid()})
                else:
                    self._json(404, {"error": "not found"})

            def _obtain_seeds(self):
                """Chunked JSON-line event stream (ObtainSeeds analog)."""
                if seeder is None:
                    self._json(404, {"error": "not a seed peer"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                from ..utils.types import Priority

                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                    url = req["url"]
                    priority = Priority(int(req.get("priority", 0)))
                except (KeyError, ValueError, TypeError) as exc:
                    # Network-reachable input: malformed bodies (arrays,
                    # priority outside 0..6) must get a clean 400, not a
                    # dropped connection.
                    self._json(400, {"error": str(exc)})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                closed = [False]

                def emit(event: dict) -> None:
                    if closed[0]:
                        return
                    line = (json.dumps(event) + "\n").encode()
                    try:
                        self.wfile.write(f"{len(line):x}\r\n".encode())
                        self.wfile.write(line + b"\r\n")
                        self.wfile.flush()
                    except OSError:
                        # Scheduler hung up — the seed download continues
                        # (children still benefit), only the stream stops.
                        closed[0] = True

                try:
                    seeder.obtain(
                        url,
                        piece_size=int(req.get("piece_size") or outer_piece_size),
                        priority=priority,
                        content_length=req.get("content_length"),
                        task_id=req.get("task_id") or None,
                        emit=emit,
                    )
                finally:
                    if not closed[0]:
                        try:
                            self.wfile.write(b"0\r\n\r\n")
                            self.wfile.flush()
                        except OSError:
                            pass

            def do_POST(self):
                if self.path == "/obtain_seeds":
                    self._obtain_seeds()
                    return
                if public or self.path != "/download":
                    self._json(404, {"error": "not found"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    import time as _time

                    req = json.loads(self.rfile.read(length) or b"{}")
                    url = req["url"]
                    piece_size = int(req.get("piece_size") or outer_piece_size)
                    content_length = conductor.probe_content_length(url)
                    output = req.get("output")
                    t0 = _time.monotonic()
                    if output:
                        # Same-machine contract (dfget and the daemon share
                        # the host, like the reference's unix socket).
                        # STREAM the output (StartFileTask semantics):
                        # bytes land in the file as pieces commit instead
                        # of buffering the whole task first — and a
                        # partial file never masquerades as complete
                        # (tmp + atomic rename on success).
                        handle = conductor.open_stream(
                            url, piece_size=piece_size,
                            content_length=content_length,
                        )
                        # Per-REQUEST tmp name: handler threads share a
                        # pid, and two concurrent downloads to one output
                        # path must not interleave into the same file.
                        tmp_out = (
                            f"{output}.{os.getpid()}."
                            f"{threading.get_ident()}.part"
                        )
                        nbytes = 0
                        try:
                            with open(tmp_out, "wb") as f:
                                for chunk in handle.chunks():
                                    f.write(chunk)
                                    nbytes += len(chunk)
                            os.replace(tmp_out, output)
                        except BaseException:
                            try:
                                os.remove(tmp_out)
                            except OSError:
                                pass
                            raise
                        # chunks() drains at the LAST piece commit; the
                        # run's result normally lands moments later.  The
                        # wait is SHORT: the file is already complete on
                        # disk, so a stalled finish phase (hung report
                        # RPC) must not hold the client's response — the
                        # telemetry fields just flag themselves pending.
                        final = handle.wait_result(timeout_s=2.0)
                        out = {
                            "ok": True,  # content served: file complete
                            "task_id": handle.task_id,
                            "pieces": handle.n_pieces,
                            "bytes": nbytes,
                            "back_to_source": bool(
                                final.back_to_source if final else False
                            ),
                            "result_pending": final is None,
                            "cost_s": _time.monotonic() - t0,
                            "output": output,
                        }
                        self._json(200, out)
                        # AFTER the response write: a client that hung up
                        # mid-stream raises out of _json and must count
                        # once (as failure), not as success+failure.
                        from .metrics import DAEMON_CONTROL_DOWNLOADS

                        DAEMON_CONTROL_DOWNLOADS.inc(result="success")
                        return
                    result = conductor.download(
                        url, piece_size=piece_size,
                        content_length=content_length,
                    )
                    out = {
                        "ok": result.ok,
                        "task_id": result.task_id,
                        "pieces": result.pieces,
                        "bytes": result.bytes,
                        "back_to_source": result.back_to_source,
                        "cost_s": result.cost_s,
                    }
                    from .metrics import DAEMON_CONTROL_DOWNLOADS

                    DAEMON_CONTROL_DOWNLOADS.inc(
                        result="success" if result.ok else "failure"
                    )
                    self._json(200 if result.ok else 502, out)
                except (KeyError, ValueError) as exc:
                    self._json(400, {"error": str(exc)})
                except Exception as exc:  # noqa: BLE001 — wire boundary:
                    # any failure (scheduler RpcError, storage, ...) must
                    # reach the client as JSON, not a closed socket.
                    from .metrics import DAEMON_CONTROL_DOWNLOADS

                    DAEMON_CONTROL_DOWNLOADS.inc(result="failure")
                    self._json(500, {"ok": False, "error": str(exc)})

        self._svc = ThreadedHTTPService(Handler, host, port, "daemon-control")
        self.address: Tuple[str, int] = self._svc.address
        # VM-guest surface (pkg/rpc/vsock.go): the SAME handler can also
        # bind an AF_VSOCK listener so guests without a network stack
        # drive the daemon over vsock://2:<port>.
        self._handler_cls = Handler
        self._vsock = None

    def serve_vsock(self, port: int, *, cid=None):
        """Bind the GUEST-SAFE surface on an AF_VSOCK listener; returns
        the bound port (vsock.go listener analog).

        /download is NOT exposed: it writes HOST-side files at caller-
        chosen paths (a same-machine contract), and any guest CID can
        dial the listener.  Guests get /healthy and /obtain_seeds — the
        piece/seed plane, which is what the reference serves them."""
        from .vsock import VMADDR_CID_ANY, VsockService

        base = self._handler_cls

        class VsockHandler(base):
            def do_POST(self):
                if self.path == "/download":
                    self._json(404, {"error": "not on the vsock surface"})
                    return
                base.do_POST(self)

        self._vsock = VsockService(
            VsockHandler, port,
            cid=VMADDR_CID_ANY if cid is None else cid,
        )
        self._vsock.serve()
        return self._vsock.port

    @property
    def url(self) -> str:
        return self._svc.url

    def serve(self) -> None:
        self._svc.serve()

    def stop(self) -> None:
        self._svc.stop()
        if self._vsock is not None:
            self._vsock.stop()


# -- dfget side (checkAndSpawnDaemon) ----------------------------------------


def daemon_healthy(url: str, timeout: float = 2.0) -> bool:
    from ..utils import faultinject

    try:
        faultinject.fire("daemon.control.healthy")
        with urllib.request.urlopen(url + "/healthy", timeout=timeout) as r:
            return bool(json.loads(r.read()).get("ok"))
    except Exception as exc:  # noqa: BLE001 — any failure means "not healthy"
        logging.getLogger(__name__).debug("health probe %s: %s", url, exc)
        return False


def download_via_daemon(
    url: str, daemon_url: str, *, output: Optional[str] = None,
    piece_size: Optional[int] = None, timeout: float = 600.0,
) -> dict:
    payload = {"url": url}
    if output:
        payload["output"] = os.path.abspath(output)
    if piece_size:
        payload["piece_size"] = piece_size
    req = urllib.request.Request(
        daemon_url + "/download", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    from ..utils import faultinject

    faultinject.fire("daemon.control.download")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as exc:
        # Error statuses (400/500/502) still carry the JSON result — the
        # caller's ok-check handles them, not a raw traceback.
        try:
            return json.loads(exc.read())
        except (ValueError, OSError):
            return {"ok": False, "error": f"HTTP {exc.code}"}


def find_healthy_daemon() -> Optional[str]:
    """→ control URL of a running healthy daemon, else None — the ONE
    discovery check (dfget and ensure_daemon share it)."""
    state = read_state()
    if state and daemon_healthy(state["url"]):
        return state["url"]
    return None


def ensure_daemon(
    scheduler_url: str,
    *,
    spawn_timeout: float = 20.0,
    extra_args: Optional[list] = None,
) -> str:
    """→ control URL of a healthy daemon, spawning one detached if
    needed (root.go:251 checkAndSpawnDaemon).

    Spawning is serialized through a lock file (the reference does the
    same): two concurrent dfgets must not each spawn a daemon, orphaning
    the one that loses the state-file race."""
    import fcntl
    import subprocess
    import sys
    import time

    url = find_healthy_daemon()
    if url:
        return url
    lock_path = state_path() + ".lock"
    os.makedirs(os.path.dirname(os.path.abspath(lock_path)) or ".", exist_ok=True)
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        # The winner of the lock may have spawned while we waited.
        url = find_healthy_daemon()
        if url:
            return url
        log_path = state_path() + ".spawn.log"
        with open(log_path, "ab") as log:
            subprocess.Popen(
                [sys.executable, "-m", "dragonfly2_tpu_torch.cli.dfdaemon",
                 "--scheduler", scheduler_url, *(extra_args or [])],
                stdout=log, stderr=log,
                start_new_session=True,  # outlives dfget, like the reference
            )
        deadline = time.time() + spawn_timeout
        while time.time() < deadline:
            url = find_healthy_daemon()
            if url:
                return url
            time.sleep(0.2)
    raise TimeoutError(
        f"daemon did not become healthy within {spawn_timeout}s "
        f"(spawn log: {log_path})"
    )
