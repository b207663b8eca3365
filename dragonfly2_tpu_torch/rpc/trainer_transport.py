"""Trainer wire transport: the scheduler→trainer dataset stream.

Reference: pkg/rpc/trainer/client (client_v1.go:82-97 ``Train`` client
stream) + trainer/rpcserver — the announcer ships both record files in
128 MiB chunks over one stream (announcer.go:144-237).

HTTP binding onto TrainerService:
  POST /train/open    {ip, hostname, scheduler_id}            → {session}
  POST /train/shard?session=&kind=&name=&seq=   raw body = columnar bytes
  POST /train/close   {session}                               → {run}
  GET  /train/run?key=                                        → run status

``RemoteTrainerSession`` mirrors TrainSession's surface so the announcer
works unchanged against local or remote trainers; shards stream in
128 MiB chunks (appended server-side in sequence order).
"""

from __future__ import annotations

import json
import os
import threading
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import TYPE_CHECKING, Dict, Optional, Tuple

from ._server import ThreadedHTTPService
from .retry import retry_call

if TYPE_CHECKING:  # the service (and torch) only where a trainer serves
    from ..trainer.service import TrainerService, TrainSession

UPLOAD_CHUNK_BYTES = 128 << 20  # announcer.go:39-41


class TrainerHTTPServer:
    def __init__(self, service: TrainerService, host: str = "127.0.0.1", port: int = 0):
        if service.data_dir is None:
            raise ValueError("remote ingest requires TrainerService(data_dir=...)")
        self.service = service
        self._mu = threading.Lock()
        self._sessions: Dict[str, TrainSession] = {}
        self._closed: Dict[str, str] = {}  # session id -> run key
        self._counter = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _json(self, code: int, payload) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                parsed = urllib.parse.urlsplit(self.path)
                q = dict(urllib.parse.parse_qsl(parsed.query))
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                try:
                    if parsed.path == "/train/open":
                        req = json.loads(body or b"{}")
                        session = outer.service.open_train_stream(
                            ip=req.get("ip", ""),
                            hostname=req.get("hostname", ""),
                            scheduler_id=req.get("scheduler_id", ""),
                        )
                        with outer._mu:
                            outer._counter += 1
                            sid = f"sess-{outer._counter}"
                            outer._sessions[sid] = session
                        self._json(200, {"session": sid})
                    elif parsed.path == "/train/shard":
                        with outer._mu:
                            session = outer._sessions.get(q.get("session", ""))
                        if session is None:
                            self._json(404, {"error": "unknown session"})
                            return
                        outer.service.receive_shard_bytes(
                            session,
                            q.get("kind", "download"),
                            q.get("name", "shard"),
                            body,
                            seq=int(q.get("seq", 0)),
                        )
                        self._json(200, {})
                    elif parsed.path == "/train/close":
                        req = json.loads(body or b"{}")
                        sid = req.get("session", "")
                        with outer._mu:
                            # Idempotent: a client retrying a close whose
                            # response was lost (training can outlive the
                            # client timeout) gets the SAME run key back.
                            done_key = outer._closed.get(sid)
                            session = outer._sessions.get(sid)
                        if done_key is not None:
                            self._json(200, {"run": done_key})
                            return
                        if session is None:
                            self._json(404, {"error": "unknown session"})
                            return
                        key = session.close_and_train(
                            synchronous=bool(req.get("synchronous", True))
                        )
                        with outer._mu:
                            outer._closed[sid] = key
                            outer._sessions.pop(sid, None)
                        self._json(200, {"run": key})
                    else:
                        self._json(404, {"error": "not found"})
                except Exception as exc:  # noqa: BLE001 — wire boundary
                    self._json(500, {"error": str(exc)})

            def do_GET(self):
                parsed = urllib.parse.urlsplit(self.path)
                q = dict(urllib.parse.parse_qsl(parsed.query))
                if parsed.path == "/train/run":
                    run = outer.service.runs.get(q.get("key", ""))
                    if run is None:
                        self._json(404, {"error": "unknown run"})
                        return
                    self._json(
                        200,
                        {
                            "key": run.key,
                            "done": run.done.is_set(),
                            "error": run.error,
                            "download_rows": run.download_rows,
                            "topology_rows": run.topology_rows,
                            "models": run.models,
                            "metrics": {
                                k: m.to_dict() for k, m in run.metrics.items()
                            },
                            # The port's own: where and how long the round
                            # trained (a reference client reads neither).
                            "device": run.device,
                            "seconds": run.seconds,
                        },
                    )
                else:
                    self._json(404, {"error": "not found"})

        self._svc = ThreadedHTTPService(Handler, host, port, "trainer-http")
        self.address: Tuple[str, int] = self._svc.address

    @property
    def url(self) -> str:
        return self._svc.url

    def serve(self) -> None:
        self._svc.serve()

    def stop(self) -> None:
        self._svc.stop()


class RemoteTrainerSession:
    """TrainSession mirror over HTTP (the announcer's remote mode)."""

    def __init__(self, client: "RemoteTrainer", session_id: str):
        self._client = client
        self._session_id = session_id

    def _send_file(self, kind: str, path: str) -> None:
        name = os.path.basename(path)
        with open(path, "rb") as f:
            seq = 0
            while True:
                chunk = f.read(UPLOAD_CHUNK_BYTES)
                if not chunk and seq > 0:
                    break
                self._client._post_raw(
                    f"/train/shard?session={self._session_id}&kind={kind}"
                    f"&name={urllib.parse.quote(name)}&seq={seq}",
                    chunk,
                )
                seq += 1
                if len(chunk) < UPLOAD_CHUNK_BYTES:
                    break

    def send_download_shard(self, path: str) -> None:
        self._send_file("download", path)

    def send_network_topology_shard(self, path: str) -> None:
        self._send_file("networktopology", path)

    def close_and_train(self, *, synchronous: bool = True) -> str:
        resp = self._client._post_json(
            "/train/close", {"session": self._session_id, "synchronous": synchronous}
        )
        return resp["run"]


class RemoteTrainer:
    """Client mirroring TrainerService's announcer-facing surface."""

    def __init__(self, base_url: str, *, timeout: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.runs: "_RemoteRuns" = _RemoteRuns(self)

    def _post_raw(
        self, path: str, data: bytes, *, deadline_s: Optional[float] = None
    ) -> dict:
        def once() -> dict:
            from ..utils import faultinject

            faultinject.fire("trainer.rpc.post")
            req = urllib.request.Request(
                self.base_url + path, data=data, method="POST"
            )
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read())

        return retry_call(
            once, retry_on=(ConnectionError, TimeoutError), deadline_s=deadline_s
        )

    def _post_json(self, path: str, payload: dict) -> dict:
        return self._post_raw(path, json.dumps(payload).encode())

    def _get(self, path: str) -> dict:
        from ..utils import faultinject

        faultinject.fire("trainer.rpc.get")
        with urllib.request.urlopen(self.base_url + path, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def open_train_stream(
        self, *, ip: str, hostname: str, scheduler_id: str
    ) -> RemoteTrainerSession:
        resp = self._post_json(
            "/train/open",
            {"ip": ip, "hostname": hostname, "scheduler_id": scheduler_id},
        )
        return RemoteTrainerSession(self, resp["session"])


class _RemoteRuns:
    """Dict-ish view of remote runs (announcer reads trainer.runs[key])."""

    def __init__(self, client: RemoteTrainer):
        self._client = client

    def __getitem__(self, key: str):
        data = self._client._get(f"/train/run?key={urllib.parse.quote(key)}")
        from ..trainer.train import EvalMetrics

        class _DoneView:
            def __init__(self, flag: bool):
                self._flag = flag

            def is_set(self) -> bool:
                return self._flag

        class RunView:
            pass

        run = RunView()
        run.key = data["key"]
        run.error = data["error"]
        run.download_rows = data["download_rows"]
        run.topology_rows = data["topology_rows"]
        run.models = data["models"]
        # Same surface as the local TrainRun: metrics values are
        # EvalMetrics and done answers is_set().
        run.metrics = {k: EvalMetrics(**v) for k, v in data["metrics"].items()}
        run.done = _DoneView(bool(data["done"]))
        # Absent from a reference trainer's answer.
        run.device = data.get("device", "")
        run.seconds = data.get("seconds", 0.0)
        return run
