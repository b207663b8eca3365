"""Cross-process job fan-out: the machinery-over-Redis wire, HTTP shape.

Reference: the manager fans preheat/sync_peers group jobs to scheduler
clusters through machinery queues on a shared Redis broker
(manager/job/preheat.go:126-167, internal/job/job.go:48-147); each
scheduler's worker polls ITS queue and reports results.

Here the MANAGER process hosts the broker (jobs/queue.JobQueue) and
exposes it on its REST port (manager/rest.py):

    POST /api/v1/jobs           {type, args, queues:[...]} → {group_id,...}
    GET  /api/v1/jobs/<gid>     group + per-job states
    POST /api/v1/jobs:poll      {queue, timeout_s?} → job | 204
    POST /api/v1/jobs/<id>:result  {state, result?, error?}

``RemoteJobWorker`` is the scheduler-side consumer: long-polls its
queue over the wire, runs registered handlers (the same handler
functions the in-process Worker uses — make_preheat_handler,
make_sync_peers_handler), and reports results back.  A manager outage
degrades to retrying polls; jobs enqueued meanwhile are delivered when
it returns (broker state lives with the manager).

Port of ``dragonfly2_tpu/jobs/remote.py``, verbatim but for the imports.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger(__name__)


class RemoteJobClient:
    """Producer/observer side (manager CLI, tests, consoles).

    ``manager_url`` may be a single URL, a comma-separated replica list,
    or a shared ``ManagerEndpoints`` — calls fail over to the next
    manager replica on connection errors and on a standby's 503
    (rpc/resolver.ManagerEndpoints), so keepalives, job polls, and
    preheat submissions survive a leader bounce mid-flight."""

    def __init__(self, manager_url, *, token: Optional[str] = None,
                 timeout: float = 10.0) -> None:
        from ..rpc.resolver import ManagerEndpoints

        self.endpoints = ManagerEndpoints.of(manager_url, client="jobs")
        self.token = token
        self.timeout = timeout

    @property
    def base(self) -> str:
        return self.endpoints.current()

    def call(self, method: str, path: str, body: Optional[dict] = None) -> dict:
        """Bearer-authed JSON request against the manager REST surface —
        the ONE urllib wrapper shared by the job wire and the cluster
        registration wire (rpc/cluster_client.py)."""
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"

        def once(base: str) -> dict:
            from ..utils import faultinject

            faultinject.fire("jobs.remote.call")
            req = urllib.request.Request(
                base + path, data=data, headers=headers, method=method
            )
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                if resp.status == 204:
                    return {}
                return json.loads(resp.read() or b"{}")

        return self.endpoints.call(once)

    def create_group(self, type: str, args: Dict[str, Any], queues) -> dict:
        return self.call(
            "POST", "/api/v1/jobs",
            {"type": type, "args": args, "queues": list(queues)},
        )

    def group_state(self, group_id: str) -> dict:
        return self.call("GET", f"/api/v1/jobs/{group_id}")


class RemoteJobWorker:
    """Scheduler-side consumer: poll → run handler → report."""

    def __init__(
        self,
        manager_url: str,
        queue_name: str,
        *,
        token: Optional[str] = None,
        poll_timeout_s: float = 5.0,
        error_backoff_s: float = 2.0,
    ) -> None:
        self.client = RemoteJobClient(manager_url, token=token,
                                      timeout=poll_timeout_s + 10.0)
        self.queue_name = queue_name
        self.poll_timeout_s = poll_timeout_s
        self.error_backoff_s = error_backoff_s
        self._handlers: Dict[str, Callable[[Dict[str, Any]], Any]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.jobs_done = 0
        self.jobs_failed = 0

    def register(self, job_type: str, handler: Callable[[Dict[str, Any]], Any]) -> None:
        self._handlers[job_type] = handler

    # -- one cycle (tests call this directly; serve() loops it) -------------

    def poll_once(self) -> bool:
        """Poll, run, report.  True iff a job was processed."""
        try:
            job = self.client.call(
                "POST", "/api/v1/jobs:poll",
                {"queue": self.queue_name, "timeout_s": self.poll_timeout_s},
            )
        except urllib.error.HTTPError as exc:
            if exc.code in (401, 403):
                # Not transient: a bad/absent token leaves fan-out jobs
                # PENDING forever with no other symptom — make it loud.
                logger.warning(
                    "job poll on queue %s unauthorized (HTTP %d): check "
                    "manager token/role", self.queue_name, exc.code,
                )
            else:
                logger.debug("job poll failed: %s", exc)
            raise ConnectionError(str(exc)) from exc
        except (urllib.error.URLError, OSError, ValueError) as exc:
            logger.debug("job poll failed: %s", exc)
            raise ConnectionError(str(exc)) from exc
        if not job or "id" not in job:
            return False
        handler = self._handlers.get(job["type"])
        result: Any = None
        error = ""
        if handler is None:
            error = f"no handler for job type {job['type']!r}"
        else:
            try:
                result = handler(job.get("args") or {})
            except Exception as exc:  # noqa: BLE001 — reported on the job record
                error = f"{type(exc).__name__}: {exc}"
        state = "FAILURE" if error else "SUCCESS"
        reported = False
        for attempt in range(3):
            try:
                self.client.call(
                    "POST", f"/api/v1/jobs/{job['id']}:result",
                    {"state": state, "result": result, "error": error},
                )
                reported = True
                break
            except (urllib.error.URLError, OSError) as exc:
                logger.warning(
                    "job %s result report attempt %d failed: %s",
                    job["id"], attempt + 1, exc,
                )
                self._stop.wait(self.error_backoff_s)
        if error or not reported:
            # An unreported job is NOT done: the broker's visibility
            # window will requeue it for another worker pass.
            self.jobs_failed += 1
        else:
            self.jobs_done += 1
        return True

    def serve(self) -> None:
        def loop() -> None:
            while not self._stop.is_set():
                try:
                    self.poll_once()
                except ConnectionError:
                    # Manager unreachable: keep knocking — the broker
                    # holds our queue and delivers on return.
                    self._stop.wait(self.error_backoff_s)

        self._thread = threading.Thread(
            target=loop, name=f"job-worker-{self.queue_name}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_timeout_s + 2)
