"""Queue bus + workers + group-job state aggregation.

Semantics from internal/job: jobs land on named queues (GLOBAL, per
scheduler, per host — queue.go); workers consume concurrently; a group
job's state is SUCCESS only when every member succeeded, FAILURE as soon
as any member failed (job.go:111-147 GetGroupJobState).

Port of ``dragonfly2_tpu/jobs/queue.py``, verbatim but for the imports.
"""

from __future__ import annotations

import enum
import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional

if TYPE_CHECKING:  # state seam type (no runtime import needed)
    from ..manager.state import StateBackend

GLOBAL_QUEUE = "global"


class JobState(str, enum.Enum):
    PENDING = "PENDING"
    STARTED = "STARTED"
    SUCCESS = "SUCCESS"
    FAILURE = "FAILURE"


@dataclass
class Job:
    id: str
    type: str
    queue: str
    args: Dict[str, Any] = field(default_factory=dict)
    group_id: Optional[str] = None
    state: JobState = JobState.PENDING
    result: Any = None
    error: str = ""
    created_at: float = field(default_factory=time.time)
    # Workers skip (FAILURE "expired") jobs past this wall-clock time —
    # a late-attaching consumer must not replay a backlog of stale
    # interval jobs whose results nobody reads.  0 = never expires.
    expires_at: float = 0.0
    # Set when a wire worker pops the job (poll): STARTED jobs older than
    # the visibility window get requeued (at-least-once — the worker may
    # have died before reporting).
    started_at: float = 0.0


@dataclass
class GroupJob:
    id: str
    job_ids: List[str] = field(default_factory=list)

    def state(self, jobs: Dict[str, Job]) -> JobState:
        states = [jobs[j].state for j in self.job_ids if j in jobs]
        if any(s is JobState.FAILURE for s in states):
            return JobState.FAILURE
        if all(s is JobState.SUCCESS for s in states) and states:
            return JobState.SUCCESS
        if any(s is JobState.STARTED for s in states):
            return JobState.STARTED
        return JobState.PENDING


class JobQueue:
    """The broker: named queues + job/group registry.

    ``max_backlog`` bounds each named queue: once full, the OLDEST
    queued job is evicted (FAILURE "evicted") — a queue whose consumer
    never attaches must not grow without bound."""

    def __init__(
        self, max_backlog: int = 10_000, *,
        backend: "Optional[StateBackend]" = None,
    ) -> None:
        self._mu = threading.Lock()
        self._queues: Dict[str, "queue.Queue[Job]"] = {}
        self.jobs: Dict[str, Job] = {}
        self.groups: Dict[str, GroupJob] = {}
        self.max_backlog = max_backlog
        # Durable broker (VERDICT r4 #5): with a manager state backend
        # attached, jobs/groups write through and a restarted manager
        # re-enqueues its backlog — a preheat in flight when the manager
        # dies completes after restart instead of vanishing (reference:
        # machinery's Redis-backed queues).  Persistence covers the WIRE
        # worker paths (enqueue/poll/set_result/prune); in-process
        # Workers mutate Job objects directly and are used with
        # ephemeral queues (scheduler-side), not the manager broker.
        self._table = backend.table("jobs") if backend is not None else None
        self._gtable = (
            backend.table("job_groups") if backend is not None else None
        )
        if self._table is not None:
            self._reload()

    def _persist_job(self, j: Job) -> None:
        if self._table is None:
            return
        doc = {
            "id": j.id, "type": j.type, "queue": j.queue, "args": j.args,
            "group_id": j.group_id, "state": j.state.value,
            "result": j.result, "error": j.error,
            "created_at": j.created_at, "expires_at": j.expires_at,
            "started_at": j.started_at,
        }
        try:
            self._table.put(j.id, doc)
        except (TypeError, ValueError):
            # Non-JSON result: persist state/error with result=None
            # rather than dropping the write — leaving the durable row
            # STARTED would GUARANTEE redelivery (and re-execution) of a
            # completed job after a manager restart, not just make it
            # possible on a crash (at-least-once means crash-only
            # redelivery, not redelivery by construction).
            import logging

            logging.getLogger(__name__).warning(
                "job %s: result not JSON-serializable; persisted with "
                "result=None", j.id,
            )
            doc["result"] = None
            try:
                self._table.put(j.id, doc)
            except (TypeError, ValueError):
                pass  # args themselves unserializable — keep last state

    def _persist_group(self, g: GroupJob) -> None:
        if self._gtable is not None:
            self._gtable.put(g.id, {"id": g.id, "job_ids": list(g.job_ids)})

    def _reload(self) -> None:
        """Restart recovery: reload every row; PENDING jobs re-enqueue in
        creation order; STARTED jobs keep their started_at and re-deliver
        through the stale-visibility requeue (at-least-once, same as a
        worker that died mid-job)."""
        for d in self._table.load_all().values():
            j = Job(
                id=d["id"], type=d["type"], queue=d["queue"],
                args=d.get("args") or {}, group_id=d.get("group_id"),
                state=JobState(d["state"]), result=d.get("result"),
                error=d.get("error", ""), created_at=d["created_at"],
                expires_at=d.get("expires_at", 0.0),
                started_at=d.get("started_at", 0.0),
            )
            self.jobs[j.id] = j
        for d in self._gtable.load_all().values():
            # A crash can strand half the pair: drop ids whose job row
            # never committed (group row won the race pre-fix era), and
            # re-adopt jobs whose row carries a group_id the group row
            # missed (job commits first, DF014 write order).
            ids = [i for i in d["job_ids"] if i in self.jobs]
            self.groups[d["id"]] = GroupJob(d["id"], ids)
        for j in sorted(self.jobs.values(), key=lambda x: x.created_at):
            if j.group_id is not None:
                # Boot is single-threaded, but the repaired group row
                # writes through the same locked path as live traffic.
                with self._mu:
                    group = self.groups.setdefault(
                        j.group_id, GroupJob(j.group_id)
                    )
                    if j.id not in group.job_ids:
                        group.job_ids.append(j.id)
                        self._persist_group(group)
            if j.state is JobState.PENDING:
                self._q(j.queue).put(j)

    def _q(self, name: str) -> "queue.Queue[Job]":
        with self._mu:
            if name not in self._queues:
                self._queues[name] = queue.Queue()
            return self._queues[name]

    def enqueue(
        self,
        type: str,
        args: Dict[str, Any],
        *,
        queue_name: str = GLOBAL_QUEUE,
        group_id: Optional[str] = None,
        expires_at: float = 0.0,
    ) -> Job:
        job = Job(
            id=uuid.uuid4().hex, type=type, queue=queue_name, args=args,
            group_id=group_id, expires_at=expires_at,
        )
        with self._mu:
            self.jobs[job.id] = job
            # Persist under _mu, BEFORE the queue put: a worker can poll
            # the job the instant it lands, and an unlocked write here
            # could commit a torn STARTED/started_at=0 row that the
            # stale-requeue can never redeliver after a crash.  The job
            # row also commits BEFORE the group row that references its
            # id (DF014 write order): a crash between the two leaves a
            # complete job row the group reconciler re-adopts on reload,
            # never a group pointing at a job that doesn't exist.
            self._persist_job(job)
            if group_id is not None:
                group = self.groups.setdefault(group_id, GroupJob(group_id))
                group.job_ids.append(job.id)
                self._persist_group(group)
        q = self._q(queue_name)
        while q.qsize() >= self.max_backlog:
            try:
                evicted = q.get_nowait()
            except queue.Empty:
                break
            with self._mu:
                if evicted.state is JobState.PENDING:
                    evicted.state = JobState.FAILURE
                    evicted.error = "evicted: queue backlog full"
                    self._persist_job(evicted)
        q.put(job)
        return job

    def create_group_job(
        self, type: str, per_queue_args: Dict[str, Dict[str, Any]]
    ) -> GroupJob:
        """Fan one logical job out to many queues (machinery group jobs)."""
        gid = uuid.uuid4().hex
        with self._mu:
            self.groups[gid] = GroupJob(gid)
        for queue_name, args in per_queue_args.items():
            self.enqueue(type, args, queue_name=queue_name, group_id=gid)
        return self.groups[gid]

    def group_state(self, group_id: str) -> JobState:
        with self._mu:
            group = self.groups.get(group_id)
            if group is None:
                raise KeyError(group_id)
            return group.state(self.jobs)

    def get(self, queue_name: str, timeout: Optional[float] = None) -> Optional[Job]:
        try:
            return self._q(queue_name).get(timeout=timeout)
        except queue.Empty:
            return None

    def poll(
        self,
        queue_name: str,
        timeout: Optional[float] = None,
        *,
        requeue_started_after_s: float = 120.0,
    ) -> Optional[Job]:
        """Wire-safe pop for remote workers: skips jobs no longer PENDING
        (pruned/evicted), fails expired ones instead of delivering them
        (the in-process Worker's expires_at contract), marks the returned
        job STARTED, and first REQUEUES jobs a dead worker popped but
        never reported (at-least-once)."""
        self._requeue_stale_started(queue_name, requeue_started_after_s)
        deadline = None if timeout is None else time.time() + timeout
        while True:
            remaining = None if deadline is None else max(deadline - time.time(), 0)
            job = self.get(queue_name, timeout=remaining)
            if job is None:
                return None
            now = time.time()
            with self._mu:
                if job.state is not JobState.PENDING:
                    continue  # pruned/evicted while queued
                if job.expires_at and now > job.expires_at:
                    job.state = JobState.FAILURE
                    job.error = "expired before execution"
                    self._persist_job(job)
                    continue
                job.state = JobState.STARTED
                job.started_at = now
                self._persist_job(job)
            return job

    def _requeue_stale_started(self, queue_name: str, max_age_s: float) -> None:
        if max_age_s <= 0:
            return
        cutoff = time.time() - max_age_s
        stale = []
        with self._mu:
            for j in self.jobs.values():
                if (
                    j.queue == queue_name
                    and j.state is JobState.STARTED
                    and 0 < j.started_at < cutoff
                ):
                    j.state = JobState.PENDING
                    j.started_at = 0.0
                    self._persist_job(j)
                    stale.append(j)
        for j in stale:
            self._q(queue_name).put(j)

    def set_result(
        self, job_id: str, state: JobState, result: Any = None, error: str = ""
    ) -> None:
        """Record a job outcome by id — the wire workers' completion path
        (in-process Workers mutate the shared Job object directly)."""
        with self._mu:
            job = self.jobs.get(job_id)
            if job is None:
                raise KeyError(job_id)
            job.state = state
            job.result = result
            job.error = error
            self._persist_job(job)

    def group_snapshot(self, group_id: str) -> Dict[str, Any]:
        """Group state + per-job states (the jobs API's GET view)."""
        with self._mu:
            group = self.groups.get(group_id)
            if group is None:
                raise KeyError(group_id)
            return {
                "group_id": group_id,
                "state": group.state(self.jobs).value,
                "jobs": [
                    {
                        "id": j.id,
                        "queue": j.queue,
                        "type": j.type,
                        "state": j.state.value,
                        "error": j.error,
                        "result": j.result,
                    }
                    for j in (self.jobs.get(jid) for jid in group.job_ids)
                    if j is not None
                ],
            }

    def list_groups(self, limit: int = 50) -> list:
        """Most-recent group snapshots (the console's jobs view)."""
        with self._mu:
            ids = list(self.groups.keys())[-limit:]
        out = []
        for gid in reversed(ids):
            try:
                out.append(self.group_snapshot(gid))
            except KeyError:
                continue  # pruned between listing and snapshot
        return out

    def prune(self, max_age_s: float) -> int:
        """Drop terminal job records (and emptied groups) older than
        ``max_age_s`` — interval producers (sync_peers every minute for
        the manager's lifetime) must not grow the registry unboundedly.

        PENDING jobs whose ``expires_at`` passed flip FAILURE first: a
        queue whose consumer never attached must not exempt its jobs
        from pruning."""
        now = time.time()
        cutoff = now - max_age_s
        removed = 0
        with self._mu:
            for j in self.jobs.values():
                if (
                    j.state is JobState.PENDING
                    and j.expires_at
                    and now > j.expires_at
                ):
                    j.state = JobState.FAILURE
                    j.error = "expired before execution"
                    self._persist_job(j)
            for jid in [
                j.id for j in self.jobs.values()
                if j.state in (JobState.SUCCESS, JobState.FAILURE)
                and j.created_at < cutoff
            ]:
                job = self.jobs.pop(jid)
                removed += 1
                if self._table is not None:
                    self._table.delete(jid)
                if job.group_id and job.group_id in self.groups:
                    group = self.groups[job.group_id]
                    if jid in group.job_ids:
                        group.job_ids.remove(jid)
                    if not group.job_ids:
                        self.groups.pop(job.group_id, None)
                        if self._gtable is not None:
                            self._gtable.delete(job.group_id)
                    else:
                        self._persist_group(group)
        return removed


class Worker:
    """Consumes one queue; handlers registered per job type
    (scheduler/job/job.go:125 Serve with named consumers)."""

    def __init__(self, broker: JobQueue, queue_name: str) -> None:
        self.broker = broker
        self.queue_name = queue_name
        self._handlers: Dict[str, Callable[[Dict[str, Any]], Any]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(self, job_type: str, handler: Callable[[Dict[str, Any]], Any]) -> None:
        self._handlers[job_type] = handler

    def _run_job(self, job: Job) -> None:
        if job.expires_at and time.time() > job.expires_at:
            job.state = JobState.FAILURE
            job.error = "expired before execution"
            return
        handler = self._handlers.get(job.type)
        if handler is None:
            job.state = JobState.FAILURE
            job.error = f"no handler for {job.type}"
            return
        job.state = JobState.STARTED
        try:
            job.result = handler(job.args)
            job.state = JobState.SUCCESS
        except Exception as exc:  # noqa: BLE001 — job errors land on the job record
            job.state = JobState.FAILURE
            job.error = str(exc)

    def drain(self, timeout: float = 0.0) -> int:
        """Synchronously process everything queued (tests / embedded mode)."""
        n = 0
        while True:
            job = self.broker.get(self.queue_name, timeout=timeout)
            if job is None:
                return n
            self._run_job(job)
            n += 1

    def serve(self) -> None:
        if self._thread is not None:
            return

        def loop() -> None:
            while not self._stop.is_set():
                job = self.broker.get(self.queue_name, timeout=0.2)
                if job is not None:
                    self._run_job(job)

        self._thread = threading.Thread(
            target=loop, name=f"worker-{self.queue_name}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
