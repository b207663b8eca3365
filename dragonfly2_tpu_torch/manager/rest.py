"""Manager REST API (reference: manager/router + handlers — the gin REST
surface the console drives; swagger'd CRUD for models/clusters/schedulers).

Port of the routes of ``dragonfly2_tpu/manager/rest.py`` that the
learned-scheduling loop and the preheat path cross, with the reference's
paths, JSON and status codes:

  GET    /api/v1/healthy                         liveness
  GET    /api/v1/models?scheduler_id=&name=      list models
  POST   /api/v1/models                          create (artifact_b64)
  GET    /api/v1/models:active?scheduler_id=&name=
  GET    /api/v1/models:candidate?scheduler_id=&name=   the SHADOW/CANARY candidate
  GET    /api/v1/models:artifact?id=             {artifact_b64}
  GET    /api/v1/models:get?id=
  POST   /api/v1/models/<id>:activate            single-active activation
  POST   /api/v1/models/<id>:deactivate
  POST   /api/v1/models/<id>:rollout             begin evidence-gated rollout
  POST   /api/v1/models/<id>:delete              guarded delete (rollout rows first)
  GET    /api/v1/rollouts                        rollout state machines
  GET    /api/v1/rollouts:get?scheduler_id=&name=
  POST   /api/v1/rollouts:report                 scheduler evaluation report
  GET    /api/v1/schedulers                      active scheduler instances
  POST   /api/v1/schedulers                      register a scheduler instance
  POST   /api/v1/schedulers/<id>:keepalive       liveness tick → {known}
  GET    /api/v1/topology?exclude=<id>           the other replicas' probe edges
  POST   /api/v1/topology                        push this scheduler's edges
  GET    /api/v1/clusters:search?ip=&hostname=&idc=&location=

The job broker wire (jobs/remote.py contract; the broker is
``jobs/queue.JobQueue``):

  POST   /api/v1/jobs                            {type, args, queues} → group
  GET    /api/v1/jobs                            recent group jobs
  GET    /api/v1/jobs/<gid>                      group + per-job states
  POST   /api/v1/jobs:poll                       {queue, timeout_s?} → job | {}
  POST   /api/v1/jobs/<id>:result                {state, result?, error?}

CRUD resources (manager/handlers/application.go, scheduler_cluster.go;
rows in manager/crud.py CrudStore, write-through to the state backend):

  GET    /api/v1/applications                    list
  POST   /api/v1/applications                    create
  POST   /api/v1/applications/<id>:update        partial update
  POST   /api/v1/applications/<id>:delete
  GET    /api/v1/configs                         list operator settings
  POST   /api/v1/configs                         create
  POST   /api/v1/configs/<id>:update             partial update
  POST   /api/v1/configs/<id>:delete
  GET    /api/v1/clusters                        list scheduler clusters
  POST   /api/v1/clusters                        create
  POST   /api/v1/clusters/<id>:update            partial update
  POST   /api/v1/clusters/<id>:delete
  GET    /api/v1/clusters/<id>:config            the dynconfig payload a
         scheduler polls (scheduling.go:404-410 limit consumption)

The rollout routes need a ``RolloutController`` (``rollout=``); without
one they answer 404, as the reference's do, and ``:candidate`` reports
``canary_percent`` 0.  As in the reference, a server given no job queue
or CRUD store makes its own in memory, and the CRUD store always holds
the default cluster.  The diagnostics routes ``/metrics``,
``/debug/spans``, ``/debug/exemplars`` and ``/debug/slo`` need no backing
object and answer 200, as the reference's do (the same surface the
scheduler's and the daemon's ``utils/diagnostics`` sidecar serves).
Every other route of the reference (users, personal access tokens,
OAuth, buckets, certs, replication, the console) answers 404 here, as
the reference's do when their backing object is ``None``; the
constructor takes none of those objects (ROADMAP queue 1 item 14).  With no token verifier and no user
store, the reference authorizes every request; so does this port, which
has neither.
"""

from __future__ import annotations

import base64
import json
import threading
import time
import urllib.parse
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler
from typing import List, Optional, Tuple

from ..rpc._server import ThreadedHTTPService
from .cluster import ClusterManager, SchedulerInstance
from .crud import CrudStore
from .registry import Model, ModelRegistry
from .searcher import SchedulerCluster, Searcher


def _model_to_json(m: Model) -> dict:
    return {
        "id": m.id,
        "name": m.name,
        "type": m.type,
        "version": m.version,
        "scheduler_id": m.scheduler_id,
        "state": m.state.value,
        "evaluation": m.evaluation,
        "artifact_digest": m.artifact_digest,
    }


class ManagerRESTServer:
    def __init__(
        self,
        registry: ModelRegistry,
        clusters: ClusterManager,
        searcher: Optional[Searcher] = None,
        scheduler_clusters: Optional[List[SchedulerCluster]] = None,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        jobqueue=None,
        crud: Optional[CrudStore] = None,
        rate_limit=None,
        state_backend=None,
        jobs_min_requeue_s: float = 30.0,
        rollout=None,
    ):
        self.registry = registry
        self.clusters = clusters
        # Rollout controller (rollout/controller.py): serves the
        # candidate poll + evaluation-report routes; None → 404s.
        self.rollout = rollout
        self.searcher = searcher or Searcher()
        self.scheduler_clusters = scheduler_clusters or []
        # CRUD resources (applications + scheduler-cluster records whose
        # config blobs feed the schedulers' dynconfig).  The default
        # cluster always exists — dynconfig consumers need one to poll.
        self.crud = crud or CrudStore()
        self.crud.ensure_default_cluster()
        # Token-bucket middleware (manager/middlewares rate limiter): one
        # bucket bounds the whole REST surface; None = off.
        self.rate_limit = rate_limit
        # Shared topology cache (the Redis analog for the probe graph,
        # network_topology.go:55-88): scheduler_id → its pushed edge
        # summaries.  Replicas pull everyone else's edges; a scheduler
        # restart re-pushes within one sync interval.  Entries whose
        # pusher went quiet past the TTL are evicted on read — a
        # decommissioned scheduler's stale RTTs must not skew rankings
        # forever (live schedulers re-push every ~30 s).
        self.topology_shared: dict = {}
        self.topology_ttl_s = 600.0
        self._topology_mu = threading.Lock()
        # With the manager state seam attached, pushed topology survives
        # a manager crash: replicas keep pulling the merged graph after
        # a restart instead of waiting a full re-push cycle.
        self._topology_table = (
            state_backend.table("topology") if state_backend is not None
            else None
        )
        if self._topology_table is not None:
            self.topology_shared = self._topology_table.load_all()
        # Sharded-fleet membership directory (scheduler/sharding.py,
        # DESIGN.md §24): the ACTIVE scheduler set per cluster, versioned
        # and persisted, published with the cluster dynconfig so every
        # client converges on the same ring.  Without a state seam the
        # ring is still published, from an in-memory backend (versions
        # restart).
        from ..manager.state import MemoryBackend
        from ..scheduler.sharding import ShardDirectory

        self.shards = ShardDirectory(
            state_backend if state_backend is not None else MemoryBackend()
        )
        # Job broker (machinery-over-Redis analog, jobs/remote.py): the
        # manager hosts the queues; remote scheduler workers poll them
        # over this REST surface.
        if jobqueue is None:
            from ..jobs.queue import JobQueue

            jobqueue = JobQueue()
        self.jobqueue = jobqueue
        self.jobs_min_requeue_s = jobs_min_requeue_s
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _json(self, code: int, payload, headers=None) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for name, value in (headers or {}).items():
                    self.send_header(name, value)
                self.end_headers()
                self.wfile.write(body)

            def _rate_limited(self) -> bool:
                # Liveness-class routes stay exempt: the limiter must not
                # convert overload into an outage — 429ing health probes
                # gets the manager restarted, and 429ing scheduler
                # keepalives expires HEALTHY schedulers out of the active
                # set exactly when the cluster is busiest.
                path = urllib.parse.urlsplit(self.path).path
                if path == "/api/v1/healthy" or path.endswith(":keepalive"):
                    return False
                if server.rate_limit is not None and not server.rate_limit.take():
                    from ..rpc.metrics import RATE_LIMITED_TOTAL

                    RATE_LIMITED_TOTAL.inc(transport="manager-rest")
                    self._json(429, {"error": "rate limit exceeded"})
                    return True
                return False

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(length) or b"{}")

            def do_GET(self):
                # Request span linked to the caller's trace (otelgrpc
                # server-interceptor analog for the REST plane): the
                # route rides as an attribute, not the span name, so
                # cardinality stays bounded.
                from ..utils.tracing import TRACEPARENT_HEADER, default_tracer

                with default_tracer.remote_span(
                    "manager/GET",
                    self.headers.get(TRACEPARENT_HEADER),
                    path=urllib.parse.urlsplit(self.path).path,
                    transport="rest",
                ):
                    self._handle_GET()

            def _handle_GET(self):
                if self._rate_limited():
                    return
                parsed = urllib.parse.urlsplit(self.path)
                q = dict(urllib.parse.parse_qsl(parsed.query))
                path = parsed.path
                if path == "/api/v1/healthy":
                    self._json(200, {"ok": True})
                elif path == "/metrics":
                    # Prometheus text exposition — the same diagnostics
                    # surface the scheduler/daemon serve via
                    # utils/diagnostics.py (DESIGN.md §21).
                    from ..utils.metrics import default_registry

                    body = default_registry.expose_text().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/plain; version=0.0.4"
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/debug/spans":
                    # Recent-span ring as one OTLP/JSON request.
                    from ..utils.tracing import recent_spans_otlp

                    self._json(200, recent_spans_otlp())
                elif path == "/debug/exemplars":
                    # Histogram exemplars: last trace id per bucket, so a
                    # slow-bucket latency joins to its trace.
                    from ..utils.metrics import default_registry

                    self._json(200, default_registry.exemplars())
                elif path == "/debug/slo":
                    # SLO burn rates + breach verdicts (DESIGN.md §23) —
                    # the same surface the scheduler/daemon diagnostics
                    # sidecar serves.
                    from ..utils.slo import debug_state

                    self._json(200, debug_state())
                elif path == "/api/v1/models":
                    models = server.registry.list(
                        scheduler_id=q.get("scheduler_id") or None,
                        name=q.get("name") or None,
                    )
                    self._json(200, [_model_to_json(m) for m in models])
                elif path == "/api/v1/models:active":
                    m = server.registry.active_model(
                        q.get("scheduler_id", ""), q.get("name", "")
                    )
                    if m is None:
                        self._json(404, {"error": "no active model"})
                    else:
                        self._json(200, _model_to_json(m))
                elif path == "/api/v1/models:artifact":
                    m = server.registry.get(q.get("id", ""))
                    if m is None:
                        self._json(404, {"error": "model not found"})
                    else:
                        try:
                            blob = server.registry.load_artifact(m)
                        except (KeyError, OSError, ValueError) as exc:
                            # Row exists but the blob is gone (mismatched
                            # blob dir after restart) or fails its digest
                            # check (ArtifactDigestError) — a clean 404
                            # beats a dead handler thread + connection
                            # reset, and no client ever receives bytes
                            # the manager itself cannot verify.
                            self._json(404, {"error": f"artifact unavailable: {exc}"})
                            return
                        self._json(
                            200, {"artifact_b64": base64.b64encode(blob).decode()}
                        )
                elif path == "/api/v1/models:get":
                    m = server.registry.get(q.get("id", ""))
                    if m is None:
                        self._json(404, {"error": "model not found"})
                    else:
                        self._json(200, _model_to_json(m))
                elif path == "/api/v1/models:candidate":
                    # The scheduler's rollout poll: the version under
                    # evaluation (SHADOW/CANARY) + its routing percent.
                    m = server.registry.candidate_model(
                        q.get("scheduler_id", ""), q.get("name", "")
                    )
                    if m is None:
                        self._json(404, {"error": "no candidate model"})
                    else:
                        rollout = (
                            server.rollout.get(m.scheduler_id, m.name)
                            if server.rollout is not None
                            else None
                        )
                        self._json(200, {
                            "model": _model_to_json(m),
                            "phase": m.state.value,
                            "canary_percent": (
                                rollout.canary_percent if rollout else 0
                            ),
                        })
                elif path == "/api/v1/rollouts":
                    if server.rollout is None:
                        self._json(404, {"error": "rollout controller not configured"})
                    else:
                        self._json(200, [
                            server.rollout.to_json(r)
                            for r in server.rollout.list()
                        ])
                elif path == "/api/v1/rollouts:get":
                    r = (
                        server.rollout.get(
                            q.get("scheduler_id", ""), q.get("name", "")
                        )
                        if server.rollout is not None
                        else None
                    )
                    if r is None:
                        self._json(404, {"error": "no such rollout"})
                    else:
                        self._json(200, server.rollout.to_json(r))
                elif path == "/api/v1/schedulers":
                    self._json(
                        200,
                        [
                            {
                                "id": s.id,
                                "cluster_id": s.cluster_id,
                                "ip": s.ip,
                                "port": s.port,
                                "state": s.state,
                            }
                            for s in server.clusters.active_schedulers()
                        ],
                    )
                elif path == "/api/v1/topology":
                    # Cross-replica pull: every LIVE pusher's edges EXCEPT
                    # the caller's own (it already has those, fresher).
                    exclude = q.get("exclude", "")
                    now = time.time()
                    with server._topology_mu:
                        dead = [
                            sid
                            for sid, entry in server.topology_shared.items()
                            if now - entry["pushed_at"] > server.topology_ttl_s
                        ]
                        for sid in dead:
                            del server.topology_shared[sid]
                            if server._topology_table is not None:
                                server._topology_table.delete(sid)
                        edges = [
                            e
                            for sid, entry in server.topology_shared.items()
                            if sid != exclude
                            for e in entry["edges"]
                        ]
                    self._json(200, {"edges": edges})
                elif path == "/api/v1/jobs":
                    # Recent group jobs (console view; handlers/job.go list).
                    self._json(200, server.jobqueue.list_groups())
                elif path.startswith("/api/v1/jobs/"):
                    gid = path[len("/api/v1/jobs/"):]
                    try:
                        self._json(200, server.jobqueue.group_snapshot(gid))
                    except KeyError:
                        self._json(404, {"error": f"no group {gid!r}"})
                elif path == "/api/v1/applications":
                    self._json(
                        200, [asdict(a) for a in server.crud.list("application")]
                    )
                elif path == "/api/v1/configs":
                    self._json(200, [asdict(c) for c in server.crud.list("config")])
                elif path == "/api/v1/clusters":
                    self._json(200, [asdict(c) for c in server.crud.list("cluster")])
                elif path.startswith("/api/v1/clusters/") and path.endswith(
                    ":config"
                ):
                    # The dynconfig payload a scheduler polls for its live
                    # scheduling limits (scheduling.go:404-410).
                    cid = path[len("/api/v1/clusters/"):-len(":config")]
                    try:
                        payload = server.crud.cluster_config(cid)
                        # The reference derives tenant_id from an
                        # authenticated poll's credential; with no token
                        # verifier and no user store no poll carries one.
                        # The shard ring rides the cluster dynconfig
                        # (DESIGN.md §24): membership is the ACTIVE
                        # scheduler set; a set change bumps the durable
                        # ring version and every poller re-routes.
                        payload["scheduler_ring"] = server.shards.publish(
                            cid,
                            [
                                (s.id, f"http://{s.ip}:{s.port}")
                                for s in server.clusters.active_schedulers(cid)
                            ],
                        )
                        self._json(200, payload)
                    except KeyError as exc:
                        self._json(404, {"error": str(exc)})
                elif path == "/api/v1/clusters:search":
                    try:
                        ranked = server.searcher.find_scheduler_clusters(
                            server.search_clusters(),
                            ip=q.get("ip", ""),
                            hostname=q.get("hostname", ""),
                            conditions={
                                "idc": q.get("idc", ""),
                                "location": q.get("location", ""),
                            },
                        )
                        self._json(200, [c.id for c in ranked])
                    except LookupError as exc:
                        self._json(404, {"error": str(exc)})
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                from ..utils.tracing import TRACEPARENT_HEADER, default_tracer

                with default_tracer.remote_span(
                    "manager/POST",
                    self.headers.get(TRACEPARENT_HEADER),
                    path=urllib.parse.urlsplit(self.path).path,
                    transport="rest",
                ):
                    self._handle_POST()

            def _handle_POST(self):
                if self._rate_limited():
                    return
                path = urllib.parse.urlsplit(self.path).path
                # The reference checks a role per route here; with no
                # token verifier and no user store every request is
                # authorized, and this port has neither.
                if path.startswith("/api/v1/jobs"):
                    self._job_routes(path)
                    return
                if (
                    path.startswith("/api/v1/applications")
                    or path.startswith("/api/v1/configs")
                    or (
                        path.startswith("/api/v1/clusters")
                        and not path.startswith("/api/v1/clusters:")
                    )
                ):
                    self._crud_routes(path)
                    return
                if path == "/api/v1/topology":
                    # Scheduler push: replace this scheduler's edge set.
                    try:
                        req = self._body()
                        sid = req["scheduler_id"]
                        # Validate edge shape at the WRITE boundary: one
                        # malformed push must not poison every replica's
                        # merge on pull.
                        edges = [
                            e for e in (req.get("edges") or [])
                            if isinstance(e, dict)
                            and e.get("src") and e.get("dst")
                            and isinstance(e.get("average_rtt_ns"), int)
                        ]
                        with server._topology_mu:
                            server.topology_shared[sid] = {
                                "edges": edges, "pushed_at": time.time(),
                            }
                            if server._topology_table is not None:
                                server._topology_table.put(
                                    sid, server.topology_shared[sid]
                                )
                        self._json(200, {"ok": True, "edges": len(edges)})
                    except (KeyError, ValueError, TypeError) as exc:
                        self._json(400, {"error": str(exc)})
                    return
                if path == "/api/v1/schedulers":
                    # Scheduler instance registration over REST — the wire
                    # the scheduler binary uses to join the manager's
                    # cluster table.
                    try:
                        req = self._body()
                        inst = server.clusters.register_scheduler(
                            SchedulerInstance(
                                id=req["id"],
                                cluster_id=req.get("cluster_id", "default"),
                                hostname=req.get("hostname", ""),
                                ip=req.get("ip", ""),
                                port=int(req.get("port", 8002)),
                            )
                        )
                        self._json(200, {
                            "id": inst.id, "cluster_id": inst.cluster_id,
                            "state": inst.state,
                        })
                    except (KeyError, ValueError, TypeError) as exc:
                        # TypeError: int(None)/int([]) from malformed port —
                        # a 400, not a dropped connection.
                        self._json(400, {"error": str(exc)})
                    return
                if path.startswith("/api/v1/schedulers/") and path.endswith(
                    ":keepalive"
                ):
                    inst_id = path[len("/api/v1/schedulers/"):-len(":keepalive")]
                    # known=False tells the instance the manager lost it
                    # (restart) and it must re-register.
                    self._json(200, {"known": server.clusters.keepalive(inst_id)})
                    return
                if path == "/api/v1/models":
                    # CreateModel (reference: manager_server_v1.go:802).
                    try:
                        req = self._body()
                        m = server.registry.create_model(
                            name=req["name"],
                            type=req["type"],
                            scheduler_id=req["scheduler_id"],
                            artifact=base64.b64decode(req.get("artifact_b64", "")),
                            evaluation=req.get("evaluation") or {},
                        )
                        self._json(200, _model_to_json(m))
                    except (KeyError, ValueError) as exc:
                        self._json(400, {"error": str(exc)})
                    return
                if path == "/api/v1/rollouts:report":
                    # One evaluation report from a scheduler → the
                    # controller's decision (rollout/controller.py).
                    if server.rollout is None:
                        self._json(404, {"error": "rollout controller not configured"})
                        return
                    try:
                        req = self._body()
                        decision = server.rollout.report(
                            req["scheduler_id"], req["name"],
                            dict(req.get("report") or {}),
                        )
                        self._json(200, decision)
                    except KeyError as exc:
                        self._json(404, {"error": str(exc)})
                    except (ValueError, TypeError) as exc:
                        self._json(400, {"error": str(exc)})
                    return
                if path.startswith("/api/v1/models/") and ":" in path:
                    model_id, _, action = path[len("/api/v1/models/") :].rpartition(":")
                    try:
                        if action == "activate":
                            m = server.registry.activate(model_id)
                        elif action == "deactivate":
                            m = server.registry.deactivate(model_id)
                        elif action == "rollout":
                            # Begin the evidence-gated rollout for this
                            # version (CANDIDATE → SHADOW).
                            if server.rollout is None:
                                self._json(
                                    404,
                                    {"error": "rollout controller not configured"},
                                )
                                return
                            req = self._body()
                            r = server.rollout.begin(
                                model_id,
                                canary_percent=req.get("canary_percent"),
                            )
                            self._json(200, server.rollout.to_json(r))
                            return
                        elif action == "delete":
                            # Model deletes flow through the rollout
                            # controller's guarded cleanup (foreign key
                            # models→rollouts): rollout rows must not
                            # outlive the model row they reference.  An ad
                            # hoc controller covers managers without a
                            # rollout plane configured (no rows to strand,
                            # same guarded path).
                            controller = server.rollout
                            if controller is None:
                                from ..rollout.controller import (
                                    RolloutController,
                                )

                                controller = RolloutController(server.registry)
                            if server.registry.get(model_id) is None:
                                self._json(
                                    404,
                                    {"error": f"model {model_id} not found"},
                                )
                                return
                            controller.delete_model(model_id)
                            self._json(200, {"deleted": model_id})
                            return
                        else:
                            self._json(404, {"error": f"unknown action {action}"})
                            return
                        self._json(200, _model_to_json(m))
                    except KeyError:
                        self._json(404, {"error": f"model {model_id} not found"})
                    except ValueError as exc:
                        self._json(400, {"error": str(exc)})
                    return
                self._json(404, {"error": "not found"})

            def _crud_routes(self, path: str) -> None:
                """Applications + scheduler-cluster CRUD
                (manager/handlers/application.go, scheduler_cluster.go)."""
                if path.startswith("/api/v1/applications"):
                    kind, base = "application", "/api/v1/applications"
                elif path.startswith("/api/v1/configs"):
                    kind, base = "config", "/api/v1/configs"
                else:
                    kind, base = "cluster", "/api/v1/clusters"
                try:
                    if path == base:
                        obj = server.crud.create(kind, **self._body())
                        self._json(200, asdict(obj))
                        return
                    rest = path[len(base) + 1:]
                    row_id, _, action = rest.rpartition(":")
                    if action == "update":
                        obj = server.crud.update(kind, row_id, **self._body())
                        self._json(200, asdict(obj))
                    elif action == "delete":
                        server.crud.delete(kind, row_id)
                        self._json(200, {"ok": True})
                    else:
                        self._json(404, {"error": f"unknown action {action!r}"})
                except KeyError as exc:
                    self._json(404, {"error": str(exc)})
                except (ValueError, TypeError) as exc:
                    self._json(400, {"error": str(exc)})

            def _job_routes(self, path: str) -> None:
                """Job broker wire (jobs/remote.py contract)."""
                from ..jobs.queue import JobState

                try:
                    if path == "/api/v1/jobs":
                        req = self._body()
                        queues = req.get("queues") or []
                        if not queues or "type" not in req:
                            self._json(400, {"error": "type and queues required"})
                            return
                        group = server.jobqueue.create_group_job(
                            req["type"],
                            {q: dict(req.get("args") or {}) for q in queues},
                        )
                        self._json(200, server.jobqueue.group_snapshot(group.id))
                    elif path == "/api/v1/jobs:poll":
                        req = self._body()
                        queue_name = req.get("queue", "")
                        if not queue_name:
                            self._json(400, {"error": "queue required"})
                            return
                        timeout = min(float(req.get("timeout_s") or 5.0), 30.0)
                        # Visibility window override (machinery's
                        # visibility-timeout analog) — floored by the
                        # operator's jobs_min_requeue_s: an impatient
                        # worker must not force-redeliver every job
                        # another worker is still executing.
                        requeue_after = max(
                            float(req.get("requeue_started_after_s") or 120.0),
                            server.jobs_min_requeue_s,
                        )
                        job = server.jobqueue.poll(
                            queue_name, timeout=timeout,
                            requeue_started_after_s=requeue_after,
                        )
                        if job is None:
                            self._json(200, {})  # empty poll (204 bodies confuse keep-alive)
                            return
                        self._json(200, {
                            "id": job.id, "type": job.type,
                            "args": job.args, "group_id": job.group_id,
                        })
                    elif path.startswith("/api/v1/jobs/") and path.endswith(":result"):
                        job_id = path[len("/api/v1/jobs/"):-len(":result")]
                        req = self._body()
                        state = JobState(req.get("state", "FAILURE"))
                        if state not in (JobState.SUCCESS, JobState.FAILURE):
                            self._json(400, {"error": f"bad state {state}"})
                            return
                        server.jobqueue.set_result(
                            job_id, state,
                            result=req.get("result"),
                            error=req.get("error", ""),
                        )
                        self._json(200, {"ok": True})
                    else:
                        self._json(404, {"error": "not found"})
                except KeyError as exc:
                    self._json(404, {"error": str(exc)})
                except ValueError as exc:
                    self._json(400, {"error": str(exc)})

        self._svc = ThreadedHTTPService(Handler, host, port, "manager-rest")
        self.address: Tuple[str, int] = self._svc.address

    def search_clusters(self) -> List[SchedulerCluster]:
        """The searcher's candidate set: the constructor-injected list when
        provided (tests, static deployments), else the CRUD cluster rows —
        ONE cluster model, so a cluster created over REST is immediately
        searchable, with live scheduler ids from the keepalive table."""
        if self.scheduler_clusters:
            return self.scheduler_clusters
        from .searcher import ClusterScopes

        out = []
        for rec in self.crud.list("cluster"):
            scopes = rec.scopes or {}
            out.append(SchedulerCluster(
                id=rec.id,
                name=rec.name,
                is_default=rec.is_default,
                scopes=ClusterScopes(
                    idc=scopes.get("idc", ""),
                    location=scopes.get("location", ""),
                    cidrs=tuple(scopes.get("cidrs", ())),
                    hostnames=tuple(scopes.get("hostnames", ())),
                ),
                scheduler_ids=[
                    s.id for s in self.clusters.active_schedulers(rec.id)
                ],
            ))
        return out

    @property
    def url(self) -> str:
        return self._svc.url

    def serve(self) -> None:
        self._svc.serve()

    def stop(self) -> None:
        self._svc.stop()
