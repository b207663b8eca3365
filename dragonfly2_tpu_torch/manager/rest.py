"""Manager REST API (reference: manager/router + handlers — the gin REST
surface the console drives; swagger'd CRUD for models/clusters/schedulers).

Port of the routes of ``dragonfly2_tpu/manager/rest.py`` that the
learned-scheduling loop crosses, with the reference's paths, JSON and
status codes:

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

The rollout routes need a ``RolloutController`` (``rollout=``); without
one they answer 404, as the reference's do, and ``:candidate`` reports
``canary_percent`` 0.  Every other route of the reference (users,
personal access tokens, OAuth, jobs, the CRUD resources and cluster
dynconfig, buckets, certs, replication, the console, metrics and debug
pages) answers 404 here, as the reference's do when their backing object
is ``None``; the constructor takes none of those objects (ROADMAP queue 1
item 14).  With no token verifier and no user store, the reference
authorizes every request; so does this port, which has neither.
"""

from __future__ import annotations

import base64
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler
from typing import Tuple

from ..rpc._server import ThreadedHTTPService
from .cluster import ClusterManager, SchedulerInstance
from .registry import Model, ModelRegistry


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
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        rate_limit=None,
        rollout=None,
    ):
        self.registry = registry
        self.clusters = clusters
        # Rollout controller (rollout/controller.py): serves the
        # candidate poll + evaluation-report routes; None → 404s.
        self.rollout = rollout
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
                if self._rate_limited():
                    return
                parsed = urllib.parse.urlsplit(self.path)
                q = dict(urllib.parse.parse_qsl(parsed.query))
                path = parsed.path
                if path == "/api/v1/healthy":
                    self._json(200, {"ok": True})
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
                        edges = [
                            e
                            for sid, entry in server.topology_shared.items()
                            if sid != exclude
                            for e in entry["edges"]
                        ]
                    self._json(200, {"edges": edges})
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self._rate_limited():
                    return
                path = urllib.parse.urlsplit(self.path).path
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

        self._svc = ThreadedHTTPService(Handler, host, port, "manager-rest")
        self.address: Tuple[str, int] = self._svc.address

    @property
    def url(self) -> str:
        return self._svc.url

    def serve(self) -> None:
        self._svc.serve()

    def stop(self) -> None:
        self._svc.stop()
