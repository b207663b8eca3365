"""Manager REST API (reference: manager/router + handlers — the gin REST
surface the console drives; swagger'd CRUD for models/clusters/schedulers).

Minimal JSON binding over stdlib HTTP:

  GET    /api/v1/models?scheduler_id=&name=      list models
  POST   /api/v1/models/<id>:activate            single-active activation
  POST   /api/v1/models/<id>:deactivate
  POST   /api/v1/models/<id>:rollout             begin evidence-gated rollout (OPERATOR)
  GET    /api/v1/models:candidate?scheduler_id=&name=   the SHADOW/CANARY candidate
  GET    /api/v1/rollouts                        rollout state machines
  GET    /api/v1/rollouts:get?scheduler_id=&name=
  POST   /api/v1/rollouts:report                 scheduler evaluation report (PEER)
  GET    /api/v1/schedulers                      active scheduler instances
  POST   /api/v1/schedulers                      register a scheduler instance
  POST   /api/v1/schedulers/<id>:keepalive       liveness tick → {known}
  GET    /api/v1/clusters:search?ip=&hostname=&idc=&location=
  GET    /api/v1/healthy                         liveness

CRUD resources (manager/handlers/application.go, scheduler_cluster.go;
rows in manager/crud.py CrudStore, sqlite write-through):

  GET    /api/v1/applications                    list
  POST   /api/v1/applications                    create        (OPERATOR)
  POST   /api/v1/applications/<id>:update        partial update (OPERATOR)
  POST   /api/v1/applications/<id>:delete                       (OPERATOR)
  GET    /api/v1/clusters                        list scheduler clusters
  POST   /api/v1/clusters                        create        (OPERATOR)
  POST   /api/v1/clusters/<id>:update            partial update (OPERATOR)
  POST   /api/v1/clusters/<id>:delete                           (OPERATOR)
  GET    /api/v1/clusters/<id>:config            the dynconfig payload a
         scheduler polls (scheduling.go:404-410 limit consumption)
  GET    /api/v1/buckets                         list (needs a configured
  POST   /api/v1/buckets                          object-storage backend —
  POST   /api/v1/buckets/<name>:delete            handlers/bucket.go proxy)

User/RBAC surface (manager/handlers/user.go + personal access tokens):

  POST   /api/v1/users:signup                    open signup (READONLY)
  POST   /api/v1/users:signin                    {name,password} → token
  GET    /api/v1/users                           ADMIN
  POST   /api/v1/users/<id>:role                 ADMIN
  POST   /api/v1/users/<id>:state                ADMIN enable/disable
  POST   /api/v1/users/<id>:reset-password       self or ADMIN
  POST   /api/v1/pats                            create PAT (raw shown once)
  GET    /api/v1/pats                            own tokens (ADMIN: ?user_id=)
  POST   /api/v1/pats/<id>:revoke                owner or ADMIN
  GET    /api/v1/oauth:providers
  GET    /api/v1/oauth/<name>:authorize-url?redirect_uri=
  POST   /api/v1/oauth/<name>:signin             {code,state,redirect_uri} → token

Authorization accepts EITHER a manager-issued HMAC session token or a
raw personal access token in ``Authorization: Bearer ...``.

Port of ``dragonfly2_tpu/manager/rest.py``: the same routes, JSON bodies,
status codes and role tiers.  With a replication holder (``ha=``, a
``manager/replication.ReplicatedStateBackend``) the server answers
``/api/v1/replication:status``, ``:log`` and ``:snapshot`` (the last two
only to a request signed with the shared lease secret), puts the role and
term in ``/api/v1/healthy``, and while the node is a standby answers every
write 503 with ``Retry-After`` and never seeds the default cluster row;
without one the replication routes answer 404 ``replication not
configured``, as the reference's do.  The handler reads ``registry``,
``crud``, ``rollout`` and ``jobqueue`` off the server on every request, so
a standby that rebuilds them after each replicated batch serves the fresh
ones.  With no token verifier and no user store every request is
authorized, as in the reference.
"""

from __future__ import annotations

import base64
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler
from typing import List, Optional, Tuple

from ..rpc._server import ThreadedHTTPService
from ..security.tokens import Role

from .cluster import ClusterManager
from .crud import CrudStore
from .registry import Model, ModelRegistry
from .searcher import SchedulerCluster, Searcher


def _user_to_json(u) -> dict:
    return {
        "id": u.id,
        "name": u.name,
        "email": u.email,
        "role": u.role.name.lower(),
        "state": u.state,
    }


def _pat_to_json(p) -> dict:
    return {
        "id": p.id,
        "user_id": p.user_id,
        "name": p.name,
        "role": p.role.name.lower(),
        "expires_at": p.expires_at,
        "revoked": p.revoked,
    }


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
        token_verifier=None,
        token_issuer=None,
        users=None,
        oauth=None,
        jobqueue=None,
        crud: Optional[CrudStore] = None,
        objectstorage=None,
        rate_limit=None,
        ca=None,
        state_backend=None,
        jobs_min_requeue_s: float = 30.0,
        rollout=None,
        ha=None,
    ):
        self.registry = registry
        self.clusters = clusters
        # Replication role holder (manager/replication.py
        # ReplicatedStateBackend): serves /api/v1/replication:* and, in
        # the standby role, 503+Retry-After's every write until
        # promotion (clients fail over via rpc/resolver.ManagerEndpoints).
        self.ha = ha
        # Rollout controller (rollout/controller.py): serves the
        # candidate poll + evaluation-report routes; None → 404s.
        self.rollout = rollout
        # Cluster CA (security/ca.py CertificateAuthority): with one
        # attached, peers self-provision their mTLS identity over the
        # wire at boot — POST /api/v1/certs:issue (the reference's
        # certify flow, pkg/issuer + scheduler.go:186-222).  None → 404.
        self.ca = ca
        self.searcher = searcher or Searcher()
        self.scheduler_clusters = scheduler_clusters or []
        # CRUD resources (applications + scheduler-cluster records whose
        # config blobs feed the schedulers' dynconfig).  The default
        # cluster always exists — dynconfig consumers need one to poll.
        # A STANDBY never seeds it: the row replicates from the leader
        # (writes are gated until promotion).
        self.crud = crud or CrudStore()
        if ha is None or ha.role == "leader":
            self.crud.ensure_default_cluster()
        # Optional ObjectStorageBackend the bucket routes proxy to
        # (manager/handlers/bucket.go semantics); None → 404s.
        self.objectstorage = objectstorage
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
        # and persisted (on the replicated backend it survives a leader
        # bounce), published with the cluster dynconfig so every client
        # converges on the same ring.  Without a state seam the ring is
        # still published, from an in-memory backend (versions restart).
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
        # Optional RBAC: with a verifier configured, mutations require a
        # bearer token of sufficient role (security/tokens.py); reads stay
        # open (matching the reference's authenticated-writes posture).
        # With a UserStore attached, PATs authenticate too and the user/
        # PAT/oauth routes come alive.
        self.jobs_min_requeue_s = jobs_min_requeue_s
        self.token_verifier = token_verifier
        self.token_issuer = token_issuer
        self.users = users
        self.oauth = oauth
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

            def _replication_auth_rejected(self, path: str) -> bool:
                """The :log/:snapshot routes dump every namespace —
                users/PATs credential rows included on default
                deployments — so they demand proof of the shared
                lease_secret (the follower signs each fetch); anything
                else 403s instead of bypassing the ADMIN-gated user
                routes."""
                from .replication import (
                    REPLICATION_AUTH_HEADER,
                    verify_replication_request,
                )

                token = self.headers.get(REPLICATION_AUTH_HEADER, "")
                if verify_replication_request(
                    server.ha.lease_secret, path, token
                ):
                    return False
                self._json(403, {
                    "error": "replication fetch requires the shared "
                    "lease_secret (X-DF-Replication-Auth)",
                })
                return True

            def _standby_rejected(self) -> bool:
                """Standby role: every mutation 503s with Retry-After
                until promotion — a client that cannot fail over knows
                exactly when to knock again (one follower poll)."""
                ha = server.ha
                if ha is None or ha.role == "leader":
                    return False
                self._json(
                    503,
                    {
                        "error": "manager is a standby replica "
                        f"(term {ha.term}); writes go to the leader",
                        "role": ha.role,
                    },
                    headers={"Retry-After": "1"},
                )
                return True

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
                if path in ("/", "/console", "/console/"):
                    # Embedded console SPA (manager.go:61-62 analog).
                    from .console import CONSOLE_HTML

                    body = CONSOLE_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/api/v1/healthy":
                    payload = {"ok": True}
                    if server.ha is not None:
                        payload["role"] = server.ha.role
                        payload["term"] = server.ha.term
                    self._json(200, payload)
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
                elif path == "/api/v1/replication:status":
                    # Follower poll target: log frontier + the signed
                    # lease (manager/replication.py LogFollower).
                    if server.ha is None:
                        self._json(404, {"error": "replication not configured"})
                    else:
                        status = server.ha.status()
                        if server.ha.role == "leader":
                            status["lease"] = server.ha.lease_payload()
                        self._json(200, status)
                elif path == "/api/v1/replication:log":
                    if server.ha is None:
                        self._json(404, {"error": "replication not configured"})
                    elif not self._replication_auth_rejected(path):
                        try:
                            from_seq = int(q.get("from_seq", 0))
                            limit = min(int(q.get("limit", 500)), 2000)
                        except ValueError as exc:
                            self._json(400, {"error": str(exc)})
                            return
                        # Read under the commit lock (log_entries): a
                        # concurrent append-then-discard must never ship.
                        self._json(
                            200, server.ha.log_entries(from_seq, limit)
                        )
                elif path == "/api/v1/replication:snapshot":
                    # Follower bootstrap: full data-state snapshot for
                    # rows that predate the log (legacy migrations,
                    # pre-HA deployments) or that compacted out of it.
                    if server.ha is None:
                        self._json(404, {"error": "replication not configured"})
                    elif not self._replication_auth_rejected(path):
                        self._json(200, server.ha.snapshot())
                elif path == "/api/v1/certs:ca":
                    # Trust-root fetch (open read: peers need the root
                    # BEFORE they can build a verified TLS context).
                    if server.ca is None:
                        self._json(404, {"error": "no cluster CA configured"})
                    else:
                        self._json(200, {"ca_pem": server.ca.cert_pem.decode()})
                elif path in ("/swagger.json", "/api/v1/openapi"):
                    # The swagger export (api/manager/swagger.json analog).
                    from .openapi import spec

                    self._json(200, spec())
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
                elif path == "/api/v1/users" and server.users is not None:
                    if not self._authorized(Role.ADMIN):
                        self._json(403, {"error": "forbidden"})
                        return
                    self._json(200, [_user_to_json(u) for u in server.users.list_users()])
                elif path == "/api/v1/pats" and server.users is not None:
                    ident = self._identity()
                    if ident is None:
                        self._json(401, {"error": "unauthorized"})
                        return
                    subject, role, _kind = ident
                    target = q.get("user_id") or subject
                    if target != subject and role < Role.ADMIN:
                        self._json(403, {"error": "forbidden"})
                        return
                    self._json(
                        200, [_pat_to_json(p) for p in server.users.list_pats(target)]
                    )
                elif path == "/api/v1/oauth:providers" and server.oauth is not None:
                    self._json(200, server.oauth.providers())
                elif (
                    path.startswith("/api/v1/oauth/")
                    and path.endswith(":authorize-url")
                    and server.oauth is not None
                ):
                    name = path[len("/api/v1/oauth/") : -len(":authorize-url")]
                    try:
                        self._json(
                            200,
                            {"url": server.oauth.authorize_url(
                                name, q.get("redirect_uri", "")
                            )},
                        )
                    except KeyError:
                        self._json(404, {"error": f"no provider {name!r}"})
                elif path == "/api/v1/jobs":
                    # Recent group jobs (console view; handlers/job.go list).
                    self._json(200, server.jobqueue.list_groups())
                elif path.startswith("/api/v1/jobs/"):
                    gid = path[len("/api/v1/jobs/"):]
                    try:
                        self._json(200, server.jobqueue.group_snapshot(gid))
                    except KeyError:
                        self._json(404, {"error": f"no group {gid!r}"})
                elif path == "/api/v1/topology":
                    # Cross-replica pull: every LIVE pusher's edges EXCEPT
                    # the caller's own (it already has those, fresher).
                    import time as _time

                    exclude = q.get("exclude", "")
                    now = _time.time()
                    with server._topology_mu:
                        dead = [
                            sid
                            for sid, entry in server.topology_shared.items()
                            if now - entry["pushed_at"] > server.topology_ttl_s
                        ]
                        for sid in dead:
                            del server.topology_shared[sid]
                            if server._topology_table is not None:
                                from .replication import NotLeaderError

                                try:
                                    server._topology_table.delete(sid)
                                except NotLeaderError:
                                    # Standby: evict from memory only —
                                    # the leader's replicated delete is
                                    # the durable one.
                                    pass
                        edges = [
                            e
                            for sid, entry in server.topology_shared.items()
                            if sid != exclude
                            for e in entry["edges"]
                        ]
                    self._json(200, {"edges": edges})
                elif path == "/api/v1/buckets":
                    # handlers/bucket.go GetBuckets: list through the
                    # configured object-storage backend.
                    if server.objectstorage is None:
                        self._json(404, {"error": "object storage not configured"})
                        return
                    try:
                        names = server.objectstorage.list_buckets()
                    except Exception as exc:  # noqa: BLE001 — backend boundary
                        self._json(502, {"error": str(exc)})
                        return
                    self._json(200, [{"name": n} for n in names])
                elif path == "/api/v1/applications":
                    from dataclasses import asdict

                    self._json(
                        200, [asdict(a) for a in server.crud.list("application")]
                    )
                elif path == "/api/v1/configs":
                    from dataclasses import asdict

                    self._json(200, [asdict(c) for c in server.crud.list("config")])
                elif path == "/api/v1/clusters":
                    from dataclasses import asdict

                    self._json(200, [asdict(c) for c in server.crud.list("cluster")])
                elif path.startswith("/api/v1/clusters/") and path.endswith(
                    ":config"
                ):
                    # The dynconfig payload a scheduler polls for its live
                    # scheduling limits (scheduling.go:404-410).
                    cid = path[len("/api/v1/clusters/"):-len(":config")]
                    try:
                        payload = server.crud.cluster_config(cid)
                        # Tenant identity derivation (DESIGN.md §26): an
                        # authenticated poll (PAT or session token) gets
                        # its tenant id derived from the credential's
                        # subject — the SAME derivation every service
                        # applies, so one identity maps to one tenant
                        # fleet-wide.  Unauthenticated clusters fall back
                        # to their declared DaemonConfig.tenant.
                        ident = self._identity()
                        if ident is not None:
                            from ..qos.policy import derive_tenant

                            payload["tenant_id"] = derive_tenant(ident[0])
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

            def _identity(self):
                """→ (subject, Role, kind) from a session token OR a PAT;
                None when unauthenticated.  kind ∈ {"session", "pat"} —
                credential-management routes require a session.  One
                shared resolver with the gRPC port (tokens.
                resolve_credential): disables/demotions bite everywhere
                immediately."""
                from ..security.tokens import resolve_credential

                auth = self.headers.get("Authorization", "")
                token = auth[len("Bearer ") :] if auth.startswith("Bearer ") else None
                return resolve_credential(
                    token, server.token_verifier, server.users
                )

            def _authorized(self, required_role) -> bool:
                if server.token_verifier is None and server.users is None:
                    return True
                ident = self._identity()
                return ident is not None and ident[1] >= required_role

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(length) or b"{}")

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
                if self._standby_rejected():
                    return
                path = urllib.parse.urlsplit(self.path).path
                if (
                    path.startswith("/api/v1/users")
                    or path.startswith("/api/v1/pats")
                    or path.startswith("/api/v1/oauth/")
                    or path == "/api/v1/oauth:refresh"
                ):
                    self._user_routes(path)
                    return
                # Role per route, declared at the route (tokens.py tiers):
                # model CREATION is the trainer's automated flow → PEER;
                # activation/deactivation are operator decisions; job
                # CREATION is an operator action while poll/result are the
                # scheduler workers' automated flow → PEER.
                if path == "/api/v1/models":
                    required = Role.PEER
                elif path == "/api/v1/rollouts:report":
                    # Shadow/canary evaluation reports are the scheduler's
                    # automated flow (like keepalive/job-poll) → PEER.
                    required = Role.PEER
                elif (
                    path.endswith(":activate")
                    or path.endswith(":deactivate")
                    or path.endswith(":rollout")
                    or (path.startswith("/api/v1/models/")
                        and path.endswith(":delete"))
                ):
                    required = Role.OPERATOR
                elif path == "/api/v1/jobs":
                    required = Role.OPERATOR
                elif path == "/api/v1/jobs:poll" or (
                    path.startswith("/api/v1/jobs/") and path.endswith(":result")
                ):
                    required = Role.PEER
                elif path == "/api/v1/schedulers" or (
                    path.startswith("/api/v1/schedulers/")
                    and path.endswith(":keepalive")
                ):
                    # Scheduler instances self-register and tick liveness —
                    # the automated service flow (UpdateScheduler /
                    # KeepAlive in manager_server_v1.go run on mTLS'd
                    # service identities) → PEER.
                    required = Role.PEER
                elif path == "/api/v1/topology":
                    required = Role.PEER  # scheduler service flow
                elif path == "/api/v1/certs:issue":
                    # Service-identity bootstrap (certify analog) — the
                    # automated peer flow, like registration/keepalive.
                    required = Role.PEER
                elif (
                    path.startswith("/api/v1/applications")
                    or path.startswith("/api/v1/clusters")
                    or path.startswith("/api/v1/buckets")
                    or path.startswith("/api/v1/configs")
                ):
                    # CRUD mutations are operator console actions.
                    required = Role.OPERATOR
                else:
                    required = Role.ADMIN  # unknown mutations: locked down
                if not self._authorized(required):
                    self._json(401, {"error": "unauthorized"})
                    return
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
                if path == "/api/v1/certs:issue":
                    # CSR in, cluster-CA-signed cert out (pkg/issuer /
                    # security_server.go IssueCertificate analog).
                    if server.ca is None:
                        self._json(404, {"error": "no cluster CA configured"})
                        return
                    try:
                        from ..security.ca import clamp_ttl

                        req = self._body()
                        csr_pem = req["csr_pem"].encode()
                        ttl = clamp_ttl(int(req.get("ttl_hours") or 0))
                        cert_pem = server.ca.sign_csr(csr_pem, ttl=ttl)
                        self._json(200, {
                            "cert_pem": cert_pem.decode(),
                            "ca_pem": server.ca.cert_pem.decode(),
                        })
                    except (KeyError, ValueError, TypeError) as exc:
                        self._json(400, {"error": str(exc)})
                    except Exception as exc:  # noqa: BLE001 — x509 parse
                        self._json(400, {"error": f"bad csr: {exc}"})
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
                        import time as _time

                        with server._topology_mu:
                            server.topology_shared[sid] = {
                                "edges": edges, "pushed_at": _time.time(),
                            }
                            if server._topology_table is not None:
                                server._topology_table.put(
                                    sid, server.topology_shared[sid]
                                )
                        self._json(200, {"ok": True, "edges": len(edges)})
                    except (KeyError, ValueError, TypeError) as exc:
                        self._json(400, {"error": str(exc)})
                    return
                if path.startswith("/api/v1/buckets"):
                    # handlers/bucket.go CreateBucket / DestroyBucket —
                    # proxied to the configured backend.
                    if server.objectstorage is None:
                        self._json(404, {"error": "object storage not configured"})
                        return
                    try:
                        if path == "/api/v1/buckets":
                            name = self._body()["name"]
                            if not name or not isinstance(name, str):
                                raise ValueError("bucket name required")
                            server.objectstorage.create_bucket(name)
                            self._json(200, {"name": name})
                        elif path.endswith(":delete"):
                            name = path[len("/api/v1/buckets/"):-len(":delete")]
                            if not name:
                                raise ValueError("bucket name required")
                            server.objectstorage.delete_bucket(name)
                            self._json(200, {"ok": True})
                        else:
                            self._json(404, {"error": "not found"})
                    except (KeyError, ValueError, TypeError) as exc:
                        self._json(400, {"error": str(exc)})
                    except Exception as exc:  # noqa: BLE001 — backend boundary
                        self._json(502, {"error": str(exc)})
                    return
                if path == "/api/v1/schedulers":
                    # Scheduler instance registration over REST — the wire
                    # the CLI uses so sync_peers fan-out (jobs/sync_peers.py
                    # enqueues to f"scheduler:{sched.id}" for every ACTIVE
                    # registered scheduler) reaches the instance's job queue.
                    from .cluster import SchedulerInstance

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
                            # controller's guarded cleanup (DF014 foreign
                            # key models→rollouts): rollout rows must not
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
                from dataclasses import asdict

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

            def _user_routes(self, path: str) -> None:
                """User / PAT / oauth mutations (handlers/user.go)."""
                if server.users is None:
                    self._json(404, {"error": "user store not configured"})
                    return
                try:
                    if path == "/api/v1/users:signup":
                        req = self._body()
                        u = server.users.create_user(
                            req["name"], req["password"],
                            email=req.get("email", ""),
                        )
                        self._json(200, _user_to_json(u))
                    elif path == "/api/v1/users:signin":
                        req = self._body()
                        u = server.users.verify_password(
                            req.get("name", ""), req.get("password", "")
                        )
                        if u is None or server.token_issuer is None:
                            self._json(401, {"error": "bad credentials"})
                            return
                        token = server.token_issuer.issue(u.id, u.role)
                        self._json(200, {"token": token, "role": u.role.name.lower()})
                    elif path.startswith("/api/v1/users/") and ":" in path:
                        user_id, _, action = path[len("/api/v1/users/") :].rpartition(":")
                        ident = self._identity()
                        if ident is None:
                            self._json(401, {"error": "unauthorized"})
                            return
                        subject, role, kind = ident
                        if action == "reset-password":
                            # Sessions only: a leaked low-role PAT must not
                            # be able to rotate its owner's password and
                            # re-signin at the owner's full role.
                            if kind != "session":
                                self._json(403, {"error": "session token required"})
                                return
                            if subject != user_id and role < Role.ADMIN:
                                self._json(403, {"error": "forbidden"})
                                return
                            server.users.reset_password(
                                user_id, self._body()["password"]
                            )
                            self._json(200, {"ok": True})
                        elif action in ("role", "state"):
                            if role < Role.ADMIN:
                                self._json(403, {"error": "forbidden"})
                                return
                            if action == "role":
                                u = server.users.set_role(
                                    user_id, Role[self._body()["role"].upper()]
                                )
                            else:
                                u = server.users.set_state(
                                    user_id, self._body()["state"]
                                )
                            self._json(200, _user_to_json(u))
                        else:
                            self._json(404, {"error": f"unknown action {action}"})
                    elif path == "/api/v1/pats":
                        ident = self._identity()
                        if ident is None:
                            self._json(401, {"error": "unauthorized"})
                            return
                        subject, effective, _kind = ident
                        req = self._body()
                        requested = (
                            Role[req["role"].upper()] if req.get("role")
                            else effective
                        )
                        # Cap at the CALLER's effective role (a READONLY-
                        # capped PAT must not mint tokens at its owner's
                        # full role), on top of create_pat's owner cap.
                        kwargs = {"role": min(requested, effective)}
                        if req.get("ttl_s"):
                            kwargs["ttl_s"] = float(req["ttl_s"])
                        pat, raw = server.users.create_pat(
                            subject, req.get("name", ""), **kwargs
                        )
                        payload = _pat_to_json(pat)
                        payload["token"] = raw  # shown exactly once
                        self._json(200, payload)
                    elif path.startswith("/api/v1/pats/") and path.endswith(":revoke"):
                        pat_id = path[len("/api/v1/pats/") : -len(":revoke")]
                        ident = self._identity()
                        if ident is None:
                            self._json(401, {"error": "unauthorized"})
                            return
                        subject, role, _kind = ident
                        owned = {p.id for p in server.users.list_pats(subject)}
                        if pat_id not in owned and role < Role.ADMIN:
                            self._json(403, {"error": "forbidden"})
                            return
                        server.users.revoke_pat(pat_id)
                        self._json(200, {"ok": True})
                    elif (
                        path.startswith("/api/v1/oauth/")
                        and path.endswith(":signin")
                        and server.oauth is not None
                    ):
                        name = path[len("/api/v1/oauth/") : -len(":signin")]
                        # Issuer check FIRST: consuming the single-use
                        # code/grant and then 500ing would strand it.
                        if server.token_issuer is None:
                            self._json(500, {"error": "no token issuer"})
                            return
                        req = self._body()
                        u, refresh_id = server.oauth.signin_with_refresh(
                            name, req.get("code", ""), req.get("state", ""),
                            req.get("redirect_uri", ""),
                        )
                        token = server.token_issuer.issue(u.id, u.role)
                        self._json(200, {
                            "token": token, "role": u.role.name.lower(),
                            "user": u.name, "refresh_id": refresh_id,
                        })
                    elif (
                        path == "/api/v1/oauth:refresh"
                        and server.oauth is not None
                    ):
                        # Session renewal WITHOUT an interactive authorize
                        # round-trip; a provider-revoked refresh token
                        # 403s here and the console re-authenticates.
                        if server.token_issuer is None:
                            self._json(500, {"error": "no token issuer"})
                            return
                        req = self._body()
                        u, refresh_id = server.oauth.refresh(
                            req.get("refresh_id", "")
                        )
                        token = server.token_issuer.issue(u.id, u.role)
                        self._json(200, {
                            "token": token, "role": u.role.name.lower(),
                            "user": u.name, "refresh_id": refresh_id,
                        })
                    else:
                        self._json(404, {"error": "not found"})
                except PermissionError as exc:
                    self._json(403, {"error": str(exc)})
                except (KeyError, ValueError) as exc:
                    self._json(400, {"error": str(exc)})
                except Exception as exc:  # noqa: BLE001 — IdP outage etc.
                    from .oauth import OAuthUnavailable

                    if isinstance(exc, OAuthUnavailable):
                        # Transient provider failure: the grant is
                        # intact server-side; the console retries.
                        self._json(503, {"error": str(exc)})
                    else:
                        raise

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
