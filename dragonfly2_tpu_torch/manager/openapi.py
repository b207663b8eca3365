"""OpenAPI description of the manager REST surface (reference:
api/manager/swagger.json — the gin-swagger export the console and API
clients consume).  Served at GET /swagger.json and /api/v1/openapi by
manager/rest.py; hand-maintained next to the routes it describes.

Port of ``dragonfly2_tpu/manager/openapi.py``, verbatim.
"""

from __future__ import annotations


def _op(summary, *, body=None, params=None, roles=None):
    op = {"summary": summary, "responses": {"200": {"description": "OK"}}}
    if body:
        op["requestBody"] = {
            "content": {"application/json": {"schema": {
                "type": "object", "properties": body,
            }}}
        }
    if params:
        op["parameters"] = [
            {"name": n, "in": "query", "schema": {"type": "string"}}
            for n in params
        ]
    if roles:
        op["description"] = f"Requires role ≥ {roles} when RBAC is enabled."
    return op


STR = {"type": "string"}
INT = {"type": "integer"}
OBJ = {"type": "object"}


def spec() -> dict:
    """The OpenAPI 3 document for every route manager/rest.py serves."""
    paths = {
        "/api/v1/healthy": {"get": _op("Liveness probe")},
        "/api/v1/models": {
            "get": _op("List models", params=["scheduler_id", "name"]),
            "post": _op("Create a model version (trainer flow)",
                        body={"name": STR, "type": STR, "scheduler_id": STR,
                              "artifact_b64": STR, "evaluation": OBJ},
                        roles="PEER"),
        },
        "/api/v1/models:active": {
            "get": _op("The single active model", params=["scheduler_id", "name"]),
        },
        "/api/v1/models:get": {"get": _op("Model by id", params=["id"])},
        "/api/v1/models:artifact": {
            "get": _op("Model artifact (base64)", params=["id"]),
        },
        "/api/v1/models/{id}:activate": {
            "post": _op("Activate (single-active per name)", roles="OPERATOR"),
        },
        "/api/v1/models/{id}:deactivate": {
            "post": _op("Deactivate", roles="OPERATOR"),
        },
        "/api/v1/schedulers": {
            "get": _op("Active scheduler instances"),
            "post": _op("Register a scheduler instance",
                        body={"id": STR, "cluster_id": STR, "hostname": STR,
                              "ip": STR, "port": INT},
                        roles="PEER"),
        },
        "/api/v1/schedulers/{id}:keepalive": {
            "post": _op("Liveness tick → {known}", roles="PEER"),
        },
        "/api/v1/clusters": {
            "get": _op("List scheduler-cluster records"),
            "post": _op("Create a scheduler cluster",
                        body={"id": STR, "name": STR,
                              "scheduler_cluster_config": OBJ,
                              "client_config": OBJ, "scopes": OBJ},
                        roles="OPERATOR"),
        },
        "/api/v1/clusters/{id}:update": {
            "post": _op("Partial update (limits apply LIVE via dynconfig)",
                        roles="OPERATOR"),
        },
        "/api/v1/clusters/{id}:delete": {"post": _op("Delete", roles="OPERATOR")},
        "/api/v1/clusters/{id}:config": {
            "get": _op("The dynconfig payload schedulers poll"),
        },
        "/api/v1/clusters:search": {
            "get": _op("Rank clusters for a client",
                       params=["ip", "hostname", "idc", "location"]),
        },
        "/api/v1/applications": {
            "get": _op("List applications"),
            "post": _op("Create an application",
                        body={"name": STR, "url": STR, "bio": STR,
                              "priority": INT},
                        roles="OPERATOR"),
        },
        "/api/v1/applications/{id}:update": {
            "post": _op("Partial update", roles="OPERATOR"),
        },
        "/api/v1/applications/{id}:delete": {
            "post": _op("Delete", roles="OPERATOR"),
        },
        "/api/v1/configs": {
            "get": _op("List named config rows"),
            "post": _op("Create a config (name unique)",
                        body={"name": STR, "value": STR, "bio": STR},
                        roles="OPERATOR"),
        },
        "/api/v1/configs/{id}:update": {
            "post": _op("Partial update", roles="OPERATOR"),
        },
        "/api/v1/configs/{id}:delete": {"post": _op("Delete", roles="OPERATOR")},
        "/api/v1/buckets": {
            "get": _op("List buckets (configured backend)"),
            "post": _op("Create a bucket", body={"name": STR},
                        roles="OPERATOR"),
        },
        "/api/v1/buckets/{name}:delete": {
            "post": _op("Destroy a bucket", roles="OPERATOR"),
        },
        "/api/v1/topology": {
            "get": _op("Cross-replica probe-edge pull", params=["exclude"]),
            "post": _op("Scheduler probe-edge push",
                        body={"scheduler_id": STR, "edges":
                              {"type": "array", "items": OBJ}},
                        roles="PEER"),
        },
        "/api/v1/jobs": {
            "get": _op("Recent group jobs (console view)"),
            "post": _op("Create a group job (preheat, sync_peers)",
                        body={"type": STR, "args": OBJ, "queues":
                              {"type": "array", "items": STR}},
                        roles="OPERATOR"),
        },
        "/api/v1/certs:issue": {
            "post": _op("Issue a cluster-CA-signed certificate from a CSR "
                        "(certify flow; TTL server-capped)",
                        body={"csr_pem": STR, "ttl_hours": INT},
                        roles="PEER"),
        },
        "/api/v1/certs:ca": {
            "get": _op("Cluster trust root (PEM)"),
        },
        "/api/v1/jobs/{group_id}": {"get": _op("Group job state")},
        "/api/v1/jobs:poll": {
            "post": _op("Worker long-poll",
                        body={"queue": STR, "timeout_s": INT}, roles="PEER"),
        },
        "/api/v1/jobs/{id}:result": {
            "post": _op("Worker result report",
                        body={"state": STR, "result": OBJ, "error": STR},
                        roles="PEER"),
        },
        "/api/v1/users:signup": {
            "post": _op("Open signup (READONLY role)",
                        body={"name": STR, "password": STR, "email": STR}),
        },
        "/api/v1/users:signin": {
            "post": _op("Password signin → session token",
                        body={"name": STR, "password": STR}),
        },
        "/api/v1/users": {"get": _op("List users", roles="ADMIN")},
        "/api/v1/users/{id}:role": {"post": _op("Set role", roles="ADMIN")},
        "/api/v1/users/{id}:state": {
            "post": _op("Enable/disable", roles="ADMIN"),
        },
        "/api/v1/users/{id}:reset-password": {
            "post": _op("Reset password (self w/ session, or ADMIN)"),
        },
        "/api/v1/pats": {
            "get": _op("Own personal access tokens", params=["user_id"]),
            "post": _op("Create a PAT (raw shown once)",
                        body={"name": STR, "role": STR, "ttl_s": INT}),
        },
        "/api/v1/pats/{id}:revoke": {"post": _op("Revoke a PAT")},
        "/api/v1/oauth:providers": {"get": _op("OAuth providers")},
        "/api/v1/oauth/{name}:authorize-url": {
            "get": _op("Provider authorize URL", params=["redirect_uri"]),
        },
        "/api/v1/oauth/{name}:signin": {
            "post": _op("OAuth code exchange → session token",
                        body={"code": STR, "state": STR,
                              "redirect_uri": STR}),
        },
    }
    from .. import __version__

    return {
        "openapi": "3.0.3",
        "info": {
            "title": "dragonfly2-tpu manager API",
            "version": __version__,
            "description": (
                "Control-plane REST surface (reference parity: "
                "api/manager/swagger.json).  Mutations authenticate with "
                "`Authorization: Bearer <session token | PAT>` when RBAC "
                "is enabled; reads stay open."
            ),
        },
        "paths": paths,
    }
