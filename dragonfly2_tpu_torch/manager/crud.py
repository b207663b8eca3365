"""Manager CRUD resources: applications + scheduler-cluster records.

Reference: the manager's GORM models and REST handlers
(manager/handlers/application.go, scheduler_cluster.go,
models/application.go, models/scheduler_cluster.go) — applications tag
traffic for per-app policy; scheduler-cluster rows carry the CLUSTER
CONFIG (candidate/filter parent limits, client load limits) that
schedulers consume through dynconfig (scheduler/scheduling/
scheduling.go:404-410 reads the limits per scheduling pass).

Storage: JSON rows behind the manager's state seam
(manager/state.StateBackend — sqlite embedded, external SQL/KV for HA),
write-through with in-memory reads.

Port of ``dragonfly2_tpu/manager/crud.py``, verbatim but for the imports.
"""

from __future__ import annotations

import re
import threading
import uuid
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Application:
    """models/application.go row: per-application traffic identity."""

    id: str
    name: str
    url: str = ""
    bio: str = ""
    priority: int = 0


@dataclass
class ClusterRecord:
    """models/scheduler_cluster.go row + its config blobs.

    ``scheduler_cluster_config`` carries the scheduling limits the
    scheduler's dynconfig applies live (candidate_parent_limit,
    filter_parent_limit); ``client_config`` the daemon-side knobs
    (load_limit); ``scopes`` the searcher's affinity inputs;
    ``tenant_qos`` the per-tenant QoS table (DESIGN.md §26: priority
    class, weight, upload-bandwidth cap, announce-rate cap per tenant)
    published with the cluster dynconfig and re-published by schedulers
    on announce answers.
    """

    id: str
    name: str = ""
    is_default: bool = False
    scheduler_cluster_config: Dict[str, Any] = field(default_factory=dict)
    client_config: Dict[str, Any] = field(default_factory=dict)
    scopes: Dict[str, Any] = field(default_factory=dict)
    tenant_qos: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ConfigRecord:
    """models/config.go row: a named operator key-value setting."""

    id: str
    name: str
    value: str = ""
    bio: str = ""


_KINDS = {
    "application": Application,
    "cluster": ClusterRecord,
    "config": ConfigRecord,
}

# Row ids appear in URLs, sqlite keys, and the console DOM — keep them
# boring.  (Client-supplied ids with quotes were an XSS vector through the
# console's inline handlers.)
_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

# The scheduling limits a cluster row may carry; values must be ints —
# a half-applied config on the scheduler side (int("oops") mid-loop) is
# worse than a rejected write, so validation lives on the WRITE path.
_CLUSTER_INT_KEYS = (
    "candidate_parent_limit",
    "filter_parent_limit",
    "retry_limit",
    "retry_back_to_source_limit",
    "load_limit",
)


def _validate_cluster_blobs(fields: Dict[str, Any]) -> None:
    for blob_key in ("scheduler_cluster_config", "client_config", "scopes"):
        blob = fields.get(blob_key)
        if blob is None:
            continue
        if not isinstance(blob, dict):
            raise ValueError(f"{blob_key} must be an object, got {type(blob).__name__}")
        for k in _CLUSTER_INT_KEYS:
            if k in blob and not isinstance(blob[k], int):
                raise ValueError(f"{blob_key}.{k} must be an integer")
    qos = fields.get("tenant_qos")
    if qos is not None:
        # Validation lives on the WRITE path (the scheduler/daemon side
        # skips malformed payloads silently — a rejected write is loud,
        # a half-applied policy is not).
        from ..qos.policy import parse_tenant_qos

        parse_tenant_qos(qos)


class CrudStore:
    """JSON-row store for the manager's CRUD resources."""

    def __init__(self, db_path: Optional[str] = None, *, backend=None) -> None:
        self._mu = threading.RLock()
        self._rows: Dict[str, Dict[str, dict]] = {k: {} for k in _KINDS}
        self._table = None
        if backend is None and db_path:
            from .state import SQLiteBackend

            backend = SQLiteBackend(db_path)
        if backend is not None:
            self._table = backend.table("crud")
            for key, row in self._table.load_all().items():
                kind, _, id_ = key.partition(":")
                if kind in self._rows:
                    self._rows[kind][id_] = row

    def _persist(self, kind: str, id_: str, row: Optional[dict]) -> None:
        if self._table is None:
            return
        if row is None:
            self._table.delete(f"{kind}:{id_}")
        else:
            self._table.put(f"{kind}:{id_}", row)

    # -- generic ops ---------------------------------------------------------

    def create(self, kind: str, **fields: Any):
        cls = _KINDS[kind]
        if kind == "cluster":
            _validate_cluster_blobs(fields)
        if kind == "config":
            # models/config.go declares name UNIQUE — a duplicate-named
            # setting would resolve ambiguously by consumer ordering.
            name = fields.get("name")
            if not name:
                raise ValueError("config name required")
            with self._mu:
                if any(
                    r.get("name") == name
                    for r in self._rows["config"].values()
                ):
                    raise ValueError(f"config {name!r} already exists")
        with self._mu:
            # str-coerce BEFORE storing: a JSON-integer id would otherwise
            # live under an int key the string-keyed REST routes miss.
            row_id = str(fields.pop("id", None) or uuid.uuid4().hex[:12])
            if not _ID_RE.match(row_id):
                raise ValueError(f"invalid {kind} id {row_id!r}")
            if row_id in self._rows[kind]:
                raise ValueError(f"{kind} {row_id!r} already exists")
            obj = cls(id=row_id, **fields)
            self._rows[kind][row_id] = asdict(obj)
            self._persist(kind, row_id, self._rows[kind][row_id])
            return obj

    def get(self, kind: str, row_id: str):
        cls = _KINDS[kind]
        with self._mu:
            row = self._rows[kind].get(row_id)
            return cls(**row) if row else None

    def list(self, kind: str) -> List[Any]:
        cls = _KINDS[kind]
        with self._mu:
            return [cls(**r) for r in self._rows[kind].values()]

    def update(self, kind: str, row_id: str, **fields: Any):
        cls = _KINDS[kind]
        if kind == "cluster":
            _validate_cluster_blobs(fields)
        with self._mu:
            row = self._rows[kind].get(row_id)
            if row is None:
                raise KeyError(f"{kind} {row_id!r} not found")
            # Declared fields, not the row's keys: a row persisted before
            # a schema gained a field (e.g. tenant_qos) must still accept
            # updates to it.
            import dataclasses as _dc

            allowed = {f.name for f in _dc.fields(cls)} - {"id"}
            for k, v in fields.items():
                if k not in allowed:
                    raise ValueError(f"unknown field {k!r} for {kind}")
                row[k] = v
            self._persist(kind, row_id, row)
            return cls(**row)

    def delete(self, kind: str, row_id: str) -> None:
        with self._mu:
            if self._rows[kind].pop(row_id, None) is None:
                raise KeyError(f"{kind} {row_id!r} not found")
            self._persist(kind, row_id, None)

    # -- cluster conveniences ------------------------------------------------

    def ensure_default_cluster(self) -> ClusterRecord:
        """The reference seeds a default scheduler cluster at migration
        time; dynconfig consumers need it to exist."""
        with self._mu:
            for row in self._rows["cluster"].values():
                if row.get("is_default"):
                    return ClusterRecord(**row)
            # An id="default" row whose is_default flag was cleared by an
            # update still satisfies the invariant — re-creating it would
            # raise "already exists" on every boot (a restart crash loop).
            row = self._rows["cluster"].get("default")
            if row is not None:
                return ClusterRecord(**row)
        return self.create(
            "cluster", id="default", name="default", is_default=True,
            scheduler_cluster_config={
                "candidate_parent_limit": 4,
                "filter_parent_limit": 15,
            },
            client_config={"load_limit": 50},
        )

    def cluster_config(self, cluster_id: str) -> Dict[str, Any]:
        """The dynconfig payload a scheduler polls
        (scheduling.go:404-410 limit consumption)."""
        cluster = self.get("cluster", cluster_id)
        if cluster is None:
            raise KeyError(f"cluster {cluster_id!r} not found")
        return {
            "cluster_id": cluster.id,
            "scheduler_cluster_config": dict(cluster.scheduler_cluster_config),
            "client_config": dict(cluster.client_config),
            "tenant_qos": dict(cluster.tenant_qos),
        }
