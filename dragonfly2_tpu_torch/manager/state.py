"""The manager's durable-state seam (VERDICT r4 #5).

Reference: the manager spreads durable state across MySQL/Postgres +
Redis, each independently replaceable (manager/database/database.go:
50-59).  Here EVERY durable manager surface — model registry rows, CRUD
rows, users/PATs, the job broker, the shared topology cache — persists
through this one interface:

    StateBackend.table(namespace) -> KVTable (put/put_many/get/delete/
                                     load_all; put_many is atomic)

``SQLiteBackend`` is the embedded implementation (one file, one
physical table, WAL); ``MemoryBackend`` the ephemeral one.  An external
KV/SQL (the HA story) implements the same two classes — consumers never
see a connection, a dialect, or a file path.  ``make_state_backend``
maps a config string to a backend the way the reference's database.New
dispatches on its config (mysql/postgres).

Crash-safety contract consumers rely on (exercised by the
kill-the-manager-mid-preheat drill in tests/test_manager_recovery.py):
every committed ``put``/``put_many`` survives a SIGKILL; a torn write
never surfaces (sqlite journaling); ``load_all`` after restart returns
exactly the committed rows.

Port of ``dragonfly2_tpu/manager/state.py``, verbatim: one SQLite file
written by either package reads back in the other (one ``kv`` table of
JSON documents), and the ``state.{put,get,delete,load_all}.<namespace>``
fault seams fire at the reference's sites.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

from ..utils import faultinject


class KVTable:
    """One namespace of JSON documents keyed by string."""

    def put(self, key: str, doc: dict) -> None:
        raise NotImplementedError

    def put_many(self, items: Dict[str, dict]) -> None:
        """All rows in ONE transaction — multi-row invariants (e.g. the
        registry's single-active flip) must not tear across a crash."""
        raise NotImplementedError

    def get(self, key: str) -> Optional[dict]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def load_all(self) -> Dict[str, dict]:
        raise NotImplementedError

    def load_range(self, start_key: str) -> Dict[str, dict]:
        """Rows with key > ``start_key`` (lexicographic).  Base form
        filters ``load_all``; the concrete tables override with direct
        range forms — the replication log's per-poll tail read must not
        scan (and copy) the whole table forever (manager/replication.py)."""
        return {k: v for k, v in self.load_all().items() if k > start_key}

    def delete_range(self, end_key: str) -> None:
        """Delete rows with key < ``end_key`` (log compaction)."""
        for k in self.load_all():
            if k < end_key:
                self.delete(k)


class StateBackend:
    def table(self, namespace: str) -> KVTable:
        raise NotImplementedError

    def namespaces(self) -> List[str]:
        """Every namespace holding rows — the replication layer's
        snapshot enumeration (manager/replication.py)."""
        raise NotImplementedError

    def put_namespaces(self, staged: Dict[str, Dict[str, dict]]) -> None:
        """Commit rows across namespaces; the base form is per-table
        transactions, SQLite overrides with ONE transaction so a crash
        mid-migration leaves nothing (migrate_legacy_sqlite's contract)."""
        for ns, rows in staged.items():
            if rows:
                self.table(ns).put_many(rows)

    def close(self) -> None:  # pragma: no cover - trivial default
        pass


# ---------------------------------------------------------------------------
# In-memory (tests / embedded runs)
# ---------------------------------------------------------------------------


class _MemTable(KVTable):
    def __init__(self, ns: str = "") -> None:
        self._ns = ns
        self._rows: Dict[str, dict] = {}
        self._mu = threading.Lock()

    def put(self, key: str, doc: dict) -> None:
        faultinject.fire(f"state.put.{self._ns}")
        with self._mu:
            self._rows[key] = json.loads(json.dumps(doc))  # force-serializable

    def put_many(self, items: Dict[str, dict]) -> None:
        faultinject.fire(f"state.put.{self._ns}")
        with self._mu:
            for k, v in items.items():
                self._rows[k] = json.loads(json.dumps(v))

    def get(self, key: str) -> Optional[dict]:
        faultinject.fire(f"state.get.{self._ns}")
        with self._mu:
            row = self._rows.get(key)
            return json.loads(json.dumps(row)) if row is not None else None

    def delete(self, key: str) -> None:
        faultinject.fire(f"state.delete.{self._ns}")
        with self._mu:
            self._rows.pop(key, None)

    def load_all(self) -> Dict[str, dict]:
        faultinject.fire(f"state.load_all.{self._ns}")
        with self._mu:
            return json.loads(json.dumps(self._rows))

    def load_range(self, start_key: str) -> Dict[str, dict]:
        faultinject.fire(f"state.load_all.{self._ns}")
        with self._mu:
            return {
                k: json.loads(json.dumps(v))
                for k, v in self._rows.items() if k > start_key
            }

    def delete_range(self, end_key: str) -> None:
        # Direct row mutation (not a self.delete loop): bulk log
        # compaction is backend maintenance, not a consumer write — it
        # must not surface per-row in the crash-witness inventory.
        faultinject.fire(f"state.delete.{self._ns}")
        with self._mu:
            for k in [k for k in self._rows if k < end_key]:
                del self._rows[k]


class MemoryBackend(StateBackend):
    def __init__(self) -> None:
        self._tables: Dict[str, _MemTable] = {}
        self._mu = threading.Lock()

    def table(self, namespace: str) -> KVTable:
        with self._mu:
            if namespace not in self._tables:
                self._tables[namespace] = _MemTable(namespace)
            return self._tables[namespace]

    def namespaces(self) -> List[str]:
        with self._mu:
            return sorted(self._tables)


# ---------------------------------------------------------------------------
# SQLite (the embedded durable backend)
# ---------------------------------------------------------------------------


class _SQLiteTable(KVTable):
    def __init__(self, backend: "SQLiteBackend", ns: str) -> None:
        self._b = backend
        self._ns = ns

    def put(self, key: str, doc: dict) -> None:
        self.put_many({key: doc})

    def put_many(self, items: Dict[str, dict]) -> None:
        # Chaos seam BEFORE the transaction: an injected failure means
        # the commit never happened — the atomicity contract holds.
        faultinject.fire(f"state.put.{self._ns}")
        rows = [(self._ns, k, json.dumps(v)) for k, v in items.items()]
        with self._b._mu:
            self._b._conn.executemany(
                "INSERT OR REPLACE INTO kv (ns, key, value) VALUES (?,?,?)",
                rows,
            )
            self._b._conn.commit()

    def get(self, key: str) -> Optional[dict]:
        faultinject.fire(f"state.get.{self._ns}")
        with self._b._mu:
            row = self._b._conn.execute(
                "SELECT value FROM kv WHERE ns=? AND key=?", (self._ns, key)
            ).fetchone()
        return json.loads(row[0]) if row else None

    def delete(self, key: str) -> None:
        faultinject.fire(f"state.delete.{self._ns}")
        with self._b._mu:
            self._b._conn.execute(
                "DELETE FROM kv WHERE ns=? AND key=?", (self._ns, key)
            )
            self._b._conn.commit()

    def load_all(self) -> Dict[str, dict]:
        faultinject.fire(f"state.load_all.{self._ns}")
        with self._b._mu:
            rows = self._b._conn.execute(
                "SELECT key, value FROM kv WHERE ns=?", (self._ns,)
            ).fetchall()
        return {k: json.loads(v) for k, v in rows}

    def load_range(self, start_key: str) -> Dict[str, dict]:
        faultinject.fire(f"state.load_all.{self._ns}")
        with self._b._mu:
            rows = self._b._conn.execute(
                "SELECT key, value FROM kv WHERE ns=? AND key>?",
                (self._ns, start_key),
            ).fetchall()
        return {k: json.loads(v) for k, v in rows}

    def delete_range(self, end_key: str) -> None:
        faultinject.fire(f"state.delete.{self._ns}")
        with self._b._mu:
            self._b._conn.execute(
                "DELETE FROM kv WHERE ns=? AND key<?", (self._ns, end_key)
            )
            self._b._conn.commit()


class SQLiteBackend(StateBackend):
    """One file for ALL manager state: a restart (or a crash) reloads
    everything from the same place, and swapping the HA backend swaps
    everything at once rather than chasing five files."""

    def __init__(self, path: str, *, busy_timeout_ms: int = 5000) -> None:
        import sqlite3

        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._mu = threading.Lock()
        self._closed = False
        with self._mu:
            # WAL: a reader (console listing jobs) must not block the
            # write path, and fsync'd commits survive SIGKILL.
            self._conn.execute("PRAGMA journal_mode=WAL")
            # A second connection on the same file (a replication-role
            # sidecar, an ops shell) must wait out a writer's commit,
            # not throw "database is locked" into the manager hot path.
            self._conn.execute(f"PRAGMA busy_timeout={int(busy_timeout_ms)}")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv ("
                "ns TEXT NOT NULL, key TEXT NOT NULL, value TEXT NOT NULL, "
                "PRIMARY KEY (ns, key))"
            )
            self._conn.commit()

    def table(self, namespace: str) -> KVTable:
        return _SQLiteTable(self, namespace)

    def namespaces(self) -> List[str]:
        with self._mu:
            rows = self._conn.execute("SELECT DISTINCT ns FROM kv").fetchall()
        return sorted(r[0] for r in rows)

    def put_namespaces(self, staged: Dict[str, Dict[str, dict]]) -> None:
        """All namespaces' rows in ONE transaction: a crash mid-way
        commits nothing — a partial legacy migration must never pass
        the crash witness as a complete one."""
        for ns in staged:
            faultinject.fire(f"state.put.{ns}")
        rows = [
            (ns, k, json.dumps(v))
            for ns, docs in staged.items()
            for k, v in docs.items()
        ]
        with self._mu:
            self._conn.executemany(
                "INSERT OR REPLACE INTO kv (ns, key, value) VALUES (?,?,?)",
                rows,
            )
            self._conn.commit()

    def close(self) -> None:
        # Idempotent: the replication role shares one backend between
        # the REST composition and the follower; both shut it down.
        with self._mu:
            if self._closed:
                return
            self._closed = True
            self._conn.close()


def make_state_backend(spec: Optional[str]) -> StateBackend:
    """Config string → backend: None/'' or 'mem://' → MemoryBackend;
    anything else is a sqlite file path.  An external backend plugs in
    here (the reference's database.New dispatch, database.go:50-59)."""
    if not spec or spec == "mem://":
        return MemoryBackend()
    return SQLiteBackend(spec)


def migrate_legacy_sqlite(
    backend: StateBackend,
    *,
    models_db: Optional[str] = None,
    crud_db: Optional[str] = None,
    users_db: Optional[str] = None,
) -> Dict[str, int]:
    """One-time import of the pre-seam sqlite layouts (per-store files
    with typed tables) into the unified kv backend.  Runs at manager
    boot; a namespace that already has rows is never touched, so this is
    idempotent and a no-op on fresh or already-migrated deployments.
    Legacy files are left in place (read-only safety net).  Returns
    per-namespace imported-row counts.

    Every namespace's rows land in ONE transaction
    (``StateBackend.put_namespaces``; SQLite commits them atomically):
    a crash mid-migration must leave the backend looking unmigrated —
    the next boot re-imports — never half-imported, which would make the
    already-has-rows idempotency check skip the missing half forever."""
    import base64
    import sqlite3

    def rows(path: Optional[str], query: str):
        if not path or not os.path.exists(path):
            return []
        try:
            conn = sqlite3.connect(path)
            try:
                return conn.execute(query).fetchall()
            finally:
                conn.close()
        except sqlite3.Error:
            return []  # no such table / not a legacy layout

    staged: Dict[str, Dict[str, dict]] = {}

    if not backend.table("models").load_all():
        found = rows(
            models_db,
            "SELECT id,name,type,version,scheduler_id,state,evaluation,"
            "blob_key,created_at,updated_at FROM models",
        )
        if found:
            staged["models"] = {
                r[0]: {
                    "id": r[0], "name": r[1], "type": r[2], "version": r[3],
                    "scheduler_id": r[4], "state": r[5],
                    "evaluation": json.loads(r[6]), "blob_key": r[7],
                    "created_at": r[8], "updated_at": r[9],
                }
                for r in found
            }

    if not backend.table("crud").load_all():
        found = rows(crud_db, "SELECT kind,id,value FROM crud_rows")
        if found:
            staged["crud"] = {
                f"{kind}:{id_}": json.loads(value)
                for kind, id_, value in found
            }

    if not backend.table("users").load_all():
        found = rows(
            users_db,
            "SELECT id,name,email,role,state,password_hash,salt,created_at "
            "FROM users",
        )
        if found:
            staged["users"] = {
                r[0]: {
                    "id": r[0], "name": r[1], "email": r[2],
                    "role": int(r[3]), "state": r[4],
                    "password_hash": base64.b64encode(r[5]).decode(),
                    "salt": base64.b64encode(r[6]).decode(),
                    "created_at": r[7],
                }
                for r in found
            }

    if not backend.table("pats").load_all():
        found = rows(
            users_db,
            "SELECT id,user_id,name,role,token_hash,expires_at,revoked,"
            "created_at FROM pats",
        )
        if found:
            staged["pats"] = {
                r[0]: {
                    "id": r[0], "user_id": r[1], "name": r[2],
                    "role": int(r[3]), "token_hash": r[4],
                    "expires_at": r[5], "revoked": bool(r[6]),
                    "created_at": r[7],
                }
                for r in found
            }

    if staged:
        backend.put_namespaces(staged)
    return {ns: len(rows_) for ns, rows_ in staged.items()}
