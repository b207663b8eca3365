"""The manager's durable-state seam.

Port of the in-memory half of ``dragonfly2_tpu/manager/state.py``.  Every
durable manager surface the learned-scheduling loop uses (the model
registry's rows, rollout rows, lifecycle rows, artifact blobs through
``KVBlobStore``) persists through one interface:

    StateBackend.table(namespace) -> KVTable (put/put_many/get/delete/
                                     load_all; put_many is atomic)

``MemoryBackend`` is the ephemeral implementation: a "restart" that
rebuilds the registry, controller and lifecycle store over the same
backend object reads back exactly the committed rows (the lifecycle
drill's bounce).  Documents are JSON round-tripped on every write and
read, so a row can never alias a caller's dict.  The SQLite backend and
the fault-injection seams wait for their own slices.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional


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
        range forms."""
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
        """Every namespace holding rows."""
        raise NotImplementedError

    def put_namespaces(self, staged: Dict[str, Dict[str, dict]]) -> None:
        """Commit rows across namespaces, one transaction per table."""
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
        with self._mu:
            self._rows[key] = json.loads(json.dumps(doc))  # force-serializable

    def put_many(self, items: Dict[str, dict]) -> None:
        with self._mu:
            for k, v in items.items():
                self._rows[k] = json.loads(json.dumps(v))

    def get(self, key: str) -> Optional[dict]:
        with self._mu:
            row = self._rows.get(key)
            return json.loads(json.dumps(row)) if row is not None else None

    def delete(self, key: str) -> None:
        with self._mu:
            self._rows.pop(key, None)

    def load_all(self) -> Dict[str, dict]:
        with self._mu:
            return json.loads(json.dumps(self._rows))

    def load_range(self, start_key: str) -> Dict[str, dict]:
        with self._mu:
            return {
                k: json.loads(json.dumps(v))
                for k, v in self._rows.items() if k > start_key
            }

    def delete_range(self, end_key: str) -> None:
        # Direct row mutation (not a self.delete loop): bulk log
        # compaction is backend maintenance, not a consumer write.
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
