"""Durable lifecycle state: epoch watermarks, candidate lineage,

Port of ``dragonfly2_tpu/lifecycle/state.py``, verbatim.
promotion history (DF014 namespace ``lifecycle``).

One row per lifecycle key (``"global"`` or a region name):

    {"epoch": int, "watermark": int, "candidate_id": str,
     "candidate_version": int, "history": [event, ...]}

Rows ride the manager's StateBackend — on the replicated backend
(DESIGN.md §20) they follow the WAL to the standby, so a manager bounce
mid-promotion resumes the loop exactly where it was (the daemon reads the
watermark and in-flight candidate back instead of retraining from
scratch).  Every mutation is one ``put`` under ``_mu`` and the loader is
the constructor, per records/state_contracts.py.

``backend=None`` runs the store in-memory: rows behave identically
within the process (watermarks advance, lineage accumulates) but die
with it.  The trainer CLI wiring uses this mode — it has no
StateBackend of its own — so the epoch cadence contract holds even
without durability; only crash-resume needs the backend.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Dict, List, Optional

if TYPE_CHECKING:  # lock-graph resolver type (§16): _table nests under _mu
    from ..manager.state import StateBackend

# Bounded promotion-history tail kept per key: lineage for operators and
# drills, not an unbounded event log.
HISTORY_KEEP = 64


def _default_row() -> dict:
    return {
        "epoch": 0,
        "watermark": 0,
        "candidate_id": "",
        "candidate_version": 0,
        "history": [],
    }


class LifecycleStore:
    """Owner of the ``lifecycle`` namespace (records/state_contracts.py)."""

    def __init__(self, backend: Optional["StateBackend"] = None) -> None:
        self._mu = threading.Lock()
        self._rows: Dict[str, dict] = {}
        self._table = backend.table("lifecycle") if backend is not None else None
        if self._table is not None:
            for key, doc in self._table.load_all().items():
                row = _default_row()
                row.update(doc)
                self._rows[key] = row

    def keys(self) -> List[str]:
        with self._mu:
            return sorted(self._rows)

    def row(self, key: str) -> dict:
        with self._mu:
            row = self._rows.get(key)
            return dict(row) if row is not None else _default_row()

    def update(self, key: str, **fields) -> dict:
        with self._mu:
            row = dict(self._rows.get(key) or _default_row())
            row.update(fields)
            self._rows[key] = row
            if self._table is not None:
                self._table.put(key, row)
            return dict(row)

    def append_history(self, key: str, event: dict) -> dict:
        with self._mu:
            row = dict(self._rows.get(key) or _default_row())
            history = list(row.get("history") or [])
            history.append(dict(event))
            row["history"] = history[-HISTORY_KEEP:]
            self._rows[key] = row
            if self._table is not None:
                self._table.put(key, row)
            return dict(row)

    def candidate(self, key: str) -> Optional[str]:
        """In-flight candidate model id for this key, or None."""
        with self._mu:
            row = self._rows.get(key)
            return (row or {}).get("candidate_id") or None
