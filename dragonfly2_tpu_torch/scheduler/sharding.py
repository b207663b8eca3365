"""Sharded scheduler fleet: the two steering exceptions and the
manager's membership directory.

Port of ``WrongShardError``, ``ShardSaturatedError`` and
``ShardDirectory`` from ``dragonfly2_tpu/scheduler/sharding.py``,
verbatim.  The directory versions a cluster's ACTIVE scheduler set and
rides the cluster dynconfig payload (``scheduler_ring``) that the
manager's ``/api/v1/clusters/<id>:config`` serves.  The wire maps them
to HTTP 421 and 503 + Retry-After (``rpc/scheduler_server.py``) and the
client raises them back (``rpc/scheduler_client.py``), so the port's
wire speaks the reference's steering answers.  The ring, the shard guard
and admission control are not ported
(ROADMAP queue 1 item 14): no port scheduler raises either exception,
and the scheduler binary refuses a sharded configuration.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Dict, Sequence, Tuple

from . import metrics

if TYPE_CHECKING:  # state seam type (no runtime import needed)
    from ..manager.state import StateBackend

DEFAULT_REPLICAS = 100  # virtual nodes per shard


class WrongShardError(Exception):
    """REDIRECT-style steering answer: the task's swarm lives (or now
    lives) on another shard.  Carried over the wire as HTTP 421 with the
    owner's address so the client re-announces there instead of burning
    retries against a non-owner."""

    def __init__(
        self, task_id: str, *, owner_id: str = "", owner_url: str = "",
        ring_version: int = 0,
    ) -> None:
        super().__init__(
            f"task {task_id} is owned by shard {owner_id or '?'} "
            f"(ring v{ring_version})"
        )
        self.task_id = task_id
        self.owner_id = owner_id
        self.owner_url = owner_url
        self.ring_version = ring_version


class ShardSaturatedError(Exception):
    """Admission refusal: this shard is past its load bound and the
    request's priority class is in the shed band.  Carried over the wire
    as HTTP 503 + Retry-After (the §20 standby discipline): the client
    backs off instead of hammering a melting shard."""

    def __init__(self, *, retry_after_s: float = 1.0, reason: str = "") -> None:
        super().__init__(reason or "shard saturated")
        self.retry_after_s = retry_after_s
        self.reason = reason or "shard saturated"


class ShardDirectory:
    """Durable, versioned shard membership (manager side).

    The ACTIVE scheduler instances of a cluster form the ring; a set
    change (register, keepalive expiry, deregister) bumps the version
    and persists ``{version, members}`` through the StateBackend — on
    the replicated backend (§20) the row survives a leader bounce, so a
    promoted standby publishes the SAME ring version instead of
    restarting the fleet's ownership from zero.
    """

    NAMESPACE = "shard_membership"

    def __init__(
        self, backend: "StateBackend", *, replicas: int = DEFAULT_REPLICAS
    ) -> None:
        self._mu = threading.Lock()
        self.replicas = replicas
        self._table = backend.table("shard_membership")
        # Recovery loader (DF014): the persisted ring row is the boot
        # state; version continuity across restarts is what keeps the
        # fleet from re-handing-off every task on a manager bounce.
        self._rows: Dict[str, dict] = self._table.load_all()

    def _row(self, cluster_id: str) -> dict:
        return self._rows.get(cluster_id) or {"version": 0, "members": {}}

    def publish(
        self, cluster_id: str, active: Sequence[Tuple[str, str]]
    ) -> Dict[str, object]:
        """Reconcile the ACTIVE member set against the persisted row and
        return the ring payload for the cluster dynconfig.  Bumps +
        persists the version only when membership actually changed."""
        incoming = {sid: url for sid, url in active}
        with self._mu:
            row = self._row(cluster_id)
            if incoming != row["members"]:
                row = {
                    "version": int(row["version"]) + 1,
                    "members": incoming,
                }
                self._rows[cluster_id] = row
                self._table.put(cluster_id, row)
                metrics.SHARD_RING_VERSION.set(
                    row["version"], cluster=cluster_id
                )
            return {
                "version": row["version"],
                "replicas": self.replicas,
                "members": [
                    {"id": sid, "url": url}
                    for sid, url in sorted(row["members"].items())
                ],
            }

    def version(self, cluster_id: str) -> int:
        with self._mu:
            return int(self._row(cluster_id)["version"])
