"""Multi-scheduler steering client (reference: pkg/balancer's
consistent-hash gRPC picker + resolver/scheduler_resolver.go).

The reference daemon holds a scheduler LIST and its balancer hashes each
task id onto the ring so one task's whole swarm state lives on one
scheduler replica.  ``SteeringSchedulerClient`` is that picker as a
drop-in for the Conductor's single-scheduler client surface:

- task-scoped calls (register/report/leave/...) route to the replica
  owning ``peer.task.id`` on the ring — stable for the task's lifetime;
- host-scoped announces fan out to every replica (each keeps its own
  host inventory);
- probe sync (``sync_probes_*``) pins each HOST to one replica by host
  id — the probe graph still reaches the other replicas through the
  manager's shared-topology sync (scheduler/topology_sync.py), which is
  exactly the cross-replica property the deployment e2e asserts;
- ``resolve_host`` asks the task-agnostic replicas in ring order until
  one knows the host (parents may have announced anywhere).

Sharded-fleet awareness (DESIGN.md §24): schedulers re-publish the
manager's versioned shard ring on every announce answer.  The steering
client adopts the newest payload after each announce fan-out and, once
it has one, routes task-scoped calls by the PUBLISHED ring (scheduler
ids, sha placement — the same map the shards' guards enforce) instead
of the bootstrap url-hash ring; members it has no client for yet are
dialed through the factory on first use.  A ``WrongShardError``
steering answer (stale ring mid-membership-change) is followed to the
hinted owner once.

Port of ``dragonfly2_tpu/rpc/steering.py``, verbatim: a ``grpc://`` URL
dials ``grpc_transport.GRPCStreamingScheduler`` (imported only then),
every other URL the port's ``RemoteScheduler``.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional, Sequence

from ..scheduler.sharding import ShardRing, WrongShardError
from .balancer import HashRing

logger = logging.getLogger(__name__)


def default_scheduler_factory(url: str):
    """URL scheme → client: grpc://host:port or http(s)://..."""
    if url.startswith("grpc://"):
        from .grpc_transport import GRPCStreamingScheduler

        return GRPCStreamingScheduler(url[len("grpc://"):])
    from .scheduler_client import RemoteScheduler

    return RemoteScheduler(url)


class SteeringSchedulerClient:
    def __init__(
        self,
        urls: Sequence[str],
        *,
        factory: Optional[Callable] = None,
    ) -> None:
        if not urls:
            raise ValueError("SteeringSchedulerClient needs >= 1 scheduler url")
        factory = factory or default_scheduler_factory
        self._factory = factory
        self._mu = threading.Lock()
        self._clients: Dict[str, object] = {u: factory(u) for u in urls}
        self._ring = HashRing(list(urls))
        # Published shard ring (ids → urls), adopted from announce
        # answers; None until a sharded scheduler answers one.
        self._shard_ring: Optional[ShardRing] = None
        # Tenant identity stamped on every backend client (§26), and the
        # newest tenant_qos payload re-published on announce answers —
        # the daemon CLI adopts it into upload caps/shaper weights.
        self._tenant = ""
        self.tenant_qos: Optional[dict] = None

    # -- tenant identity ------------------------------------------------------

    @property
    def tenant(self) -> str:
        return self._tenant

    @tenant.setter
    def tenant(self, value: str) -> None:
        with self._mu:
            self._tenant = value or ""
            clients = list(self._clients.values())
        for c in clients:
            if hasattr(c, "tenant"):
                c.tenant = value or ""

    # -- routing -------------------------------------------------------------

    def _client_for(self, url: str):
        with self._mu:
            client = self._clients.get(url)
            if client is None:
                client = self._clients[url] = self._factory(url)
                if self._tenant and hasattr(client, "tenant"):
                    client.tenant = self._tenant
            return client

    def _adopt_ring(self, payload) -> None:
        if not isinstance(payload, dict) or not payload.get("members"):
            return
        try:
            ring = ShardRing.from_payload(payload)
        except (KeyError, TypeError, ValueError):
            return
        with self._mu:
            current = self._shard_ring
            if len(ring) and (current is None or ring.version > current.version):
                self._shard_ring = ring

    def ring_version(self) -> int:
        with self._mu:
            return self._shard_ring.version if self._shard_ring else 0

    def _owner(self, key: str):
        with self._mu:
            ring = self._shard_ring
        if ring is not None:
            url = ring.url_of(ring.owner(key))
            if url:
                return self._client_for(url)
        return self._clients[self._ring.pick(key)]

    def _task_call(self, task_id: str, fn):
        """Task-scoped call with steering: a wrong-shard answer (our
        ring lost a membership race) is followed to the hinted owner."""
        try:
            return fn(self._owner(task_id))
        except WrongShardError as exc:
            if not exc.owner_url:
                raise
            logger.debug(
                "task %s steered to %s (ring v%d)",
                task_id, exc.owner_id, exc.ring_version,
            )
            return fn(self._client_for(exc.owner_url))

    def for_task(self, task_id: str):
        """The replica owning this task (exposed for tests/debugging)."""
        return self._owner(task_id)

    def backends(self) -> List[str]:
        return sorted(self._clients)

    # -- host-scoped ---------------------------------------------------------

    def announce_host(self, host) -> None:
        # Per-replica isolation: one down replica must not starve the
        # healthy ones of announces (their host-TTL GC would evict this
        # daemon).  Raise only when EVERY replica failed.
        last_exc: Optional[Exception] = None
        ok = 0
        with self._mu:
            clients = list(self._clients.values())
        for c in clients:
            try:
                c.announce_host(host)
                ok += 1
                # Adopt the newest re-published shard ring (§24): the
                # announce fan-out doubles as the peer's ring poll.
                self._adopt_ring(getattr(c, "scheduler_ring", None))
                # Same discipline for the tenant QoS payload (§26).
                qos = getattr(c, "tenant_qos", None)
                if isinstance(qos, dict) and qos:
                    self.tenant_qos = qos
            except Exception as exc:  # noqa: BLE001 — replica outage
                last_exc = exc
        if ok == 0 and last_exc is not None:
            raise last_exc

    def leave_host(self, host) -> None:
        with self._mu:
            clients = list(self._clients.values())
        for c in clients:
            leave = getattr(c, "leave_host", None)
            if leave is None:
                continue
            try:
                leave(host)
            except Exception as exc:  # noqa: BLE001 — best-effort on shutdown
                logger.debug("leave_host on replica failed: %s", exc)

    def sync_probes_start(self, host):
        return self._owner(host.id).sync_probes_start(host)

    def sync_probes_finished(self, host, results) -> None:
        self._owner(host.id).sync_probes_finished(host, results)

    def resolve_host(self, host_id: str):
        last_exc: Optional[Exception] = None
        with self._mu:
            clients = list(self._clients.values())
        for c in clients:
            try:
                return c.resolve_host(host_id)
            except Exception as exc:  # noqa: BLE001 — try the next replica
                last_exc = exc
        raise last_exc if last_exc else KeyError(host_id)

    # -- task-scoped ---------------------------------------------------------

    def register_peer(self, *, host, url, task_id=None, **kw):
        if task_id is None:
            from ..utils import idgen

            task_id = idgen.task_id(url)
        return self._task_call(
            task_id,
            lambda c: c.register_peer(host=host, url=url, task_id=task_id, **kw),
        )

    def _peer_owner(self, peer):
        return self._owner(peer.task.id)

    def set_task_info(self, peer, *a, **kw):
        return self._task_call(
            peer.task.id, lambda c: c.set_task_info(peer, *a, **kw)
        )

    def report_piece_finished(self, peer, *a, **kw):
        return self._task_call(
            peer.task.id, lambda c: c.report_piece_finished(peer, *a, **kw)
        )

    def report_pieces_finished(self, peer, *a, **kw):
        return self._task_call(
            peer.task.id, lambda c: c.report_pieces_finished(peer, *a, **kw)
        )

    def report_piece_failed(self, peer, *a, **kw):
        return self._task_call(
            peer.task.id, lambda c: c.report_piece_failed(peer, *a, **kw)
        )

    def report_peer_finished(self, peer):
        return self._task_call(
            peer.task.id, lambda c: c.report_peer_finished(peer)
        )

    def report_peer_failed(self, peer):
        return self._task_call(
            peer.task.id, lambda c: c.report_peer_failed(peer)
        )

    def set_task_direct_piece(self, peer, data):
        return self._task_call(
            peer.task.id, lambda c: c.set_task_direct_piece(peer, data)
        )

    def mark_back_to_source(self, peer):
        return self._task_call(
            peer.task.id, lambda c: c.mark_back_to_source(peer)
        )

    def leave_peer(self, peer):
        return self._task_call(peer.task.id, lambda c: c.leave_peer(peer))

    def take_pushed_schedule(self, peer):
        """Server-push adoption: only streaming transports have it; a
        mixed ring degrades to None (no push) for the others."""
        take = getattr(self._peer_owner(peer), "take_pushed_schedule", None)
        return take(peer) if take is not None else None

    def close(self) -> None:
        with self._mu:
            clients = list(self._clients.values())
        for c in clients:
            close = getattr(c, "close", None)
            if close is not None:
                close()
