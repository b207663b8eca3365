"""Dynconfig-fed scheduler resolver + multi-endpoint manager resolver
(reference: pkg/resolver — gRPC resolvers that watch dynconfig for the
live backend lists and feed the balancers, resolver/scheduler_resolver.go).

``SchedulerResolver`` observes a Dynconfig whose payload carries
``schedulers: [{id, url}]``, keeps the hash ring in sync, and answers
``pick(task_id) → url`` — the daemon's scheduler-selection seam.

``ManagerEndpoints`` is the manager-HA half: ONE sticky ordered list of
manager replica URLs shared by every manager-facing client in a process
(cluster keepalive, dynconfig polls, registry/rollout fetches, the job
queue, topology sync).  ``call`` tries the current endpoint and fails
over on connection errors and on 503 (a standby refusing writes), so a
leader bounce moves the whole process to the survivor mid-flight — and
because the list is shared, the FIRST client to fail over moves
everyone.

Port of ``dragonfly2_tpu/rpc/resolver.py``, verbatim.  ``ShardRouter``
dials a member through ``rpc/steering.default_scheduler_factory``
unless given a factory.
"""

from __future__ import annotations

import threading
import time
import urllib.error
from typing import Callable, Dict, List, Optional, Sequence, Tuple, TypeVar, Union

from .balancer import HashRing, StickyFailover

T = TypeVar("T")


class SchedulerResolver:
    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._ring = HashRing()
        self._urls: Dict[str, str] = {}

    # Dynconfig observer signature (manager/dynconfig.py register()).
    def on_config(self, config: dict) -> None:
        entries = config.get("schedulers", [])
        with self._mu:
            current = set(self._urls)
            # Skip malformed entries rather than raising — an observer
            # exception would take down the dynconfig refresh for everyone.
            incoming = {
                e["id"]: e["url"]
                for e in entries
                if isinstance(e, dict) and e.get("id") and e.get("url")
            }
            for gone in current - set(incoming):
                self._ring.remove(gone)
                del self._urls[gone]
            for sid, url in incoming.items():
                if sid not in self._urls:
                    self._ring.add(sid)
                self._urls[sid] = url

    def pick(self, task_id: str) -> Optional[str]:
        """Scheduler URL owning the task (consistent hashing keeps one
        task's swarm on one scheduler, pkg/balancer semantics)."""
        with self._mu:
            sid = self._ring.pick(task_id)
            return self._urls.get(sid) if sid else None

    def all_urls(self) -> List[str]:
        with self._mu:
            return sorted(self._urls.values())


class ShardRouter:
    """Dynconfig-fed sharded-scheduler router (DESIGN.md §24).

    Holds the manager-published ``scheduler_ring`` (version + members)
    and routes task-scoped calls to the owning shard with the bounded-
    load pick.  ``call`` is the steering-aware wrapper the daemon/sim
    uses:

    - a **wrong-shard** answer (HTTP 421 → ``WrongShardError``) means
      the ring moved under us: adopt the answer's owner hint and retry
      there — the server's hint is fresher than our last dynconfig poll;
    - a **saturated** answer (503 + Retry-After →
      ``ShardSaturatedError``) honors the server's pacing through a
      BOUNDED retry budget (``saturation_retries``, decorrelated-jitter
      spaced and capped by the server's Retry-After), then propagates —
      a briefly-saturated shard is a wait, not a hard failure; past the
      budget the CALLER owns the drop-or-degrade decision;
    - a **transport failure** demotes the member locally (the ring loses
      it until a dynconfig refresh re-publishes it) and retries on the
      task's next owner — the client half of task migration.

    Per-shard in-flight counts feed the bounded-load pick, so a shard
    answering slowly sheds new placements to its ring neighbors before
    its admission controller ever 503s.
    """

    def __init__(
        self,
        factory: Optional[Callable[[str], object]] = None,
        *,
        load_factor: float = 1.25,
        saturation_retries: int = 3,
        max_retry_wait_s: float = 2.0,
        backoff_rng=None,
    ) -> None:
        from ..scheduler.sharding import ShardRing

        self._mu = threading.Lock()
        self._ring = ShardRing()
        self._factory = factory
        self.load_factor = load_factor
        # Saturation retry budget: how many 503+Retry-After answers one
        # call absorbs before propagating, each wait the MIN of the
        # server's Retry-After and a decorrelated-jitter draw (seeded
        # rng => reproducible schedules in tests, decorrelated across a
        # fleet seeded differently).
        self.saturation_retries = max(0, int(saturation_retries))
        self.max_retry_wait_s = max_retry_wait_s
        self._backoff_rng = backoff_rng
        self._clients: Dict[str, object] = {}
        self._inflight: Dict[str, int] = {}

    # -- ring adoption (dynconfig observer) ----------------------------------

    def on_config(self, config: dict) -> None:
        payload = config.get("scheduler_ring")
        if not isinstance(payload, dict):
            return
        from ..scheduler.sharding import ShardRing

        try:
            ring = ShardRing.from_payload(payload)
        except (KeyError, TypeError, ValueError):
            return
        with self._mu:
            if ring.version > self._ring.version and len(ring):
                self._ring = ring

    def update_ring(self, ring) -> None:
        with self._mu:
            self._ring = ring

    @property
    def version(self) -> int:
        with self._mu:
            return self._ring.version

    def members(self) -> Dict[str, str]:
        with self._mu:
            return self._ring.members()

    # -- routing -------------------------------------------------------------

    def _load_of(self, sid: str) -> float:
        return float(self._inflight.get(sid, 0))

    def route(self, task_id: str) -> Tuple[str, str]:
        """(shard_id, url) owning ``task_id`` under the bounded-load
        pick; raises ``LookupError`` on an empty ring."""
        with self._mu:
            sid = self._ring.pick(
                task_id, load_of=self._load_of, load_factor=self.load_factor
            )
            if sid is None:
                raise LookupError("shard ring is empty")
            return sid, self._ring.url_of(sid) or ""

    def client_for(self, url: str):
        with self._mu:
            client = self._clients.get(url)
            if client is None:
                from .steering import default_scheduler_factory

                factory = self._factory or default_scheduler_factory
                client = self._clients[url] = factory(url)
            return client

    def _demote(self, sid: str) -> None:
        """Drop a member that failed at the transport level; the next
        dynconfig refresh re-publishes it if the manager still sees it."""
        with self._mu:
            self._ring.remove(sid)

    # -- steering-aware call -------------------------------------------------

    def call(self, task_id: str, fn: Callable[[object], T]) -> T:
        """Run ``fn(client)`` against the owning shard, following wrong-
        shard steering answers and transport-failure re-routes; absorbs
        up to ``saturation_retries`` Retry-After answers (jitter-spaced)
        before propagating the saturation."""
        from ..rpc.retry import DecorrelatedJitterBackoff
        from ..utils import faultinject
        from ..scheduler.sharding import ShardSaturatedError, WrongShardError

        waits = 0
        backoff = DecorrelatedJitterBackoff(
            base=0.01, cap=self.max_retry_wait_s, rng=self._backoff_rng
        )
        last: Optional[BaseException] = None
        # One attempt per member + one slot per steering hop and per
        # budgeted saturation retry: the walk terminates even when every
        # shard answers with an error.
        for _ in range(
            max(2, len(self.members()) + 1) + self.saturation_retries
        ):
            sid, url = self.route(task_id)
            # Chaos seam: route-time drop/delay exercises the same
            # failover path a dying shard does.
            faultinject.fire("shard.route")
            client = self.client_for(url)
            with self._mu:
                self._inflight[sid] = self._inflight.get(sid, 0) + 1
            try:
                return fn(client)
            except WrongShardError as exc:
                last = exc
                if exc.owner_url:
                    # Server-side hint: route THIS task at the hinted
                    # owner without waiting for the next dynconfig poll.
                    with self._mu:
                        self._ring.add(exc.owner_id or exc.owner_url,
                                       exc.owner_url)
                    try:
                        return fn(self.client_for(exc.owner_url))
                    except Exception as exc2:  # noqa: BLE001 — fall through
                        last = exc2
                        break
            except ShardSaturatedError as exc:
                last = exc
                if waits >= self.saturation_retries:
                    # Budget spent: the shard is saturated beyond a
                    # brief wait — the caller owns drop-or-degrade.
                    raise
                waits += 1
                # Honor the server's pacing (never knock sooner than
                # Retry-After), de-synchronized by the growing jitter
                # draw, clamped to the local budget — a shard asking for
                # minutes gets max_retry_wait_s, not a parked caller.
                time.sleep(
                    min(max(exc.retry_after_s, backoff.next()),
                        self.max_retry_wait_s)
                )
            except (ConnectionError, TimeoutError, OSError) as exc:
                last = exc
                self._demote(sid)
            finally:
                with self._mu:
                    self._inflight[sid] = max(
                        0, self._inflight.get(sid, 1) - 1
                    )
        assert last is not None
        raise last


class ManagerEndpoints:
    """Sticky multi-endpoint manager address book (see module doc).

    Accepts a comma-separated spec (``"http://a:80,http://b:80"``), a
    sequence of URLs, or another ``ManagerEndpoints`` (pass-through, so
    compositions can hand ONE shared instance to every client).
    """

    def __init__(self, spec: Union[str, Sequence[str]], *,
                 client: str = "manager") -> None:
        if isinstance(spec, str):
            urls = [u.strip() for u in spec.split(",") if u.strip()]
        else:
            urls = [str(u).rstrip("/") for u in spec if u]
        self._ring = StickyFailover([u.rstrip("/") for u in urls])
        self.client = client

    @classmethod
    def of(
        cls, spec: "Union[str, Sequence[str], ManagerEndpoints]", *,
        client: str = "manager",
    ) -> "ManagerEndpoints":
        if isinstance(spec, ManagerEndpoints):
            return spec
        return cls(spec, client=client)

    def current(self) -> str:
        return self._ring.current()

    def all(self) -> List[str]:
        return self._ring.all()

    def __len__(self) -> int:
        return len(self._ring)

    def failover(self, seen: str) -> str:
        """Rotate past a failed endpoint (idempotent under races) and
        account it on the failover counter."""
        from .metrics import MANAGER_ENDPOINT_FAILOVERS_TOTAL

        MANAGER_ENDPOINT_FAILOVERS_TOTAL.inc(client=self.client)
        return self._ring.advance(seen)

    # Failures that mean "try the next replica": transport errors, plus
    # HTTP 503 — a standby manager refusing writes until promotion.
    @staticmethod
    def _fails_over(exc: BaseException) -> bool:
        if isinstance(exc, urllib.error.HTTPError):
            return exc.code == 503
        return isinstance(exc, (ConnectionError, TimeoutError, OSError))

    def call(self, fn: Callable[[str], T]) -> T:
        """Run ``fn(base_url)`` against the current endpoint, failing
        over through the full list once; the endpoint that answers
        stays current for every sharer of this instance.  Re-raises the
        last error after a full fruitless cycle."""
        last: Optional[BaseException] = None
        url = self.current()
        for _ in range(len(self._ring)):
            try:
                return fn(url)
            except Exception as exc:  # noqa: BLE001 — classified below
                if not self._fails_over(exc):
                    raise
                last = exc
                url = self.failover(url)
        assert last is not None
        raise last
